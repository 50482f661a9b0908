"""Guards of the PyTorch/CUDA port that need neither JAX nor a card."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# The JAX stack, the JAX package, its CLIs, and matplotlib (which the
# card's stated installs lack).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sast_tpu", "train", "validation",
             "matplotlib")
# Third-party modules allowed only inside a function, and only in the files
# named: the HDF5 dataset reader and the preprocessing CLI, which writes it.
LAZY_ONLY = {mod: ("sast_tpu_torch/data/sequence.py", "scripts/preprocess_dataset_torch.py")
             for mod in ("h5py", "hdf5plugin")}


def _port_sources():
    return sorted((ROOT / "sast_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "train_torch.py", ROOT / "validation_torch.py",
        ROOT / "bench_torch.py", ROOT / "scripts" / "export_model_torch.py",
        ROOT / "scripts" / "benchmark_torch.py", ROOT / "scripts" / "preprocess_dataset_torch.py",
    ] + sorted((ROOT / "scripts").glob("torch_*.py"))


def _imports(path: Path):
    """(line, module, inside a function) of every absolute import."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield child.lineno, alias.name, in_function
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.lineno, child.module, in_function
            yield from walk(child, in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    yield from walk(tree, False)


def _imported_modules(path: Path):
    for line, mod, _ in _imports(path):
        yield line, mod


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_jax_package(path):
    """The port keeps its own copies: no module of it, and not the chip
    smoke script, imports jax, flax, optax, orbax or sast_tpu / sast_tpu.*."""
    bad = [
        (line, mod)
        for line, mod in _imported_modules(path)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path}: forbidden imports {bad}"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_h5py_is_imported_only_inside_the_sequence_reader(path):
    """``h5py`` (and the optional ``hdf5plugin``) only inside a function of
    ``data/sequence.py`` or of the preprocessing CLI: everything else of the
    port, and those files themselves, import where ``h5py`` is absent."""
    rel = str(path.relative_to(ROOT))
    bad = [(line, mod) for line, mod, in_function in _imports(path)
           if mod.split(".")[0] in LAZY_ONLY
           and not (in_function and rel in LAZY_ONLY[mod.split(".")[0]])]
    assert not bad, f"{path}: {bad}"


def test_guard_covers_the_training_modules():
    """The training and dataset slices' modules and the CLIs are among the
    guarded sources."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for mod in ("models/losses.py", "training/optimizer.py", "training/steps.py",
                "training/loop.py", "data/synthetic.py", "data/batch.py", "utils/logging.py",
                "data/sequence.py", "data/module.py", "data/streaming.py", "data/augment.py",
                "data/labels.py", "eval/coco.py", "eval/prophesee.py", "checkpoint/io.py",
                "checkpoint/torch_convert.py", "registry.py", "parallel/mesh.py",
                "data/device_cache.py"):
        assert f"sast_tpu_torch/{mod}" in names
    assert {"train_torch.py", "validation_torch.py", "chip_smoke.py"} <= names
    assert any(mod == "h5py" and inside for _, mod, inside in
               _imports(ROOT / "sast_tpu_torch" / "data" / "sequence.py"))


def test_guard_covers_the_serving_deployment():
    """The export module, the export CLI and the port's other scripts are
    among the guarded sources."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"sast_tpu_torch/export.py", "sast_tpu_torch/serving.py",
            "scripts/export_model_torch.py", "scripts/torch_kernel_turns.py",
            "scripts/torch_dp_spread.py"} <= names


def test_guard_covers_the_measurement_slice():
    """The benchmark library, the timers, the figures, the raw readers and
    the three CLIs of the measurement slice are among the guarded sources;
    the preprocessing CLI imports ``h5py`` inside a function."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"sast_tpu_torch/utils/benchmark.py", "sast_tpu_torch/utils/timers.py",
            "sast_tpu_torch/utils/viz.py", "sast_tpu_torch/data/psee_raw.py",
            "sast_tpu_torch/data/representations.py", "bench_torch.py",
            "scripts/benchmark_torch.py", "scripts/preprocess_dataset_torch.py"} <= names
    assert any(mod == "h5py" and inside for _, mod, inside in
               _imports(ROOT / "scripts" / "preprocess_dataset_torch.py"))


def test_export_module_imports_no_model_code_at_module_level():
    """``sast_tpu_torch/export.py`` loads an artifact with torch, numpy, the
    packing and the operators alone: at module level it imports nothing of
    ``sast_tpu_torch.models``, ``training`` or ``data`` (the export function
    imports the model stack inside itself)."""
    imports = list(_imports(ROOT / "sast_tpu_torch" / "export.py"))
    heavy = ("sast_tpu_torch.models", "sast_tpu_torch.training", "sast_tpu_torch.data",
             "sast_tpu_torch.serving")
    bad = [(line, mod) for line, mod, inside in imports if mod.startswith(heavy) and not inside]
    assert not bad, bad
    assert {mod for _, mod, inside in imports if not inside} >= {
        "sast_tpu_torch.ops.stem_conv", "sast_tpu_torch.ops.density",
        "sast_tpu_torch.ops.nms_keep", "sast_tpu_torch.ops.sparse_block",
        "sast_tpu_torch.ops.fused_block",
        "sast_tpu_torch.packing"}


def test_cli_refuses_only_the_weights_and_biases_options():
    """``train_torch.py`` refuses by name only what has no counterpart in
    the port: the Weights & Biases options."""
    import train_torch

    assert set(train_torch._REFUSED) == {"wandb", "wandb_runpath", "resume_wandb_artifact"}


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build raises instead of falling back."""
    from sast_tpu_torch import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["density"])
