"""Guards of the PyTorch/CUDA port that need neither JAX nor a card."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sast_tpu")


def _port_sources():
    return sorted((ROOT / "sast_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module


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


def test_guard_covers_the_training_modules():
    """The training slice's modules are among the guarded sources."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for mod in ("models/losses.py", "training/optimizer.py", "training/steps.py",
                "training/loop.py", "data/synthetic.py", "data/batch.py", "utils/logging.py"):
        assert f"sast_tpu_torch/{mod}" in names


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build raises instead of falling back."""
    from sast_tpu_torch import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["density"])
