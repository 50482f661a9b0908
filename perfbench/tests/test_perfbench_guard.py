"""What the benchmark may import: no module of JAX or of the JAX package
anywhere under ``perfbench/`` (top-level names compared whole, since the
port's name begins with the JAX package's), and nothing of the port in the
reference."""

import ast
import sys
from pathlib import Path

import pytest

from perfbench.common import BENCH_DIR, FORBIDDEN, jax_loaded

FILES = sorted(BENCH_DIR.rglob("*.py"))


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert "sast_tpu_torch" not in tops and not tops & set(FORBIDDEN), tops


def test_the_runtime_guard_compares_whole_names(monkeypatch):
    before = jax_loaded()
    monkeypatch.setitem(sys.modules, "sast_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike.sub", sys)
    assert jax_loaded() == before
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert jax_loaded() == sorted(set(before) | {"flax"})


def test_a_run_without_a_card_prints_nothing(capsys, monkeypatch):
    import torch

    from perfbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "gen4-base.serve.clustered", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
