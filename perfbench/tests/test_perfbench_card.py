"""On the card: one short run of each cell ends correct, with every metric
the cell's entry names (run with ``python -m pytest perfbench/tests -m
cuda`` on a machine with an H100)."""

import json
import subprocess
import sys

import pytest

from perfbench.common import ROOT, load_json

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                          "4000000007", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
