"""RVT serve cells: ``serve.py``'s closed loop of
``StreamingDetector.process_batch`` calls, with the RVT reference's
parameter shapes (``reference/rvt.py``) for the weights and its check
(``check_serve_rvt.py``).

The loop is ``serve.py`` itself, loaded here as a module of its own whose
reference names are bound to RVT's, so that the two loops stay one. The
program's configuration is held, beside the sizes ``program.py`` checks,
to the configuration file's ``backbone``.
"""

from __future__ import annotations

from typing import Dict

from perfbench import check_serve_rvt, program
from perfbench.common import BENCH_DIR, Refused, load_module
from perfbench.reference import rvt


def program_config(cell):
    """``program.program_config``, and the port's backbone as the
    configuration file states it."""
    cfg = program.program_config(cell)
    name = cfg.model.backbone.name
    if name != cell.config["backbone"]:
        raise Refused(f"the port's configuration differs from {cell.entry['config']}: "
                      f"backbone {name}, the file's {cell.config['backbone']}")
    return cfg


def run(cell, args, clock, device) -> Dict:
    serve = load_module(BENCH_DIR / "loops" / "serve.py")
    serve.param_shapes = rvt.param_shapes
    serve.check_serve = check_serve_rvt
    serve.program_config = program_config
    return serve.run(cell, args, clock, device)
