"""Whether an RVT serve cell's window served right: ``check_serve.py``'s
check with the RVT reference (``reference/rvt.py``) in the SAST
reference's place.

The plan, the copies of the carried state around the checked batches, the
readings (``state_gap``, ``slate_miss``) and the matching of the slates
(``check_serve.unmatched``, boxes taken at least one pixel wide and high)
are ``check_serve.py``'s own code: this module loads ``check_serve.py``
and ``control.py`` afresh as modules of their own whose reference is
``reference/detector.py`` with RVT's ``param_shapes`` and ``serve_frame``,
so that a change to the SAST check is the RVT check's too.

    python3 perfbench/check_serve_rvt.py --workload <name> --seeds <n> [<n> ...] [--precision fp8]

runs the check's control for an RVT cell (``control.py``'s, with the RVT
reference in precision ``precision`` in the program's place, serving the
checked lanes through every batch up to the last checked one and carrying
its own state); one JSON line per seed. The benchmark's runs never run it.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.common import BENCH_DIR, load_module  # noqa: E402
from perfbench.reference import detector as R  # noqa: E402
from perfbench.reference import rvt  # noqa: E402

# ``reference/detector.py`` as the check and the control read it, with the
# RVT model's parameters and frame.
REFERENCE = types.SimpleNamespace(**{**vars(R), "param_shapes": rvt.param_shapes,
                                     "serve_frame": rvt.serve_frame})


def _with_rvt(name: str) -> types.ModuleType:
    """``perfbench/<name>.py`` loaded afresh, its reference RVT's."""
    mod = load_module(BENCH_DIR / f"{name}.py")
    mod.R = REFERENCE
    return mod


_check = _with_rvt("check_serve")
_control = _with_rvt("control")
_control.check_serve = _check

Plan, Seen, pack, unmatched = _check.Plan, _check.Seen, _check.pack, _check.unmatched
control = _control.serve_control
main = _control.main

if __name__ == "__main__":
    sys.exit(main())
