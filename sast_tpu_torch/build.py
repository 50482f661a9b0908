"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` exports plain C entry points and becomes its
own shared library ``build/sast_tpu_torch/lib<name>-<digest>.so`` beside the
package, where ``<digest>`` hashes the sources and flags, so an edited source
is rebuilt and a stale library is never loaded. The libraries are built at
first use (``load``), or all at once with one ``nvcc`` process per source
started together (``build``). Each C entry returns ``cudaGetLastError()``
after its launch; the Python wrapper raises if that is not 0.

Run on a machine with the CUDA toolkit (``nvcc`` on ``PATH`` or under
``$CUDA_HOME/bin``, default ``/usr/local/cuda``) and an sm_90a card (H100).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "sast_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills into the build log
)
# Extra flags per source. The greedy keep mask must agree bit for bit with
# its plain version, so that source is built without FMA contraction.
KERNELS: Dict[str, tuple] = {
    "stem_conv": (),
    "density": (),
    "nms_keep": ("-fmad=false",),
    "sparse_fwd": (),
    "mlp_bwd": (),
    "attn_bwd": (),
    "cond": (),
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built on this machine"
    )


def _library(name: str) -> Path:
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + KERNELS[name]).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns the compiler's log
    of each library it built; raises if any build fails."""
    todo = [n for n in names if not _library(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = _library(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *KERNELS[name], "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


@functools.cache
def load(name: str, card: int = 0) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` for card ``card``, building it
    first if needed. Each card past the first loads a copy of its own (a file
    beside the library): the C entries keep static state, such as whether
    they have raised a kernel's shared-memory limit, that the CUDA runtime
    holds per device, so one process serving several cards needs one copy of
    that state per card."""
    build([name])
    path = _library(name)
    if card:
        copy = path.with_name(f"{path.stem}.card{card}{path.suffix}")
        if not copy.exists():
            tmp = copy.with_suffix(f".{os.getpid()}.tmp")
            shutil.copyfile(path, tmp)
            os.replace(tmp, copy)
        path = copy
    return ctypes.CDLL(str(path))


def on_its_card(launch):
    """Run ``launch`` (a wrapper's CUDA path, whose first argument is a CUDA
    tensor) with that tensor's card as the current device: a C entry
    launches in the current device's context."""
    import torch

    @functools.wraps(launch)
    def wrapper(t, *args, **kwargs):
        with torch.cuda.device(t.device):
            return launch(t, *args, **kwargs)

    return wrapper


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def check_device(t, what: str) -> None:
    """Raise unless ``t`` lies on the CPU (the plain version) or a card (the
    kernel): an operator has no other implementation but its shape-only one,
    which must not answer for a meta tensor outside a trace."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
