"""The data-parallel world (port of sast_tpu/parallel/mesh.py).

The JAX package expresses data parallelism as a 1-D device mesh: one GSPMD
step over the global batch, where XLA inserts the gradient and metric
all-reduces and BatchNorm's moments become global reductions. The port runs
one process per card (``torchrun --nproc-per-node N``), each on its
``B / world`` lanes of the global batch, and makes those reductions
explicit: BatchNorm all-reduces its per-channel sums (``models/layers.py``),
the loss its normalisers (``models/losses.py``), the train step the
gradients and the metrics (``training/steps.py``). The sum of the ranks'
gradients is then the gradient of the global batch, as under GSPMD (and as
under the reference's DDP with sync-BN).

``maybe_initialize_distributed`` starts the process group from torchrun's
environment; ``make_mesh`` names the world for ``Trainer(mesh=...)``;
``allgather_host_objects`` gathers evaluation buffers. The JAX module's
TPU pod self-discovery (``TPU_WORKER_HOSTNAMES``) has no counterpart here:
a CUDA world is always described by torchrun's variables.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List

import torch
import torch.distributed as dist

# torchrun's variables; all of the first four, or none, must be set.
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of the data-parallel world (the default process
    group): its rank, the world size and its device."""

    rank: int
    size: int
    device: torch.device


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_shard_info() -> tuple:
    """(rank, world_size) for host-side data sharding; (0, 1) without a
    process group."""
    if _initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(device=None) -> Mesh:
    """The world of the started process group (``maybe_initialize_distributed``
    or the caller's ``init_process_group``), on ``device``: by default card
    ``LOCAL_RANK`` where CUDA is available, else the CPU."""
    if not _initialized():
        raise RuntimeError("make_mesh needs a started process group "
                           "(maybe_initialize_distributed or dist.init_process_group)")
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(dist.get_rank(), dist.get_world_size(), torch.device(device))


def maybe_initialize_distributed(device: str = "cuda") -> bool:
    """Start the default process group when launched as one process of a
    world (torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``): ``nccl`` for ``device="cuda"``,
    each rank bound to card ``LOCAL_RANK``, ``gloo`` for ``"cpu"``. Returns
    True if it started one. With none of the variables set it does nothing;
    with some but not all it raises, naming what is missing, rather than
    letting every worker wait in a rendezvous that cannot complete."""
    present = [k for k in _ENV if os.environ.get(k)]
    if not present:
        return False
    missing = [k for k in _ENV if not os.environ.get(k)]
    if missing:
        raise RuntimeError(
            f"{', '.join(present)} set but {', '.join(missing)} missing: a process of a "
            "world needs all of RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (torchrun sets them)")
    if _initialized():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kwargs)
    return True


def allgather_host_objects(obj: Any) -> List[Any]:
    """``[obj_rank0, obj_rank1, ...]``: any picklable host object from every
    process, in rank order (the reference's metric sync by
    ``dist.barrier`` + ``dist.reduce``, done over the whole buffers). One
    process, or no process group: ``[obj]``, with no communication."""
    if not _initialized() or dist.get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# Elements per all-reduce of the gradients: 64 MiB of fp32.
GRAD_BUCKET_NUMEL = 1 << 24


def reduce_gradients(params) -> None:
    """Sum every ``p.grad`` over the world in place: the gradients, in the
    order given (the same on every rank), are packed into flat buckets of at
    most ``GRAD_BUCKET_NUMEL`` elements of one dtype, each bucket
    all-reduced once and unpacked. The psum XLA inserts into a GSPMD step."""
    buckets, current, numel = [], [], 0
    for p in params:
        g = p.grad
        if current and (numel + g.numel() > GRAD_BUCKET_NUMEL or g.dtype != current[0].dtype):
            buckets.append(current)
            current, numel = [], 0
        current.append(g)
        numel += g.numel()
    if current:
        buckets.append(current)
    for grads in buckets:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
