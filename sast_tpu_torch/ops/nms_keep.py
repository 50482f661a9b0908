"""Greedy NMS keep mask: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``greedy_keep`` (sast_tpu/ops/pallas/nms_keep.py,
``_keep_kernel``) and the scan it stands for (``_greedy_keep_scan``,
sast_tpu/ops/nms.py). The kernel is ``csrc/nms_keep.cu``; its note says
what bounds it on the H100 (the latency of K dependent steps) and how it is
laid out. Kernel, plain version and JAX scan agree bit for bit: the same
max/min/clip intersection, the same ``inter / (area_i + area_j - inter +
1e-12) > thr`` test in fp32 with every operation rounded on its own, the
same ``score > 0`` validity.

``greedy_keep`` calls the operator ``sast_tpu_torch::greedy_keep``, which
dispatches on the tensor's device: a CPU tensor goes to
``greedy_keep_plain``, a CUDA tensor launches the kernel or raises; under
``torch.export`` the operator stands in the graph by its shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sast_tpu_torch import build

MAX_K = 4096  # 64 mask words per row: two per lane of the scan's warp


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(N, K, 4) xyxy -> (N, K, K) pairwise IoU, ``iou[n, i, j]``."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    iw = (
        torch.minimum(x2[:, :, None], x2[:, None, :])
        - torch.maximum(x1[:, :, None], x1[:, None, :])
    ).clamp_min(0.0)
    ih = (
        torch.minimum(y2[:, :, None], y2[:, None, :])
        - torch.maximum(y1[:, :, None], y1[:, None, :])
    ).clamp_min(0.0)
    inter = iw * ih
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    return inter / (area[:, :, None] + area[:, None, :] - inter + 1e-12)


def greedy_keep_plain(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Plain PyTorch version of ``greedy_keep`` (any device): the JAX
    package's scan, batched over images, one Python step per candidate."""
    N, K, _ = boxes.shape
    ar = torch.arange(K, device=boxes.device)
    # sup_by[n, i, j]: j is earlier than i and overlaps it above thr.
    sup_by = (iou_matrix(boxes.float()) > iou_threshold) & (ar[:, None] > ar[None, :])
    valid = scores > 0
    keep = torch.zeros((N, K), dtype=torch.bool, device=boxes.device)
    for i in range(K):
        suppressed = (keep & sup_by[:, i]).any(dim=-1)
        keep[:, i] = ~suppressed & valid[:, i]
    return keep


@functools.cache
def _kernel(card: int):
    lib = build.load("nms_keep", card)
    fn = lib.sast_greedy_keep
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    size = lib.sast_greedy_keep_workspace
    size.argtypes, size.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    return fn, size


def greedy_keep(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Batched greedy keep mask, through the operator
    ``sast_tpu_torch::greedy_keep``.

    Args:
      boxes: (N, K, 4) fp32 xyxy, sorted by descending score per row
        (already class-offset for class-aware NMS).
      scores: (N, K) fp32, same order; entries <= 0 are never kept.
      iou_threshold: suppression threshold.

    Returns (N, K) bool, True where the candidate survives.
    """
    build.check_device(boxes, "greedy_keep")
    N, K, _ = boxes.shape
    if boxes.device.type == "cuda" and (K > MAX_K or N > 65535):
        raise ValueError(f"greedy keep kernel takes K <= {MAX_K} and N <= 65535, got {N}, {K}")
    return torch.ops.sast_tpu_torch.greedy_keep(
        boxes.float().contiguous(), scores.float().contiguous(), float(iou_threshold))


# The operator: the kernel on CUDA tensors, the plain version on CPU
# tensors, the shape alone under a trace.
@torch.library.custom_op("sast_tpu_torch::greedy_keep", mutates_args=(), device_types="cuda",
                         schema="(Tensor boxes, Tensor scores, float iou_threshold) -> Tensor")
@build.on_its_card
def _greedy_keep_op(boxes, scores, iou_threshold):
    N, K, _ = boxes.shape
    if boxes.data_ptr() % 16:
        raise ValueError("greedy keep kernel needs 16-byte aligned boxes")
    keep = torch.empty((N, K), dtype=torch.bool, device=boxes.device)
    if N == 0 or K == 0:
        return keep
    fn, size = _kernel(boxes.device.index)
    n_work = size(N, K)
    mask = torch.empty(n_work, dtype=torch.uint8, device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    build.check(
        fn(
            boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), mask.data_ptr(), n_work,
            N, K, float(iou_threshold), stream,
        ),
        "greedy keep kernel",
    )
    greedy_keep.launches += 1
    return keep


_greedy_keep_op.register_kernel("cpu")(greedy_keep_plain)


@_greedy_keep_op.register_fake
def _greedy_keep_fake(boxes, scores, iou_threshold):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


greedy_keep.launches = 0  # kernel launches, read by chip_smoke.py
