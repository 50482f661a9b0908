"""Streaming detection runtime: raw events in, detections out (port of
sast_tpu/serving.py).

Per frame, on the device: the stacked-histogram scatter-add of the packed
events, the bottom/right pad to the model resolution, the recurrent
backbone with carried LSTM state, PAFPN, head, decode and fixed-budget NMS.
The host ships one (S, E, 4) int32 upload per batch of frames and fetches
one fixed-size slate of detections with a validity mask. The recurrent
state stays on the device between frames; a per-lane ``reset`` mask zeroes
it inside the step.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from sast_tpu_torch.config import ExperimentConfig
from sast_tpu_torch.data.representations import stacked_histogram
from sast_tpu_torch.models.backbone import zero_states
from sast_tpu_torch.models.detector import (
    DTYPES,
    YoloXDetector,
    resolve_device,
    set_sparse_kernel,
)
from sast_tpu_torch.models.head import inference_outputs
from sast_tpu_torch.ops.nms import postprocess
from sast_tpu_torch.packing import pack_event_batch
from sast_tpu_torch.utils.padding import InputPadder, padding_token_mask


class StreamingDetector:
    """Online detector with on-device tensorization; 1..S parallel streams.

    Single stream:
        det = StreamingDetector(cfg, model, max_events=200_000)
        for frame_events in stream:               # dicts of x/y/p/t arrays
            out = det.process_events(**frame_events)
            # out: boxes (K,4) xyxy, scores (K,), classes (K,), valid (K,)

    Batched serving (``num_streams=S``): independent streams share one step;
    lanes flagged in ``reset`` start a new stream:
        outs = det.process_batch(frames, reset=[True, False, ...])

    ``model`` is a port ``YoloXDetector`` (``build_detector``, or one loaded
    with ``weights.load_jax_variables``); it is moved to ``device``. The
    device is CUDA unless the caller passes ``device="cpu"``, which runs the
    kernels' plain versions.

    ``sparse_kernel`` (the JAX runtime's ``use_pallas``, ``--sparse_kernel``
    on its validation CLI) decides the attention path as the JAX runtime
    does when it builds its model: True sends every attention layer through
    the window-skipping block kernel, False (the default) leaves the masked
    path, or the ``attention.fused_block`` / ``attention.gather_budget``
    path of the configuration. It is set on ``model``.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        model: YoloXDetector,
        max_events: int = 200_000,
        bins: int = 10,
        count_cutoff: int = 10,
        num_streams: int = 1,
        device="cuda",
        sparse_kernel: bool = False,
    ):
        self.device = resolve_device(device)
        bb = cfg.model.backbone
        if bb.input_channels != 2 * bins:
            raise ValueError(f"input_channels {bb.input_channels} != 2 * bins {bins}")
        self.cfg = cfg
        self.max_events = max_events
        self.num_streams = num_streams
        self.bins, self.count_cutoff = bins, count_cutoff
        self.native_hw = cfg.dataset.resolution_hw
        self.model = model.to(self.device).eval()
        set_sparse_kernel(self.model, sparse_kernel)
        self.dtype = DTYPES[cfg.model.compute_dtype]
        self.padder = InputPadder(bb.in_res_hw)
        self.token_mask = (
            padding_token_mask(self.native_hw, bb.in_res_hw, self.device)
            if bb.enable_masking
            else None
        )
        self.reset()

    def reset(self) -> None:
        """Zero the carried state of every lane (per-lane resets go through
        ``process_batch``'s ``reset`` mask)."""
        self.states = zero_states(
            self.cfg.model.backbone, self.num_streams, self.dtype, self.device
        )

    @torch.no_grad()
    def step(self, packed: torch.Tensor, n_events: torch.Tensor, reset: torch.Tensor):
        """One batch of frames on the device: (S, E, 4) int32 events, (S,)
        valid counts and (S,) bool resets -> (detections, selected-token
        telemetry). Updates the carried state."""
        S = self.num_streams
        lane = reset.view(S, 1, 1, 1)
        states = [
            tuple(torch.where(lane, torch.zeros((), dtype=s.dtype, device=s.device), s)
                  for s in hc)
            for hc in self.states
        ]
        h, w = self.native_hw
        rep = stacked_histogram(
            packed, n_events, self.bins, h, w, self.count_cutoff
        )  # (S, H, W, C) uint8
        ev = self.padder.pad_tensor_ev_repr(rep)
        feats, self.states, p_tel = self.model.forward_backbone(ev, states, self.token_mask)
        outputs = self.model.forward_detect(feats)
        pp = self.cfg.model.postprocess
        dets = postprocess(
            inference_outputs(outputs["preds"]),
            num_classes=self.cfg.model.head.num_classes,
            conf_threshold=pp.confidence_threshold,
            nms_threshold=pp.nms_threshold,
            pre_nms_topk=pp.pre_nms_topk,
            max_detections=pp.max_detections,
        )
        return dets, p_tel

    def process_batch(
        self,
        frames: List[Dict[str, np.ndarray]],
        reset: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """One frame window per lane -> batched detections.

        ``frames``: ``num_streams`` dicts of x/y/p/t arrays. ``reset``:
        optional (S,) bool — lanes starting a new stream this frame.
        Returns arrays with a leading lane axis, plus the per-stage
        ``selected_tokens`` telemetry (batch aggregate).
        """
        S = self.num_streams
        packed, n = pack_event_batch(frames, S, self.max_events)
        reset = np.zeros((S,), bool) if reset is None else np.asarray(reset, bool)
        dets, p_tel = self.step(
            torch.from_numpy(packed).to(self.device),
            torch.from_numpy(n).to(self.device),
            torch.from_numpy(reset).to(self.device),
        )
        out = {k: v.cpu().numpy() for k, v in dets.items()}
        return out | {"selected_tokens": p_tel.cpu().numpy()}

    def process_events(
        self, x: np.ndarray, y: np.ndarray, p: np.ndarray, t: np.ndarray
    ) -> Dict[str, np.ndarray]:
        """One frame window of raw (time-sorted) events -> detections
        (single-stream convenience over ``process_batch``)."""
        if self.num_streams != 1:
            raise ValueError("use process_batch with num_streams > 1")
        out = self.process_batch([dict(x=x, y=y, p=p, t=t)])
        tel = out.pop("selected_tokens")
        return {k: v[0] for k, v in out.items()} | {"selected_tokens": tel}
