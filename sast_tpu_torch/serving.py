"""Streaming detection runtime: raw events in, detections out (port of
sast_tpu/serving.py).

Per frame, on the device: the stacked-histogram scatter-add of the packed
events, the bottom/right pad to the model resolution, the recurrent
backbone with carried LSTM state, PAFPN, head, decode and fixed-budget NMS.
The host ships one upload per batch of frames (one per device with
``mesh=``): the events field by field with no padding, which the step
unpacks into (S, E, 4) int32 first (``graphs.unpack_events``); it fetches one fixed-size slate of detections with a
validity mask. The recurrent state stays on the device between frames; a
per-lane ``reset`` mask zeroes it inside the step.

``StreamingStep`` is that step as a pure function of ``(states, packed,
n_events, reset)``, the counterpart of the JAX runtime's ``_step_fn``;
``export.export_streaming_detector`` traces it. ``CapturedStep`` runs it on
static buffers, the carried state written back in place, and on a card as
captured CUDA graphs (``graphs.py``): the counterpart of the JAX runtime's
``jax.jit(step, donate_argnums=(1,))``. The detector keeps one per device.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from sast_tpu_torch.config import ExperimentConfig
from sast_tpu_torch.data.representations import stacked_histogram
from sast_tpu_torch.graphs import Staging, load_packed, run_together, serving_step
from sast_tpu_torch.models.backbone import zero_states
from sast_tpu_torch.models.detector import (
    DTYPES,
    YoloXDetector,
    resolve_device,
    set_sparse_kernel,
)
from sast_tpu_torch.models.head import inference_outputs
from sast_tpu_torch.ops.nms import postprocess
from sast_tpu_torch.utils import timers
from sast_tpu_torch.utils.padding import InputPadder, padding_token_mask


class StreamingStep(nn.Module):
    """One batch of frames, as a pure function of its inputs: ``forward(
    states, packed, n_events, reset) -> (dets, new_states, p_tel)``.

    ``states``: per stage (hidden, cell), lanes on axis 0; ``packed``: (S, E,
    4) int32 events ``[x, y, p, t]``; ``n_events``: (S,) int32 valid counts;
    ``reset``: (S,) bool, lanes whose state is zeroed before the backbone.
    Returns the slate dict of ``ops/nms.postprocess``, the new states and the
    (num_stages,) selected-token telemetry (the batch aggregate). The model
    is a submodule, so its weights are this module's (and an export's)."""

    def __init__(self, cfg: ExperimentConfig, model: YoloXDetector, bins: int,
                 count_cutoff: int, device: torch.device):
        super().__init__()
        bb = cfg.model.backbone
        self.model = model
        self.bins, self.count_cutoff = bins, count_cutoff
        self.native_hw = tuple(cfg.dataset.resolution_hw)
        self.num_classes = cfg.model.head.num_classes
        self.pp = cfg.model.postprocess
        self.padder = InputPadder(bb.in_res_hw)
        self.register_buffer(
            "token_mask",
            padding_token_mask(self.native_hw, bb.in_res_hw, device) if bb.enable_masking
            else None,
            persistent=False,
        )

    def forward(self, states, packed: torch.Tensor, n_events: torch.Tensor,
                reset: torch.Tensor):
        lane = reset.view(-1, 1, 1, 1)
        states = [
            tuple(torch.where(lane, torch.zeros((), dtype=s.dtype, device=s.device), s)
                  for s in hc)
            for hc in states
        ]
        h, w = self.native_hw
        rep = stacked_histogram(
            packed, n_events, self.bins, h, w, self.count_cutoff
        )  # (S, H, W, C) uint8
        ev = self.padder.pad_tensor_ev_repr(rep)
        feats, new_states, p_tel = self.model.forward_backbone(ev, states, self.token_mask)
        outputs = self.model.forward_detect(feats)
        pp = self.pp
        dets = postprocess(
            inference_outputs(outputs["preds"]),
            num_classes=self.num_classes,
            conf_threshold=pp.confidence_threshold,
            nms_threshold=pp.nms_threshold,
            pre_nms_topk=pp.pre_nms_topk,
            max_detections=pp.max_detections,
        )
        return dets, new_states, p_tel


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

    ``graph`` (default on): on a card each device's step is captured as
    CUDA graphs at its first batch and replayed from then on
    (``CapturedStep``), with the carried state in place and the weights
    read through their compute-dtype copies; ``graph=False`` runs the same
    step eagerly, one op at a time. On the CPU the step runs eagerly
    whatever ``graph`` says. Weights written after the capture (in place,
    as ``load_state_dict`` and ``weights.load_jax_variables`` write them)
    are seen by the next step; moved ones are captured again.

    ``mesh``: a sequence of devices (JAX's ``mesh=``), or None. The lanes
    are split over them in contiguous blocks, in order (``num_streams`` must
    tile the mesh, else ``ValueError``); each device holds its own replica
    of the model, copied once here, and its lanes' carried state, and
    captures its step on its own card. A batch is one upload per device;
    every device's step is launched before any result is fetched, so the
    cards' work overlaps: a replay is one graph launch, also where layers
    choose their branch (a gather budget below 1, the sparse kernel's
    threshold below 1), which the card takes in a conditional node. Eagerly
    one thread dispatches the
    replicas one after another, so a host-paced step gains little from a
    second card. The slates come back concatenated in lane order, and
    ``selected_tokens`` is the mean over the devices of their batch
    aggregates, which is the aggregate of all lanes. ``device`` is then
    ignored.

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
        mesh: Optional[Sequence] = None,
        graph: bool = True,
    ):
        bb = cfg.model.backbone
        if bb.input_channels != 2 * bins:
            raise ValueError(f"input_channels {bb.input_channels} != 2 * bins {bins}")
        devices = [resolve_device(d) for d in (mesh if mesh is not None else [device])]
        if not devices or num_streams % len(devices):
            raise ValueError(
                f"num_streams={num_streams} must tile the {len(devices)}-device mesh"
            )
        self.cfg = cfg
        self.max_events = max_events
        self.num_streams = num_streams
        self.mesh = None if mesh is None else tuple(devices)
        self.devices, self.device = devices, devices[0]
        self.dtype = DTYPES[cfg.model.compute_dtype]
        set_sparse_kernel(model, sparse_kernel)
        models = [model] + [copy.deepcopy(model) for _ in devices[1:]]
        self.replicas = [
            StreamingStep(cfg, m.to(d).eval(), bins, count_cutoff, d)
            for m, d in zip(models, devices)
        ]
        self.model = model
        self.lanes_per_replica = num_streams // len(devices)
        self.steps = [
            serving_step(r, zero_states(bb, self.lanes_per_replica, self.dtype, d),
                         self.lanes_per_replica, max_events, d, graph, weights=(r,))
            for r, d in zip(self.replicas, devices)
        ]
        self._staging = Staging(num_streams, max_events,
                                 pinned=any(d.type == "cuda" for d in devices))

    def reset(self) -> None:
        """Zero the carried state of every lane, in place (per-lane resets
        go through ``process_batch``'s ``reset`` mask)."""
        for step in self.steps:
            step.zero_states()

    @property
    def states(self):
        """The carried state of every lane (a list per stage of (hidden,
        cell)); with a mesh, one such list per device. These are the step's
        own buffers, rewritten in place by every step."""
        states = [step.states for step in self.steps]
        return states[0] if self.mesh is None else states

    def _lanes(self, i: int) -> slice:
        return slice(i * self.lanes_per_replica, (i + 1) * self.lanes_per_replica)

    def _run(self):
        """Launch every replica's step on its static inputs before any
        result is read (``graphs.run_together``); returns the per-replica
        (dets, p_tel)."""
        return run_together([step.run for step in self.steps])

    @torch.no_grad()
    def step(self, packed: torch.Tensor, n_events: torch.Tensor, reset: torch.Tensor):
        """One batch of frames on the device: (S, E, 4) int32 events, (S,)
        valid counts and (S,) bool resets -> (detections, selected-token
        telemetry), tensors of their own (the next step does not overwrite
        them). Updates the carried state. The events are copied into the
        step's static inputs field by field, each lane in place
        (``graphs.load_packed``); with a mesh each device's lanes are sliced
        out and copied to its step, and the results come back to the first
        device."""
        for i, step in enumerate(self.steps):
            lanes = self._lanes(i)
            load_packed(step, packed[lanes], n_events[lanes], reset[lanes])
        outs = self._run()
        if self.mesh is None:
            ((dets, p_tel),) = outs
            return {k: v.clone() for k, v in dets.items()}, p_tel.clone()
        dets = {k: torch.cat([d[k].to(self.device) for d, _ in outs]) for k in outs[0][0]}
        p_tel = torch.stack([p.to(self.device) for _, p in outs]).mean(dim=0)
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

        On a card the events are packed field by field, with no padding,
        into page-locked buffers (``packing.pack_event_fields``), each
        device's events, counts and resets are copied up asynchronously,
        every device's step is launched (it unpacks the events first), and the slates come back through page-locked buffers with
        one wait. The call is the span ``serve.batch`` (``utils/timers``),
        around ``graphs.Staging.batch``'s spans and counters.
        """
        with timers.span("serve.batch"):
            host = self._staging.batch(frames, reset, self.steps, self._run)
            out = {k: np.concatenate([d[k].numpy() for d, _ in host]) for k in host[0][0]}
            tel = (host[0][1].numpy().copy() if len(host) == 1 else
                   np.mean(np.stack([p.numpy() for _, p in host]), axis=0, dtype=np.float32))
        return out | {"selected_tokens": tel}

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
