"""Train / eval / streaming-inference step factories (port of
sast_tpu/training/steps.py).

- The scan over the clip is a Python loop over T with the LSTM states as the
  carry. ``remat_policy`` picks what each timestep keeps for the backward:
  ``"full"`` wraps the timestep in ``torch.utils.checkpoint`` (only its
  inputs are kept; the forward runs again in the backward, kernels
  included), ``"none"`` keeps everything, ``"dots"`` keeps the outputs of
  matrix products and convolutions (selective checkpointing).
- Labeled frames are gathered lane-locally: the host provides
  ``frame_tidx (B, L)`` and ``frame_valid (B, L)``, L a fixed budget.
- Truncated BPTT: the returned LSTM states are detached.
- Per-lane state reset through the ``is_first`` mask.
- Stochastic regularizers (any rate above 0): the masks of timestep ``t``
  come from ``DropoutKey(seed, optimizer step, t, rank, world)``, drawn
  inside the checkpointed timestep, so the recomputation draws them again
  (JAX folds the step into ``PRNGKey(seed)`` and splits a key per timestep).
- Data parallelism (``mesh``, a world of processes each on its ``B / world``
  lanes): BatchNorm and the loss take global statistics, the gradients are
  summed over the ranks in flat buckets before the norms, the clipping and
  AdamW, and the metrics are reduced to the global batch's, as the psums
  XLA inserts into the JAX package's GSPMD step.

Batch layout (``data/synthetic.py`` makes such batches):
  ev_repr      (T, B, H, W*C) uint8, W and C merged; split and padded per step
  frame_tidx   (B, L) integer  time index of each selected labeled frame
  frame_valid  (B, L) bool
  gt_boxes     (B, L, G, 4) float32 cxcywh (input pixels)
  gt_classes   (B, L, G) integer
  gt_valid     (B, L, G) bool
  is_first     (B,) bool

Unlike the JAX package's pure functions, ``train_step`` updates the model's
parameters, BatchNorm statistics, optimizer and EMA copy in place and hands
back the same ``TrainState``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from sast_tpu_torch.config import ExperimentConfig
from sast_tpu_torch.models.backbone import LstmState
from sast_tpu_torch.models.detector import YoloXDetector, build_detector
from sast_tpu_torch.models.head import inference_outputs
from sast_tpu_torch.models.layers import DropoutKey
from sast_tpu_torch.models.losses import yolox_loss
from sast_tpu_torch.ops.nms import postprocess
from sast_tpu_torch.parallel import mesh as dp
from sast_tpu_torch.training.optimizer import OptaxAdamW, build_optimizer
from sast_tpu_torch.utils.padding import InputPadder, padding_token_mask

REMAT_POLICIES = ("dots", "none", "full")


@dataclasses.dataclass
class TrainState:
    """What a training run carries: the model (parameters and BatchNorm
    statistics), the optimizer with its step count, and the EMA copy of the
    parameters by name (None when ``ema_decay`` is 0)."""

    model: YoloXDetector
    optimizer: OptaxAdamW
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def step(self) -> int:
        return self.optimizer.count


def create_train_state(
    cfg: ExperimentConfig,
    seed: int = 0,
    learning_rate: Optional[float] = None,
    sparse_kernel: bool = False,
    device="cuda",
) -> Tuple[TrainState, YoloXDetector]:
    """A detector with seeded random weights on ``device`` and its optimizer.
    ``sparse_kernel`` builds the model on the window-skipping block kernel,
    which trains through its hand-written backward."""
    model = build_detector(cfg.model, seed=seed, device=device, sparse_kernel=sparse_kernel)
    return train_state_for(model, cfg, learning_rate), model


def train_state_for(model: YoloXDetector, cfg: ExperimentConfig,
                    learning_rate: Optional[float] = None) -> TrainState:
    """A fresh ``TrainState`` around an existing model (e.g. one loaded with
    ``weights.load_jax_variables``)."""
    optimizer = build_optimizer(cfg.training, model.parameters(), learning_rate)
    ema = None
    if cfg.training.ema_decay > 0:
        ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer, ema_params=ema)


def _reset_states(lstm_states: List[LstmState], is_first: torch.Tensor) -> List[LstmState]:
    """Zero the state lanes flagged as sequence starts."""

    def mask(s):
        keep = (~is_first).to(s.dtype)
        return s * keep.reshape((-1,) + (1,) * (s.dim() - 1))

    return [tuple(mask(s) for s in hc) for hc in lstm_states]


_SAVED_BY_DOTS = None


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep what a
    matrix product or a convolution returns, recompute the rest."""
    global _SAVED_BY_DOTS
    if _SAVED_BY_DOTS is None:
        aten = torch.ops.aten
        _SAVED_BY_DOTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
                          aten.convolution.default, aten.linear.default, aten.matmul.default}
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _backbone_scan(
    model: YoloXDetector,
    ev_repr: torch.Tensor,
    lstm_states: List[LstmState],
    in_stages: Tuple[int, ...],
    deterministic: bool,
    padder: Optional[InputPadder] = None,
    num_channels: Optional[int] = None,
    token_mask: Optional[torch.Tensor] = None,
    remat_policy: str = "dots",
    dropout: Optional[DropoutKey] = None,
):
    """Run the recurrent backbone over time; returns ``(final_states,
    feats_seq, p_seq)``: per FPN input stage the features stacked over time
    ``(T, B, h, w, c)``, and the ``(T, num_stages)`` selected-token counts.
    ``dropout`` (its ``t`` ignored) gives timestep ``t`` the key with that
    ``t``.

    ev_repr: (T, B, H, W*C) uint8 when ``padder`` is given, else
    (T, B, H, W, C). The split and the pad happen per timestep, in uint8, so
    only one padded timestep exists at a time; the stem casts.
    """
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"remat_policy must be one of 'dots' | 'none' | 'full', got {remat_policy!r}"
        )

    def step(x_t, states, key):
        if padder is not None:
            Bq, Hq, WC = x_t.shape
            x_t = padder.pad_tensor_ev_repr(x_t.reshape(Bq, Hq, WC // num_channels, num_channels))
        feats, new_states, p = model.forward_backbone(x_t, states, token_mask, deterministic, key)
        return tuple(feats[s] for s in in_stages), new_states, p

    remat = remat_policy != "none" and torch.is_grad_enabled()
    extra = {}
    if remat and remat_policy == "dots":
        extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    states = lstm_states
    outs, ps = [], []
    for t in range(ev_repr.shape[0]):
        key = None if dropout is None else dataclasses.replace(dropout, t=t)
        if remat:
            out, states, p = checkpoint(step, ev_repr[t], states, key, use_reentrant=False,
                                        preserve_rng_state=False, **extra)
        else:
            out, states, p = step(ev_repr[t], states, key)
        outs.append(out)
        ps.append(p)
    feats_seq = tuple(torch.stack([o[i] for o in outs]) for i in range(len(in_stages)))
    return states, feats_seq, torch.stack(ps)


def _select_labeled(feats_seq, in_stages, frame_tidx: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Lane-local gather of labeled frames: (T, B, ...) -> (B * L, ...)."""
    B, L = frame_tidx.shape
    lane = torch.arange(B, device=frame_tidx.device)[:, None]
    tidx = frame_tidx.long()
    return {s: f[tidx, lane].reshape(B * L, *f.shape[2:]) for s, f in zip(in_stages, feats_seq)}


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))


def _step_constants(cfg: ExperimentConfig, device):
    bb = cfg.model.backbone
    padder = InputPadder(bb.in_res_hw)
    token_mask = (
        padding_token_mask(cfg.dataset.resolution_hw, bb.in_res_hw, device)
        if bb.enable_masking
        else None
    )
    return tuple(cfg.model.fpn.in_stages), padder, token_mask


def make_train_step(model: YoloXDetector, cfg: ExperimentConfig,
                    mesh: Optional[dp.Mesh] = None) -> Callable:
    """Returns ``train_step(state, batch, lstm_states) -> (state, lstm_states,
    metrics)``. ``batch`` holds tensors on the model's device (with ``mesh``:
    this rank's lanes of the global batch, rank r holding rows
    ``[r * B, (r + 1) * B)``); ``metrics`` holds 0-d tensors there (losses,
    ``num_fg``, ``P``, ``grad_norm`` and ``grad_norm/<component>``, those of
    the global batch), left on the device so that the step does not wait for
    the card."""
    num_classes = cfg.model.head.num_classes
    topk = cfg.model.head.simota_topk
    att = cfg.model.backbone.attention
    stochastic = (
        att.drop_path > 0.0
        or att.drop_mlp > 0.0
        or cfg.model.backbone.lstm.drop_cell_update > 0.0
    )
    seed = cfg.training.seed if cfg.training.seed is not None else 0
    rank, world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    constants = {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], lstm_states):
        device = batch["ev_repr"].device
        if device not in constants:
            constants[device] = _step_constants(cfg, device)
        in_stages, padder, token_mask = constants[device]
        lstm_states = _reset_states(lstm_states, batch["is_first"])
        T, B = batch["ev_repr"].shape[:2]
        L = batch["frame_tidx"].shape[1]
        model.zero_grad(set_to_none=True)

        final_states, feats_seq, p_seq = _backbone_scan(
            model, batch["ev_repr"], lstm_states, in_stages,
            deterministic=not stochastic, padder=padder,
            num_channels=cfg.model.backbone.input_channels,
            token_mask=token_mask, remat_policy=cfg.training.remat_policy,
            dropout=DropoutKey(seed, state.step, 0, rank, world) if stochastic else None,
        )
        sel = _select_labeled(feats_seq, in_stages, batch["frame_tidx"])
        outputs = model.forward_detect(sel, train=True, mesh=mesh)
        losses = yolox_loss(
            preds=outputs["preds"],
            grids=outputs["grids"],
            strides=outputs["strides"],
            gt_boxes=batch["gt_boxes"].reshape(B * L, -1, 4),
            gt_classes=batch["gt_classes"].reshape(B * L, -1),
            gt_valid=batch["gt_valid"].reshape(B * L, -1),
            frame_valid=batch["frame_valid"].reshape(B * L),
            num_classes=num_classes,
            topk=topk,
            mesh=mesh,
        )
        losses["loss"].backward()

        # Gradient-flow telemetry: global norm plus one per component, taken
        # before the optimizer clips. A parameter the loss did not reach has
        # a zero gradient, as in the JAX package.
        by_component: Dict[str, list] = {}
        for name, p in model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by_component.setdefault(name.split(".")[0], []).append(p.grad)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["P"] = p_seq.sum() / T
        if mesh is not None:
            dp.reduce_gradients(model.parameters())
            # The losses are this rank's shares of the global ones; P is a
            # mean per lane, equal lanes on every rank; num_fg is global.
            keys = ("loss", "iou_loss", "conf_loss", "cls_loss", "P")
            summed = torch.stack([metrics[k] for k in keys])
            dist.all_reduce(summed)
            metrics.update(zip(keys, summed.unbind()))
            metrics["P"] = metrics["P"] / world
        for k, grads in by_component.items():
            metrics[f"grad_norm/{k}"] = _global_norm(grads)
        metrics["grad_norm"] = _global_norm([g for gs in by_component.values() for g in gs])

        state.optimizer.step()
        if state.ema_params is not None:
            d = cfg.training.ema_decay
            with torch.no_grad():
                for name, p in model.named_parameters():
                    state.ema_params[name].mul_(d).add_(p, alpha=1.0 - d)
        new_lstm_states = [tuple(s.detach() for s in hc) for hc in final_states]
        return state, new_lstm_states, metrics

    return train_step


def _detect(model, cfg, feats, frame_valid=None):
    outputs = model.forward_detect(feats, train=False)
    pp = cfg.model.postprocess
    dets = postprocess(
        inference_outputs(outputs["preds"]),
        num_classes=cfg.model.head.num_classes,
        conf_threshold=pp.confidence_threshold,
        nms_threshold=pp.nms_threshold,
        pre_nms_topk=pp.pre_nms_topk,
        max_detections=pp.max_detections,
    )
    if frame_valid is not None:  # invalidate padding frames
        dets["valid"] = dets["valid"] & frame_valid[:, None]
    return dets


def make_eval_step(model: YoloXDetector, cfg: ExperimentConfig) -> Callable:
    """Returns ``eval_step(batch, lstm_states) -> (lstm_states, detections)``:
    the backbone over the clip, detection at the labeled frames, NMS on the
    device. Detections come back with static budgets and validity masks. The
    model's current parameters and running statistics are used; to evaluate
    an EMA copy, load it into a model first."""
    constants = {}

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], lstm_states):
        device = batch["ev_repr"].device
        if device not in constants:
            constants[device] = _step_constants(cfg, device)
        in_stages, padder, token_mask = constants[device]
        lstm_states = _reset_states(lstm_states, batch["is_first"])
        B, L = batch["frame_tidx"].shape
        final_states, feats_seq, _ = _backbone_scan(
            model, batch["ev_repr"], lstm_states, in_stages, deterministic=True,
            padder=padder, num_channels=cfg.model.backbone.input_channels,
            token_mask=token_mask, remat_policy="none",
        )
        sel = _select_labeled(feats_seq, in_stages, batch["frame_tidx"])
        dets = _detect(model, cfg, sel, batch["frame_valid"].reshape(B * L))
        return final_states, dets

    return eval_step


def make_inference_step(model: YoloXDetector, cfg: ExperimentConfig) -> Callable:
    """Single-frame streaming inference: ``infer_step(x, lstm_states) ->
    (detections, new_states, selected-token telemetry)``. ``x`` may be at the
    dataset's native resolution; it is zero-padded to the model's here."""
    constants = {}

    @torch.no_grad()
    def infer_step(x: torch.Tensor, lstm_states):
        if x.device not in constants:
            constants[x.device] = _step_constants(cfg, x.device)
        _, padder, token_mask = constants[x.device]
        x = padder.pad_tensor_ev_repr(x)
        feats, new_states, p = model.forward_backbone(x, lstm_states, token_mask)
        return _detect(model, cfg, feats), new_states, p

    return infer_step
