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

``CapturedTrainStep`` and ``CapturedEvalStep`` are the counterparts of the
JAX trainer's ``jax.jit(train_step, donate_argnums=(0, 2))`` and
``jax.jit(eval_step, donate_argnums=(2,))`` (sast_tpu/training/loop.py:
90-99): the step on static batch buffers (``graphs.BatchBuffers``) with the
carried LSTM states in buffers of their own, written back in place, and on
a card captured as one CUDA graph after its first call (``graphs.Captured``;
a layer that chooses its branch on the card is a conditional node of it,
forward and backward): the first call is the real first step, run eagerly as
the warm-up, and every later call replays it. The train step's whole update runs on the card (the
optimizer's count and rate are tensors there, ``training/optimizer.py``;
the dropout masks are hashed there from that count, ``models/layers``), so
a replay is the next step. With ``graph`` off, or on the CPU, the same
bodies run eagerly at every call.
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

from sast_tpu_torch import graphs
from sast_tpu_torch.config import ExperimentConfig
from sast_tpu_torch.models.backbone import LstmState, zero_states
from sast_tpu_torch.models.detector import DTYPES, YoloXDetector, build_detector
from sast_tpu_torch.models.head import inference_outputs
from sast_tpu_torch.models.layers import DropoutKey
from sast_tpu_torch.models.losses import yolox_loss
from sast_tpu_torch.ops.nms import postprocess
from sast_tpu_torch.parallel import mesh as dp
from sast_tpu_torch.training.optimizer import OptaxAdamW, build_optimizer
from sast_tpu_torch.utils import timers
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
            dropout=(DropoutKey(seed, state.step, 0, rank, world,
                                counter=state.optimizer.adamw.count) if stochastic else None),
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
            names, params = zip(*model.named_parameters())
            ema = [state.ema_params[name] for name in names]
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, params, alpha=1.0 - d)
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


def refuse_capture(mesh: Optional[dp.Mesh] = None) -> None:
    """Raise, naming the reason, where the train step cannot be captured as
    it runs eagerly: a world whose backend stages its collectives through
    the host (gloo). A layer that chooses its branch on the card is captured
    with its choice, forward and backward, as conditional graph nodes
    (``graphs.Schedule``)."""
    if mesh is not None and dist.get_backend() == "gloo":
        raise ValueError("the gloo backend stages its collectives through the host and cannot "
                         "be captured in a CUDA graph; pass graph=False, or use nccl")


class _OnBuffers:
    """A step on static buffers: the batch's (``graphs.BatchBuffers``, made
    from the first batch's shapes and dtypes; a batch of other shapes makes
    new ones and captures again, as a jitted step retraces) and the carried
    LSTM states' (zero at first; ``zero_states()`` zeroes them in place),
    as a ``graphs.CapturedStep`` (``step``) over them. ``fns`` holds the
    step functions, looked up at each eager call and at the capture, so
    that a caller may wrap them."""

    def __init__(self, fns: Dict[str, Callable], cfg: ExperimentConfig, device, graph: bool):
        self.fns, self.cfg = fns, cfg
        self.device = torch.device(device)
        self.graph = bool(graph)
        self.buffers: Optional[graphs.BatchBuffers] = None
        self.step: Optional[graphs.CapturedStep] = None

    def _buffers_for(self, batch) -> graphs.BatchBuffers:
        if self.buffers is None or not self.buffers.matches(batch):
            self.buffers = graphs.BatchBuffers(batch, self.device)
            B = self.buffers.tensors["ev_repr"].shape[1]
            states = zero_states(self.cfg.model.backbone, B,
                                 DTYPES[self.cfg.model.compute_dtype], self.device)
            self.step = self._captured(self.buffers.tensors, states)
        return self.buffers

    def _captured(self, inputs, states) -> graphs.CapturedStep:
        raise NotImplementedError

    @property
    def run(self) -> Optional[graphs.Captured]:
        return None if self.step is None else self.step.run

    @property
    def states(self) -> Optional[List[LstmState]]:
        return None if self.step is None else self.step.states

    def zero_states(self) -> None:
        if self.step is not None:
            self.step.zero_states()


class CapturedTrainStep(_OnBuffers):
    """``fns["train"]`` (``make_train_step``'s function) on static buffers,
    replayed as a captured CUDA graph on a card (module docstring), updating
    ``state`` (a ``TrainState``). A call ``step(batch)`` (numpy arrays or
    tensors in the layout above) loads the batch into the buffers, runs one
    step and returns its metrics: 0-d tensors on the card, which the next
    call rewrites. On a card with ``graph`` on, the first call refuses a
    gloo world (``refuse_capture``) before it touches the card. A call's
    spans (``utils/timers``): ``fit.wait`` (for the previous batch's copies
    from the staging), ``fit.stage`` (the batch into the page-locked
    staging, its copies up enqueued) and ``fit.launch`` (the step, the
    version bumps). On a card the step's graph is larger than the card's
    queue of commands, so its launch blocks while the card runs the
    previous step: that wait lies inside ``fit.launch``."""

    def __init__(self, fns: Dict[str, Callable], state: TrainState, cfg: ExperimentConfig,
                 device, graph: bool = True, mesh: Optional[dp.Mesh] = None):
        super().__init__(fns, cfg, device, graph)
        self.state = state
        self.mesh = mesh

    def _captured(self, inputs, states) -> graphs.CapturedStep:
        # The step holds what it reads, not this object: no reference cycle
        # keeps the graphs alive after their trainer is gone.
        fns, state = self.fns, self.state

        def step(states, inputs):
            _, new_states, metrics = fns["train"](state, inputs, states)
            return new_states, metrics

        def held():
            ema = list(state.ema_params.values()) if state.ema_params is not None else []
            return state.optimizer.tensors() + ema

        return graphs.CapturedStep(step, states, inputs, self.device, self.graph,
                                   [state.model], state=held)

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        if self.step is None and self.graph and self.device.type == "cuda":
            refuse_capture(self.mesh)
        buffers = self._buffers_for(batch)
        with timers.span("fit.wait"):
            buffers.wait()
        with timers.span("fit.stage"):
            buffers.fill(batch)
        with timers.span("fit.launch"):
            optimizer = self.state.optimizer
            count, replays = optimizer.count, self.run.replays
            metrics = self.step()
            # One call is one update: the warm-up's (its capture runs no
            # step) or the replay's, whose Python did not run.
            optimizer.count = count + 1
            if self.run.replays != replays:
                written = [*self.state.model.parameters(), *self.state.model.buffers()]
                if self.state.ema_params is not None:
                    written += list(self.state.ema_params.values())
                graphs.bump_versions(written)
        return metrics


class CapturedEvalStep(_OnBuffers):
    """``fns["eval"]`` (``make_eval_step``'s function) on static buffers,
    replayed as captured CUDA graphs on a card, as the serving step is:
    ``step(batch)`` loads the batch into the buffers, runs the step with the
    LSTM states carried in ``states`` and returns the detections, which the
    next call rewrites. A layer that chooses its branch on the card is a
    conditional node of the captured graph (``graphs.Schedule``); the
    attention path is that of ``model``'s switches at the call
    (``graphs._kernel_switches``)."""

    def __init__(self, fns: Dict[str, Callable], model: YoloXDetector, cfg: ExperimentConfig,
                 device, graph: bool = True):
        super().__init__(fns, cfg, device, graph)
        self.model = model

    def _captured(self, inputs, states) -> graphs.CapturedStep:
        fns = self.fns

        def step(states, inputs):
            return fns["eval"](inputs, states)

        return graphs.CapturedStep(step, states, inputs, self.device, self.graph, [self.model])

    @torch.no_grad()
    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        self._buffers_for(batch).load(batch)
        return self.step()
