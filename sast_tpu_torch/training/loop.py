"""The training loop (port of sast_tpu/training/loop.py): fit, validate,
checkpoints and resume.

``Trainer`` owns the model and the optimizer. ``fit`` carries the per-lane
recurrent state across the steps of one call, starting from zero states,
logs loss, smoothed selected-token count, step time and learning rate,
validates every ``val_every`` steps when it is given an evaluation loader,
keeps the best checkpoint by val/AP, saves every ``ckpt_every`` steps
otherwise, and always ends with a save. ``validate`` streams evaluation
clips with the LSTM state carried across them and scores the labeled frames
with the Prophesee protocol, on the EMA copy of the parameters when there is
one. ``mesh`` (``parallel/mesh.make_mesh()``) trains data-parallel: each
process feeds its ``B / world`` lanes, the parameters and optimizer state
start as rank 0's, the step reduces over the world (``training/steps.py``),
only rank 0 logs and saves, every rank restores, and ``validate`` gathers the
evaluation buffers of all ranks. ``fit(profile_steps=(first, last))``
records a ``torch.profiler`` trace of those steps into ``<workdir>/trace``.
``validate(save_viz=n)`` writes up to ``n`` prediction | label panels as
``<workdir>/viz/val_<batch>.png``, and ``fit`` writes the gradient-flow
figure of the per-component gradient norms logged so far to
``<workdir>/viz/gradflow.png`` at each validation (``utils/viz.py``). JAX
also hands both images to Weights & Biases, which does nothing without a
W&B run; the port has no W&B, so it writes the files and nothing more.
W&B itself is refused by name.

    import numpy as np
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.synthetic import synthetic_train_batch
    from sast_tpu_torch.training.loop import Trainer
    cfg = get_config("gen4", "base")
    trainer = Trainer(cfg, workdir="runs/smoke", log_every=2, sparse_kernel_train=True)
    rng = np.random.RandomState(0)
    trainer.fit((synthetic_train_batch(cfg, rng) for _ in range(8)), max_steps=8)
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from sast_tpu_torch.checkpoint.io import CheckpointManager
from sast_tpu_torch.config import ExperimentConfig
from sast_tpu_torch.data.batch import split_device_batch, to_device
from sast_tpu_torch.eval.prophesee import PropheseeEvaluator, detections_to_prophesee
from sast_tpu_torch.models.backbone import zero_states
from sast_tpu_torch.models.detector import DTYPES, resolve_device, set_sparse_kernel
from sast_tpu_torch.parallel.mesh import Mesh
from sast_tpu_torch.training.steps import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from sast_tpu_torch.utils.logging import MetricLogger, SmoothedValue
from sast_tpu_torch.utils.viz import render_detection_frame, render_gradflow, save_png

_NOT_PORTED = {
    "use_wandb": "Weights & Biases logging",
}


def state_tensors(state: TrainState):
    """Every tensor of a ``TrainState`` on its device, in one fixed order:
    parameters and BatchNorm statistics, the EMA copy, the AdamW moments
    (AdamW's step counts live on the host and follow ``optimizer.count``)."""
    out = list(state.model.state_dict().values())
    if state.ema_params is not None:
        out += list(state.ema_params.values())
    adam = state.optimizer.adamw.state
    for p in state.optimizer.params:
        out += [adam[p][k] for k in ("exp_avg", "exp_avg_sq") if k in adam.get(p, {})]
    return out


class Trainer:
    """``Trainer(cfg, workdir).fit(train_batches, eval_loader_fn, max_steps)``.

    ``val_every`` and ``ckpt_every`` mean what they mean in the JAX trainer:
    validate (and save with the val/AP) every ``val_every`` steps when
    ``fit`` has an evaluation loader, else save every ``ckpt_every`` steps.
    ``sparse_kernel_train`` (the JAX trainer's ``use_pallas_train``) builds
    the model on the window-skipping block kernel, which trains through its
    hand-written backward; ``sparse_kernel_eval`` switches ``eval_step`` to
    it (same parameters). ``learning_rate`` overrides the config's peak
    rate. ``device`` is the card unless the caller passes ``"cpu"``, which
    runs the kernels' plain versions; without a card the default raises.
    With ``mesh`` the trainer runs on ``mesh.device``.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        workdir: str,
        log_every: int = 50,
        val_every: Optional[int] = 10_000,
        ckpt_every: Optional[int] = None,
        sparse_kernel_train: bool = False,
        sparse_kernel_eval: bool = False,
        learning_rate: Optional[float] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
        **not_ported,
    ):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Trainer got an unexpected argument {name!r}")
            if value:
                raise NotImplementedError(f"{_NOT_PORTED[name]} ({name}) is not ported yet")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
        self.cfg = cfg
        self.workdir = workdir
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.device = resolve_device(mesh.device if mesh is not None else device)
        os.makedirs(workdir, exist_ok=True)
        self.logger = MetricLogger(workdir) if self.rank == 0 else None
        self.log_every = log_every
        self.val_every = val_every
        self.ckpt_every = ckpt_every
        seed = cfg.training.seed if cfg.training.seed is not None else 0
        self.state, self.model = create_train_state(
            cfg, seed, learning_rate, sparse_kernel=sparse_kernel_train, device=self.device
        )
        self.sparse_kernel_train = sparse_kernel_train
        self.sparse_kernel_eval = sparse_kernel_eval
        self.train_step = make_train_step(self.model, cfg, mesh)
        self._eval_step = make_eval_step(self.model, cfg)
        self.p_smooth = SmoothedValue()
        self.best_val_ap = -1.0
        self._ckpt = None
        self._sync_state()

    def _sync_state(self) -> None:
        """Under a mesh, every rank takes rank 0's state (the GSPMD step's
        replicated state)."""
        if self.mesh is not None:
            for t in state_tensors(self.state):
                dist.broadcast(t, 0)

    def _print(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, file=sys.stderr)

    def _log(self, metrics: Dict[str, float], step: int) -> None:
        if self.logger is not None:
            self.logger.log(metrics, step)

    def _save(self, step: int, metrics: Optional[dict] = None) -> None:
        if self.rank == 0:
            self.ckpt.save(step, self.state, metrics=metrics)

    def _zero_states(self, B: int):
        return zero_states(self.cfg.model.backbone, B, DTYPES[self.cfg.model.compute_dtype],
                           self.device)

    def eval_step(self, batch: Dict[str, torch.Tensor], lstm_states):
        """One evaluation step on device tensors, with the model's current
        parameters, on the attention path ``sparse_kernel_eval`` names."""
        set_sparse_kernel(self.model, self.sparse_kernel_eval)
        try:
            return self._eval_step(batch, lstm_states)
        finally:
            set_sparse_kernel(self.model, self.sparse_kernel_train)

    # -- checkpointing -------------------------------------------------------
    @property
    def ckpt(self) -> CheckpointManager:
        if self._ckpt is None:
            self._ckpt = CheckpointManager(os.path.join(self.workdir, "ckpts"))
        return self._ckpt

    def maybe_resume(self, resume: bool, weights_only: bool = False) -> None:
        if not resume:
            return
        if self.ckpt.latest_step() is None:
            self._print("no checkpoint found; starting fresh")
            return
        if weights_only:
            # A fresh run starting from old weights (fine-tune): its own best
            # must not compete with the source run's history.
            self.ckpt.restore_weights(self.state)
        else:
            # A full resume continues the same run: recover the historical
            # best so that a worse checkpoint after it cannot become 'best'.
            self.ckpt.restore(self.state)
            self.best_val_ap = max(self.best_val_ap, self.ckpt.best_val_ap())
        self._sync_state()
        self._print(f"resumed from step {self.state.step}")

    # -- validation ------------------------------------------------------------
    @contextlib.contextmanager
    def _eval_parameters(self):
        """The EMA copy in the model's parameters for the duration, when
        there is one; the trained values are copied back afterwards, also
        when the body raises. Copies into the parameters' storage keep the
        optimizer's references valid."""
        ema = self.state.ema_params
        if ema is None:
            yield
            return
        params = dict(self.model.named_parameters())
        trained = {name: p.detach().clone() for name, p in params.items()}
        try:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(ema[name])
            yield
        finally:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(trained[name])

    def validate(
        self,
        eval_batches: Iterable[dict],
        max_batches: Optional[int] = None,
        save_viz: int = 0,
    ) -> Dict[str, float]:
        """Streaming evaluation over ``eval_batches`` (at most
        ``max_batches``): ``val/<metric>`` of the Prophesee protocol, or
        ``{}`` when no labeled frame was seen. Under a mesh each rank streams
        its own lanes and the metrics are those of all ranks' frames, the
        same on every rank. ``save_viz=n``: the first labeled frame of each
        of the first ``n`` batches that have one is rendered with its
        predictions and labels (``utils/viz.render_detection_frame``) to
        ``<workdir>/viz/val_<batch>.png``, as JAX picks and names them."""
        cfg = self.cfg
        evaluator = PropheseeEvaluator(cfg.dataset.name, cfg.dataset.downsample_by_factor_2)
        lstm = None
        n = n_viz = 0
        try:
            with self._eval_parameters():
                for batch in eval_batches:
                    device_batch, host = split_device_batch(batch)
                    device_batch = to_device(device_batch, self.device)
                    if lstm is None:
                        lstm = self._zero_states(device_batch["ev_repr"].shape[1])
                    lstm, dets = self.eval_step(device_batch, lstm)
                    dets_np = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                               for k, v in dets.items()}

                    labels_flat = [fl for lane in host["_labels"] for fl in lane]
                    frame_valid = np.asarray(batch["frame_valid"]).reshape(-1)
                    sel, times, gts = [], [], []
                    for f, fl in enumerate(labels_flat):
                        if not frame_valid[f] or fl is None or len(fl) == 0:
                            continue
                        t = np.unique(fl.t)
                        if t.size != 1:
                            raise ValueError("the labels of one frame must share a timestamp")
                        sel.append(f)
                        times.append(int(t[0]))
                        gts.append(fl.to_structured())
                    if sel:
                        sub = {k: v[np.asarray(sel)] for k, v in dets_np.items()}
                        preds = detections_to_prophesee(sub, times)
                        evaluator.add_labels(gts)
                        evaluator.add_predictions(preds)
                        if n_viz < save_viz:
                            self._save_panel(batch, sel[0], gts[0], preds[0], n)
                            n_viz += 1
                    n += 1
                    if max_batches is not None and n >= max_batches:
                        break
        finally:
            # A truncated consumer must release the prefetcher's producer
            # thread and its buffered batches and h5 handles.
            if hasattr(eval_batches, "close"):
                eval_batches.close()
        evaluator.gather_across_processes()
        if not evaluator.has_data():
            return {}
        h, w = cfg.model.backbone.in_res_hw
        metrics = evaluator.evaluate_buffer(h, w) or {}
        return {f"val/{k}": v for k, v in metrics.items()}

    def _save_panel(self, batch: dict, frame: int, gt: np.ndarray, pred: np.ndarray,
                    n: int) -> None:
        """Frame ``frame`` (lane-major over the batch's labeled slots) with
        its labels ``gt`` and predictions ``pred`` (Prophesee boxes) as
        ``<workdir>/viz/val_<n>.png``."""
        slots = batch["frame_tidx"].shape[1]
        lane, slot = frame // slots, frame % slots
        tidx = int(batch["frame_tidx"][lane, slot])
        ev = batch["ev_repr"][tidx, lane]  # (H, W * C)
        ev = ev.cpu().numpy() if isinstance(ev, torch.Tensor) else np.asarray(ev)
        ch = self.cfg.model.backbone.input_channels
        ev = ev.reshape(ev.shape[0], ev.shape[1] // ch, ch)

        def xywh(b):
            return np.stack([b["x"], b["y"], b["w"], b["h"]], -1)

        panel = render_detection_frame(
            ev, gt_boxes=xywh(gt), gt_classes=gt["class_id"],
            pred_boxes=xywh(pred) if len(pred) else None,
            pred_classes=pred["class_id"] if len(pred) else None)
        viz_dir = os.path.join(self.workdir, "viz")
        os.makedirs(viz_dir, exist_ok=True)
        save_png(os.path.join(viz_dir, f"val_{n:04d}.png"), panel)

    # -- fit -------------------------------------------------------------------
    def fit(
        self,
        train_batches: Iterable[dict],
        eval_loader_fn: Optional[Callable[[], Iterable[dict]]] = None,
        max_steps: Optional[int] = None,
        eval_max_batches: Optional[int] = None,
        profile_steps=None,
    ) -> Dict[str, float]:
        """Train on ``train_batches`` (dicts of numpy arrays in the layout of
        ``training/steps.py``) until ``max_steps`` optimizer steps are done or
        the batches run out, validating on ``eval_loader_fn()`` every
        ``val_every`` steps. The arguments are the JAX trainer's, in its
        order; every call starts from zero LSTM states, as JAX's ``fit`` does.
        ``profile_steps=(first, last)`` records a ``torch.profiler`` trace of
        training steps ``first`` to ``last`` (inclusive, counted from 1 over
        the run, so a resumed run inside the window records its rest) into
        ``<workdir>/trace``, one file per rank, each step a
        ``train_step <n>`` range. At each log point the gradient norms
        (``grad_norm/<component>`` and ``grad_norm``, as ``total``) join the
        gradient-flow history of this call, which each validation draws to
        ``<workdir>/viz/gradflow.png`` (on rank 0). Returns the last logged
        metrics."""
        max_steps = max_steps or self.cfg.training.max_steps
        prof_first, prof_last = profile_steps or (None, None)
        profiler = None
        last_metrics: Dict[str, float] = {}
        t_last = time.time()
        step = self.state.step
        last_ckpt_step = step
        lstm = None
        gf_steps: list = []
        gf_series: Dict[str, list] = {}
        try:
            for batch in train_batches:
                if step >= max_steps:
                    break
                device_batch, _ = split_device_batch(batch)
                device_batch = to_device(device_batch, self.device)
                if lstm is None:
                    lstm = self._zero_states(device_batch["ev_repr"].shape[1])
                # <= so that a resumed run whose step already sits inside the
                # window records its rest; prof_last keeps a finished window
                # from starting again.
                if prof_first is not None and profiler is None and (
                        prof_first <= step + 1 <= prof_last):
                    profiler = self._start_trace()
                with (torch.profiler.record_function(f"train_step {step + 1}")
                      if profiler is not None else contextlib.nullcontext()):
                    self.state, lstm, metrics = self.train_step(self.state, device_batch, lstm)
                step += 1
                if profiler is not None and step >= prof_last:
                    self._stop_trace(profiler)
                    profiler = None
                if step % self.log_every == 0 or step == 1:
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the card
                    sn = self.p_smooth.update(metrics.pop("P"))
                    dt = (time.time() - t_last) / min(self.log_every, step)
                    t_last = time.time()
                    log = {f"train/{k}": v for k, v in metrics.items()}
                    # The update that produced this step used schedule(step - 1).
                    lr = self.state.optimizer.schedule(step - 1)
                    log.update({"train/SN": sn, "train/step_time_s": dt, "train/lr": lr})
                    self._log(log, step)
                    self._print(f"step {step}  loss {metrics['loss']:.3f}  SN {sn:.0f}  "
                                f"{dt * 1000:.0f} ms/step  lr {lr:.3e}")
                    last_metrics = log
                    gf_steps.append(step)
                    for k, v in metrics.items():
                        if k.startswith("grad_norm"):
                            gf_series.setdefault(k.replace("grad_norm/", "").replace(
                                "grad_norm", "total"), []).append(v)

                if (eval_loader_fn is not None and self.val_every is not None
                        and step % self.val_every == 0):
                    if gf_steps and self.rank == 0:
                        os.makedirs(os.path.join(self.workdir, "viz"), exist_ok=True)
                        save_png(os.path.join(self.workdir, "viz", "gradflow.png"),
                                 render_gradflow(gf_steps, gf_series))
                    val_metrics = self.validate(eval_loader_fn(), max_batches=eval_max_batches)
                    if val_metrics:
                        self._log(val_metrics, step)
                        self._print("  ".join(f"{k}={v:.4f}" for k, v in val_metrics.items()))
                        last_metrics.update(val_metrics)
                    val_ap = val_metrics.get("val/AP", -1.0)
                    self.best_val_ap = max(self.best_val_ap, val_ap)
                    self._save(step, {"val_AP": val_ap})
                    last_ckpt_step = step
                elif self.ckpt_every is not None and step % self.ckpt_every == 0:
                    self._save(step)
                    last_ckpt_step = step
        finally:
            if profiler is not None:  # the loop ended inside the window
                self._stop_trace(profiler)
            # Breaking at max_steps leaves an endless prefetcher's producer
            # blocked mid-put; release it and its buffers.
            if hasattr(train_batches, "close"):
                train_batches.close()

        # A run never ends without its last state, whatever max_steps is
        # against val_every and ckpt_every.
        if step > 0 and last_ckpt_step != step:
            self._save(step)
        return last_metrics

    def _start_trace(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                os.path.join(self.workdir, "trace"), worker_name=f"rank{self.rank}"))
        profiler.start()
        return profiler

    def _stop_trace(self, profiler) -> None:
        """Wait for the card, so that the trace holds the steps' work and not
        only their launches, then write it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
