"""The training loop (port of the ``fit`` half of
sast_tpu/training/loop.py).

``Trainer`` owns the model, the optimizer and the per-lane recurrent state
carried across steps, and logs loss, smoothed selected-token count, step
time and learning rate. Not ported yet, and refused rather than ignored:
validation against a dataset, checkpoints and resume, the device mesh,
Weights & Biases and profiler traces.

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

import os
import sys
import time
from typing import Dict, Iterable, Optional

import torch

from sast_tpu_torch.config import ExperimentConfig
from sast_tpu_torch.data.batch import split_device_batch, to_device
from sast_tpu_torch.models.backbone import zero_states
from sast_tpu_torch.models.detector import DTYPES, resolve_device, set_sparse_kernel
from sast_tpu_torch.training.steps import create_train_state, make_eval_step, make_train_step
from sast_tpu_torch.utils.logging import MetricLogger, SmoothedValue

_NOT_PORTED = {
    "use_wandb": "Weights & Biases logging",
    "val_every": "validation against a dataset",
    "ckpt_every": "checkpoints",
    "mesh": "the data-parallel mesh",
}


class Trainer:
    """``Trainer(cfg, workdir).fit(train_batches, max_steps)``.

    ``sparse_kernel_train`` (the JAX trainer's ``use_pallas_train``) builds
    the model on the window-skipping block kernel, which trains through its
    hand-written backward; ``sparse_kernel_eval`` switches ``eval_step`` to
    it (same parameters). ``learning_rate`` overrides the config's peak
    rate. ``device`` is the card unless the caller passes ``"cpu"``, which
    runs the kernels' plain versions; without a card the default raises.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        workdir: str,
        log_every: int = 50,
        sparse_kernel_train: bool = False,
        sparse_kernel_eval: bool = False,
        learning_rate: Optional[float] = None,
        device="cuda",
        **not_ported,
    ):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Trainer got an unexpected argument {name!r}")
            if value:
                raise NotImplementedError(f"{_NOT_PORTED[name]} ({name}) is not ported yet")
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        os.makedirs(workdir, exist_ok=True)
        self.logger = MetricLogger(workdir)
        self.log_every = log_every
        seed = cfg.training.seed if cfg.training.seed is not None else 0
        self.state, self.model = create_train_state(
            cfg, seed, learning_rate, sparse_kernel=sparse_kernel_train, device=self.device
        )
        self.sparse_kernel_train = sparse_kernel_train
        self.sparse_kernel_eval = sparse_kernel_eval
        self.train_step = make_train_step(self.model, cfg)
        self._eval_step = make_eval_step(self.model, cfg)
        self.p_smooth = SmoothedValue()
        self.lstm_states = None

    def _zero_states(self, B: int):
        return zero_states(self.cfg.model.backbone, B, DTYPES[self.cfg.model.compute_dtype],
                           self.device)

    def eval_step(self, batch: Dict[str, torch.Tensor], lstm_states):
        """One evaluation step on device tensors, on the attention path
        ``sparse_kernel_eval`` names."""
        set_sparse_kernel(self.model, self.sparse_kernel_eval)
        try:
            return self._eval_step(batch, lstm_states)
        finally:
            set_sparse_kernel(self.model, self.sparse_kernel_train)

    def fit(self, train_batches: Iterable[dict], max_steps: Optional[int] = None,
            eval_loader_fn=None, profile_steps=None) -> Dict[str, float]:
        """Train on ``train_batches`` (dicts of numpy arrays in the layout of
        ``training/steps.py``) until ``max_steps`` optimizer steps are done or
        the batches run out. Returns the last logged metrics."""
        if eval_loader_fn is not None:
            raise NotImplementedError("validation against a dataset is not ported yet")
        if profile_steps is not None:
            raise NotImplementedError("profiler traces are not ported yet")
        max_steps = max_steps or self.cfg.training.max_steps
        last_metrics: Dict[str, float] = {}
        t_last = time.time()
        step = self.state.step
        for batch in train_batches:
            if step >= max_steps:
                break
            device_batch, _ = split_device_batch(batch)
            device_batch = to_device(device_batch, self.device)
            if self.lstm_states is None:
                self.lstm_states = self._zero_states(device_batch["ev_repr"].shape[1])
            self.state, self.lstm_states, metrics = self.train_step(
                self.state, device_batch, self.lstm_states)
            step += 1
            if step % self.log_every == 0 or step == 1:
                metrics = {k: float(v) for k, v in metrics.items()}  # waits for the card
                sn = self.p_smooth.update(metrics.pop("P"))
                dt = (time.time() - t_last) / min(self.log_every, step)
                t_last = time.time()
                log = {f"train/{k}": v for k, v in metrics.items()}
                # The update that produced this step used schedule(step - 1).
                lr = self.state.optimizer.schedule(step - 1)
                log.update({"train/SN": sn, "train/step_time_s": dt, "train/lr": lr})
                self.logger.log(log, step)
                print(f"step {step}  loss {metrics['loss']:.3f}  SN {sn:.0f}  "
                      f"{dt * 1000:.0f} ms/step  lr {lr:.3e}", file=sys.stderr)
                last_metrics = log
        if hasattr(train_batches, "close"):
            train_batches.close()
        return last_metrics
