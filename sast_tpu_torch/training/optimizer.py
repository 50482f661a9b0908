"""Optimizer and learning-rate schedule (port of
sast_tpu/training/optimizer.py).

AdamW, OneCycle with linear anneal (two phases: linear warm-up over
``pct_start * total_steps`` from ``peak / div_factor``, then linear decay to
``peak / final_div_factor``), gradient clipping **by value**.

The schedule is written out from the JAX package's formula, in fp32 step by
step as optax evaluates it, so both give the same number at every step
(``torch.optim.lr_scheduler.OneCycleLR`` places its phase boundary one step
off). ``OptaxAdamW.step`` evaluates the schedule at its count *before* the
increment, as optax's ``scale_by_schedule`` does: update number ``n``
(counting from 1) uses ``schedule(n - 1)``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from sast_tpu_torch.config import TrainingConfig

Schedule = Callable[[int], float]


def _linear(init_value: float, end_value: float, transition_steps: int, count: int) -> np.float32:
    """``optax.linear_schedule`` at ``count``, in fp32."""
    if transition_steps <= 0:
        return np.float32(init_value)
    c = np.float32(min(max(count, 0), transition_steps))
    frac = np.float32(1.0) - c / np.float32(transition_steps)
    return np.float32(init_value - end_value) * frac + np.float32(end_value)


def onecycle_linear_schedule(peak_lr: float, total_steps: int, pct_start: float,
                             div_factor: float, final_div_factor: float) -> Schedule:
    init_lr = peak_lr / div_factor
    final_lr = peak_lr / final_div_factor
    warmup = max(int(total_steps * pct_start), 1)

    def schedule(step: int) -> float:
        if step < warmup:
            return float(_linear(init_lr, peak_lr, warmup, step))
        return float(_linear(peak_lr, final_lr, total_steps - warmup, step - warmup))

    return schedule


def scale_lr_for_global_batch(base_lr: float, global_batch: int, base_batch: int = 8) -> float:
    """lr = base * sqrt(global_batch / base_batch)."""
    return base_lr * math.sqrt(global_batch / base_batch)


def build_schedule(cfg: TrainingConfig, learning_rate: Optional[float] = None) -> Schedule:
    """The step -> lr function of the optimizer; the trainer also evaluates
    it to log the learning rate."""
    lr = learning_rate if learning_rate is not None else cfg.learning_rate
    if cfg.lr_scheduler.use:
        return onecycle_linear_schedule(
            peak_lr=lr,
            total_steps=cfg.lr_scheduler.total_steps,
            pct_start=cfg.lr_scheduler.pct_start,
            div_factor=cfg.lr_scheduler.div_factor,
            final_div_factor=cfg.lr_scheduler.final_div_factor,
        )
    return lambda step: float(np.float32(lr))


class OptaxAdamW:
    """``optax.chain(optax.clip(clip), optax.adamw(schedule, weight_decay))``
    over ``params``: clip every gradient by value, then AdamW with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay), through
    ``torch.optim.AdamW`` with the learning rate set from ``schedule`` at the
    count before the increment. ``torch.optim.AdamW`` skips a parameter
    whose ``.grad`` is None, where optax sees a zero gradient (and still
    decays the weight): the train step fills such gradients with zeros
    first."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 weight_decay: float, clip_value: float):
        self.params = list(params)
        self.schedule, self.clip_value = schedule, clip_value
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def step(self) -> float:
        """One update from the parameters' ``.grad``; returns the rate used."""
        lr = self.schedule(self.count)
        torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return lr


def build_optimizer(cfg: TrainingConfig, params: Iterable[torch.nn.Parameter],
                    learning_rate: Optional[float] = None) -> OptaxAdamW:
    return OptaxAdamW(params, build_schedule(cfg, learning_rate), cfg.weight_decay,
                      cfg.gradient_clip_val)
