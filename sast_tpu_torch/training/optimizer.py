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

The update runs on the parameters' device with no host read and no host
write, as optax's runs inside the jitted step: the count is a 0-d tensor
there, and the rate is the schedule of that tensor, computed there
(``Schedule.on_card``; the host's ``Schedule.__call__`` runs the same fp32
operations on the CPU, so it gives the same bits). A captured CUDA graph of
the train step (``training/steps.CapturedTrainStep``) therefore replays the
right rate and bias corrections at every step.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import numpy as np
import torch

from sast_tpu_torch.config import TrainingConfig


def _linear(init_value: float, end_value: float, transition_steps: int,
            count: torch.Tensor) -> torch.Tensor:
    """``optax.linear_schedule`` of a 0-d fp32 ``count`` tensor, on its
    device, one fp32 operation at a time in optax's order (each a kernel of
    its own, so nothing is contracted into a fused multiply-add; divisions
    by tensors, which round as IEEE division does)."""
    def f32(v):
        return torch.full((), float(np.float32(v)), dtype=torch.float32, device=count.device)

    if transition_steps <= 0:
        return f32(init_value)
    c = count.clamp(0, transition_steps)
    frac = f32(1.0) - c / f32(transition_steps)
    return f32(init_value - end_value) * frac + f32(end_value)


class Schedule:
    """step -> learning rate. ``schedule.on_card(count)`` is the fp32 rate
    of a 0-d fp32 ``count`` tensor, computed on its device;
    ``schedule(step)`` the same fp32 rate of a host step, as a Python
    float (the same operations on the CPU)."""

    def __call__(self, step: int) -> float:
        return float(self.on_card(torch.full((), float(step), dtype=torch.float32)))

    def on_card(self, count: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class ConstantSchedule(Schedule):
    def __init__(self, lr: float):
        self.lr = float(np.float32(lr))

    def on_card(self, count: torch.Tensor) -> torch.Tensor:
        return torch.full((), self.lr, dtype=torch.float32, device=count.device)


class OneCycleLinearSchedule(Schedule):
    """optax's ``join_schedules`` of a linear warm-up and a linear decay."""

    def __init__(self, peak_lr: float, total_steps: int, pct_start: float,
                 div_factor: float, final_div_factor: float):
        self.init_lr = peak_lr / div_factor
        self.peak_lr = peak_lr
        self.final_lr = peak_lr / final_div_factor
        self.total_steps = total_steps
        self.warmup = max(int(total_steps * pct_start), 1)

    def on_card(self, count: torch.Tensor) -> torch.Tensor:
        up = _linear(self.init_lr, self.peak_lr, self.warmup, count)
        down = _linear(self.peak_lr, self.final_lr, self.total_steps - self.warmup,
                       count - self.warmup)
        return torch.where(count < self.warmup, up, down)


def onecycle_linear_schedule(peak_lr: float, total_steps: int, pct_start: float,
                             div_factor: float, final_div_factor: float) -> Schedule:
    return OneCycleLinearSchedule(peak_lr, total_steps, pct_start, div_factor, final_div_factor)


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
    return ConstantSchedule(lr)


class AdamWState(torch.optim.Optimizer):
    """The moments and the count of ``OptaxAdamW``, kept as
    ``torch.optim.AdamW`` keeps them (``state[p]`` holds ``step``,
    ``exp_avg`` and ``exp_avg_sq``; one param group), so that
    ``state_dict``, ``load_state_dict`` and the checkpoints of either
    optimizer read the other's. Every parameter's ``step`` is the one 0-d
    fp32 tensor ``count`` on the parameters' device.

    The moments appear at the first update. ``load_state_dict`` writes the
    loaded values into the tensors already held, so that a captured graph
    that reads them stays valid; a ``step`` loaded on the host (AdamW's
    checkpoints) is moved to the card."""

    def __init__(self, params: List[torch.nn.Parameter], lr: float, weight_decay: float):
        super().__init__(params, dict(lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=weight_decay))
        device = params[0].device if params else torch.device("cpu")
        self.count = torch.zeros((), dtype=torch.float32, device=device)

    def step(self, closure=None):
        raise RuntimeError("AdamWState holds OptaxAdamW's state; call OptaxAdamW.step")

    def moments(self):
        """The (exp_avg, exp_avg_sq) lists in parameter order, made at the
        first call."""
        params = self.param_groups[0]["params"]
        for p in params:
            if not self.state[p]:
                self.state[p] = dict(step=self.count,
                                     exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                                     exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))
        return ([self.state[p]["exp_avg"] for p in params],
                [self.state[p]["exp_avg_sq"] for p in params])

    def load_state_dict(self, state_dict) -> None:
        held = {p: dict(s) for p, s in self.state.items()}
        super().load_state_dict(state_dict)
        steps = {float(s["step"]) for s in self.state.values() if "step" in s}
        if len(steps) > 1:
            raise ValueError(f"the checkpoint's AdamW steps differ between parameters: {steps}")
        for p, s in self.state.items():
            for key, value in s.items():
                if key == "step":
                    s[key] = self.count
                    continue
                old = held.get(p, {}).get(key)
                if old is not None:
                    old.copy_(value)
                    s[key] = old
        self.count.fill_(steps.pop() if steps else 0.0)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state (the count, then the moments)."""
        return [self.count] + [t for p in self.param_groups[0]["params"]
                               for k, t in self.state.get(p, {}).items() if k != "step"]


class OptaxAdamW:
    """``optax.chain(optax.clip(clip), optax.adamw(schedule, weight_decay))``
    over ``params``: clip every gradient by value, then optax's
    ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, bias corrections at the
    incremented count), ``add_decayed_weights`` and the rate of the count
    before the increment, written as optax writes them with foreach
    operations on the parameters' device. optax sees a zero gradient where
    a parameter got none (and still decays the weight): the train step
    fills such gradients with zeros first.

    ``count`` is the host's number of updates (checkpoints, logs);
    ``adamw.count`` is the same number as a 0-d fp32 tensor on the
    parameters' device, which the update reads and increments there.
    ``step()`` runs one update and counts it on both."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 weight_decay: float, clip_value: float):
        self.params = list(params)
        self.schedule, self.clip_value = schedule, clip_value
        self.weight_decay = weight_decay
        self.count = 0
        self.adamw = AdamWState(self.params, schedule(0), weight_decay)

    def step(self) -> float:
        """One update from the parameters' ``.grad``; returns the rate used
        (the host's value of the schedule at the count before)."""
        lr = self.schedule(self.count)
        self.update()
        self.count += 1
        return lr

    @torch.no_grad()
    def update(self) -> None:
        """The update on the card: no host read, no host write."""
        params = self.params
        grads = [p.grad for p in params]
        count = self.adamw.count
        lr = self.schedule.on_card(count)  # the count before the increment
        torch._foreach_clamp_min_(grads, -self.clip_value)
        torch._foreach_clamp_max_(grads, self.clip_value)
        mu, nu = self.adamw.moments()
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        count.add_(1.0)
        one = torch.ones((), dtype=torch.float32, device=count.device)
        bc1 = one - torch.pow(torch.full_like(one, b1), count)
        bc2 = one - torch.pow(torch.full_like(one, b2), count)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(params, updates)

    def tensors(self) -> List[torch.Tensor]:
        """The state tensors the update reads and writes on the card."""
        return self.adamw.tensors()


def build_optimizer(cfg: TrainingConfig, params: Iterable[torch.nn.Parameter],
                    learning_rate: Optional[float] = None) -> OptaxAdamW:
    return OptaxAdamW(params, build_schedule(cfg, learning_rate), cfg.weight_decay,
                      cfg.gradient_clip_val)
