"""Checkpoints of a training run: the best by val/AP plus the latest, with
resume (the port's counterpart of sast_tpu/checkpoint/orbax_io.py).

One file per step, ``<directory>/step_<N>.pt`` (``torch.save``), written to
a temporary file and moved into place with ``os.replace``, so a crash leaves
either the old set or the new file whole. Each holds:

- ``model``: the detector's ``state_dict()`` (parameters and BatchNorm
  running statistics);
- ``optimizer``: ``OptaxAdamW``'s count and its state in
  ``torch.optim.AdamW``'s state-dict layout (moments and their step
  tensors); a file written by ``torch.optim.AdamW`` itself (steps on the
  host) restores the same way;
- ``ema``: the EMA copy of the parameters by name, or None;
- ``step`` and the ``metrics`` given to ``save``.

``index.json`` beside them maps each step to its metrics (null for a save
without metrics), so the retention policy and ``best_step`` need not load a
checkpoint. Retention: the best checkpoint by ``val_AP`` (the first step
that reached it) and the last ``max_last`` steps; everything else is deleted
after each save. A save without metrics is the newest step, so it is kept,
and it never evicts the latest save.

Tensors are saved from the device they live on and land on the device of
the state they are restored into.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import torch

from sast_tpu_torch.training.steps import TrainState

_FILE = re.compile(r"^step_(\d+)\.pt$")


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    """Keeps the best-AP checkpoint and the ``max_last`` most recent ones."""

    def __init__(self, directory: str, max_last: int = 1):
        if max_last < 1:
            raise ValueError(f"max_last must be at least 1, got {max_last}")
        self.directory = os.path.abspath(directory)
        self.max_last = max_last
        os.makedirs(self.directory, exist_ok=True)

    # -- layout ---------------------------------------------------------------
    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = _FILE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _index(self) -> Dict[int, Optional[dict]]:
        path = os.path.join(self.directory, "index.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def _write_index(self, index: Dict[int, Optional[dict]]) -> None:
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in sorted(index.items())}, f)
        _atomic_write(os.path.join(self.directory, "index.json"), write)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: TrainState,
             metrics: Optional[Dict[str, float]] = None) -> str:
        """Write ``state`` as checkpoint ``step``, then apply the retention
        policy. ``metrics`` None or empty is a save without metrics.
        Returns the file's path."""
        opt = state.optimizer
        payload = {
            "step": int(step),
            "model": state.model.state_dict(),
            "optimizer": {"count": int(opt.count), "adamw": opt.adamw.state_dict()},
            "ema": state.ema_params,
            "metrics": dict(metrics) if metrics else None,
        }
        path = self.path(step)
        _atomic_write(path, lambda tmp: torch.save(payload, tmp))
        index = self._index()
        index[int(step)] = payload["metrics"]
        steps = self.all_steps()
        keep = set(steps[-self.max_last:])
        best = self._best_of({s: index.get(s) for s in steps})
        if best is not None:
            keep.add(best)
        for s in steps:
            if s not in keep:
                os.remove(self.path(s))
        self._write_index({s: index.get(s) for s in steps if s in keep})
        return path

    # -- queries --------------------------------------------------------------
    @staticmethod
    def _best_of(index: Dict[int, Optional[dict]]) -> Optional[int]:
        best, best_ap = None, None
        for s in sorted(index):
            m = index[s]
            if m and "val_AP" in m and (best_ap is None or m["val_AP"] > best_ap):
                best, best_ap = s, m["val_AP"]
        return best

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The retained step with the highest ``val_AP``; None when no
        retained checkpoint carries metrics."""
        index = self._index()
        return self._best_of({s: index.get(s) for s in self.all_steps()})

    def best_val_ap(self) -> float:
        """Highest recorded val_AP across retained checkpoints (-1.0 when
        none carry metrics): a resumed trainer recovers its historical best
        instead of re-claiming 'best' on the first validation after it."""
        best = self.best_step()
        return -1.0 if best is None else float(self._index()[best]["val_AP"])

    def metrics(self, step: int) -> Optional[dict]:
        return self._index().get(int(step))

    # -- restore --------------------------------------------------------------
    def _load(self, step: Optional[int]) -> dict:
        """The payload of ``step`` on the host; ``load_state_dict`` and
        ``copy_`` move each tensor to the device of the tensor it lands in
        (the AdamW step counters stay on the host, as torch keeps them)."""
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    @staticmethod
    @torch.no_grad()
    def _load_weights(state: TrainState, payload: dict) -> None:
        ema = payload["ema"]
        if (ema is None) != (state.ema_params is None):
            raise ValueError("the checkpoint's EMA copy does not match the state's "
                             "training.ema_decay (0 means no EMA copy)")
        if ema is not None and set(ema) != set(state.ema_params):
            raise ValueError("the checkpoint's EMA copy names other parameters")
        state.model.load_state_dict(payload["model"])
        if ema is not None:
            for name, t in state.ema_params.items():
                t.copy_(ema[name])

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """The full training state of ``step`` (default: the latest) into
        ``state``, in place: parameters, statistics, optimizer with its
        count, EMA copy."""
        step = self.latest_step() if step is None else step
        payload = self._load(step)
        self._load_weights(state, payload)
        state.optimizer.adamw.load_state_dict(payload["optimizer"]["adamw"])
        state.optimizer.count = payload["optimizer"]["count"]
        return state

    def restore_weights(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Weights only (parameters, statistics, EMA copy) of ``step``
        (default: the best, else the latest) into ``state``, in place; the
        optimizer keeps its own state."""
        if step is None:
            step = self.best_step()
            step = self.latest_step() if step is None else step
        self._load_weights(state, self._load(step))
        return state
