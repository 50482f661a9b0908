"""Name-based module registry (the port's counterpart of
sast_tpu/registry.py): resolve the task and data modules from config names,
so user code can stay name-driven."""

from __future__ import annotations

from sast_tpu_torch.config import ExperimentConfig


def fetch_model_module(cfg: ExperimentConfig, workdir: str = "runs/default", **kw):
    """'rnndet' -> Trainer (the task module)."""
    name = cfg.model.name
    if name == "rnndet":
        from sast_tpu_torch.training.loop import Trainer

        return Trainer(cfg, workdir=workdir, **kw)
    raise NotImplementedError(f"unknown model module {name!r}")


def fetch_data_module(cfg: ExperimentConfig, rank: int = 0, world_size: int = 1):
    """'gen1' | 'gen4' -> DataModule."""
    name = cfg.dataset.name
    if name in ("gen1", "gen4"):
        from sast_tpu_torch.data.module import DataModule

        return DataModule(cfg, rank=rank, world_size=world_size)
    raise NotImplementedError(f"unknown dataset {name!r}")


def build_detector(cfg: ExperimentConfig, sparse_kernel: bool = False, device="cuda", seed: int = 0):
    """Bare detector with seeded random weights on ``device``, for library
    users (``sparse_kernel`` is the JAX package's ``use_pallas``); the
    backbone by ``cfg.model.backbone.name``, ``SASTRNN`` or ``MaxViTRNN``."""
    from sast_tpu_torch.models.detector import build_detector as build

    return build(cfg.model, seed=seed, device=device, sparse_kernel=sparse_kernel)
