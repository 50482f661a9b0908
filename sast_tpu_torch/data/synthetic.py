"""Synthetic batches for smoke runs and benchmarks (the port's own copy of
sast_tpu/data/synthetic.py; numpy only).

Batches have the layout ``training/steps.py`` consumes, with event inputs
whose zero fraction is set by ``sparsity`` (a random tensor thresholded so
that the chosen fraction of cells is zero). The same ``RandomState`` gives
the same batch as the JAX package's generator.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sast_tpu_torch.config import ExperimentConfig


def sparse_event_input(rng: np.random.RandomState, shape, sparsity: float = 0.9,
                       max_count: int = 10) -> np.ndarray:
    """Random event-histogram-like uint8 input with the given zero fraction."""
    u = rng.random_sample(shape).astype(np.float32)
    counts = (u * max_count).astype(np.uint8) + 1
    return np.where(u >= sparsity, counts, 0).astype(np.uint8)


def synthetic_train_batch(cfg: ExperimentConfig, rng: np.random.RandomState,
                          batch_size: int = None, seq_len: int = None,
                          sparsity: float = 0.9) -> Dict[str, np.ndarray]:
    B = batch_size or cfg.training.batch_size_train
    T = seq_len or cfg.dataset.sequence_length
    H, W = cfg.model.backbone.in_res_hw
    C = cfg.model.backbone.input_channels
    L = cfg.training.max_labeled_frames_per_lane
    G = cfg.model.head.max_gt

    ev = sparse_event_input(rng, (T, B, H, W, C), sparsity).reshape(T, B, H, W * C)

    # Labeled frames: L distinct timesteps per lane at most, sorted.
    frame_tidx = np.zeros((B, L), np.int32)
    frame_valid = np.zeros((B, L), bool)
    for b in range(B):
        n = rng.randint(1, L + 1)
        ts = np.sort(rng.choice(T, size=min(n, T), replace=False))
        frame_tidx[b, : len(ts)] = ts
        frame_valid[b, : len(ts)] = True

    gt_boxes = np.zeros((B, L, G, 4), np.float32)
    gt_classes = np.zeros((B, L, G), np.int32)
    gt_valid = np.zeros((B, L, G), bool)
    n_cls = cfg.model.head.num_classes
    for b in range(B):
        for l in range(L):
            if not frame_valid[b, l]:
                continue
            n = rng.randint(1, min(6, G) + 1)
            w = rng.uniform(12, W / 3, n)
            h = rng.uniform(12, H / 3, n)
            cx = rng.uniform(w / 2, W - w / 2)
            cy = rng.uniform(h / 2, H - h / 2)
            gt_boxes[b, l, :n] = np.stack([cx, cy, w, h], axis=-1)
            gt_classes[b, l, :n] = rng.randint(0, n_cls, n)
            gt_valid[b, l, :n] = True

    return {
        "ev_repr": ev,
        "frame_tidx": frame_tidx,
        "frame_valid": frame_valid,
        "gt_boxes": gt_boxes,
        "gt_classes": gt_classes,
        "gt_valid": gt_valid,
        "is_first": np.ones((B,), bool),
    }
