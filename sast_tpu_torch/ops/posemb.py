"""Sinusoidal 2D position embeddings (numpy).

The port's copy of ``sast_tpu/ops/posemb.py``: the reference's
``PositionEmbeddingSine`` (normalize=True, scale=2*pi), computed once per
stage as a constant.
"""

from __future__ import annotations

import numpy as np


def position_embedding_sine(
    height: int,
    width: int,
    num_pos_feats: int,
    temperature: float = 10000.0,
    scale: float = 2.0 * np.pi,
    dtype=np.float32,
) -> np.ndarray:
    """Returns (H, W, 2*num_pos_feats) sinusoidal embedding, channels = [y | x]."""
    y_embed = np.arange(1, height + 1, dtype=np.float64)[:, None] * np.ones((1, width))
    x_embed = np.ones((height, 1)) * np.arange(1, width + 1, dtype=np.float64)[None, :]
    eps = 1e-6
    y_embed = (y_embed - 0.5) / (y_embed[-1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    # Interleave sin on even indices, cos on odd indices.
    pos_x = np.stack((np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])), axis=3)
    pos_x = pos_x.reshape(height, width, -1)
    pos_y = np.stack((np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])), axis=3)
    pos_y = pos_y.reshape(height, width, -1)
    return np.concatenate((pos_y, pos_x), axis=2).astype(dtype)
