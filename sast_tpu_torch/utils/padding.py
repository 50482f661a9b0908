"""Input padding to the model resolution (port of sast_tpu/utils/padding.py).

Bottom/right zero padding of the NHWC event representation to the model
(H, W), plus the stride-4 token mask of the padded region.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


class InputPadder:
    def __init__(self, desired_hw: Tuple[int, int]):
        if desired_hw[0] % 4 or desired_hw[1] % 4:
            raise ValueError(f"model resolution {desired_hw} must divide by 4")
        self.desired_hw = tuple(desired_hw)

    def pad_tensor_ev_repr(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., H, W, C) NHWC -> zero-pad bottom/right to desired (H, W)."""
        ht, wt = self.desired_hw
        h, w = x.shape[-3], x.shape[-2]
        if ht < h or wt < w:
            raise ValueError(f"input {tuple(x.shape)} exceeds {self.desired_hw}")
        if (h, w) == (ht, wt):
            return x
        return F.pad(x, (0, 0, 0, wt - w, 0, ht - h))

    def pad_token_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """mask: (..., H/4, W/4) bool -> pad with True (padded area is masked)."""
        ht, wt = self.desired_hw[0] // 4, self.desired_hw[1] // 4
        h, w = mask.shape[-2], mask.shape[-1]
        if ht < h or wt < w:
            raise ValueError(f"mask {tuple(mask.shape)} exceeds {(ht, wt)}")
        return F.pad(mask, (0, wt - w, 0, ht - h), value=True)


def padding_token_mask(
    data_hw: Tuple[int, int], desired_hw: Tuple[int, int], device=None
) -> Optional[torch.Tensor]:
    """Stride-4 token mask for the static bottom/right input padding.

    True marks tokens that lie entirely inside the zero-padded region; the
    backbone's stage-0 mask-token path replaces their embeddings with the
    learned mask token. Returns None when there is no padding.
    Shape: (1, H/4, W/4), broadcastable over the batch.
    """
    (h, w), (ht, wt) = data_hw, desired_hw
    if ht < h or wt < w:
        raise ValueError(f"data {data_hw} exceeds model resolution {desired_hw}")
    if (h, w) == (ht, wt):
        return None
    # Tokens partially covering real data stay unmasked.
    h4_real = -(-h // 4)
    w4_real = -(-w // 4)
    mask = torch.ones((1, ht // 4, wt // 4), dtype=torch.bool, device=device)
    mask[:, :h4_real, :w4_real] = False
    return mask
