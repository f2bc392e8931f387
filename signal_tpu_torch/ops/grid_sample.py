"""Bilinear grid sampling for LAM's DAS (port of
`signal_tpu/ops/grid_sample.py`).

The JAX package gathers the four corners by hand; here PyTorch's own
``F.grid_sample(mode='bilinear', padding_mode='zeros')`` computes the same
function, and its gradient with respect to the input and the grid
(`tests/test_torch_align.py` holds both to the JAX gather form).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_grid_sample(x: torch.Tensor, grid: torch.Tensor,
                         align_corners: bool = True) -> torch.Tensor:
    """x [B, C, H, W], grid [B, Hg, Wg, 2] in (x, y) order with coords in
    [-1, 1] → [B, C, Hg, Wg] in x's dtype; corners outside the map count
    as zero."""
    out = F.grid_sample(x.float(), grid.float(), mode="bilinear", padding_mode="zeros",
                        align_corners=align_corners)
    return out.to(x.dtype)
