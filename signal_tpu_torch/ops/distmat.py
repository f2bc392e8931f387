"""Pairwise distance matrices on the device (port of
`signal_tpu/ops/distmat.py`): one GEMM plus rank-1 row/col terms, in true
fp32 (TF32 would corrupt close rankings and the triplet mining)."""

from __future__ import annotations

import torch

from signal_tpu_torch.ops.attention import true_fp32


def euclidean_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance, [M, N], fp32 from a true-fp32 GEMM."""
    x, y = x.float(), y.float()
    xx = (x * x).sum(dim=1)[:, None]
    yy = (y * y).sum(dim=1)[None, :]
    with true_fp32():
        xy = x @ y.T
    return xx + yy - 2.0 * xy


def euclidean_distmat(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt of the squared distance clamped at the reference's 1e-12, as
    the triplet loss mines it."""
    return torch.sqrt(torch.clamp(euclidean_sqdist(x, y), min=1e-12))
