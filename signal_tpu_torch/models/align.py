"""GAM + LAM alignment losses (port of `signal_tpu/models/align.py`, the
reference's `AlignmentM`, `modeling/AddModule/useB.py` and `DAS.py` in
maxingan2412/Signal).

* GAM: mean-pool the patches → L2-normalize → pairwise 3×3 Gram-determinant
  volume V [B, B] → symmetric label-smoothed CE on −V/τ, with a learnable
  temperature (init 0.07). fp32 throughout.
* LAM: tokens → [B, D, H, W] grids; three per-modality DAS modules predict
  ONE offset channel that is broadcast to (dy, dx) through the per-axis
  range factors (the reference's [1, 2, 1, 1] reshape), added to reference
  points that exceed ±1 before the clamp, then bilinear-sampled; the loss
  is the mean pairwise MSE of the three sampled maps.

The convolutions run in true fp32 (the offsets feed coordinate
arithmetic); GELU is the exact (erf) form.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from signal_tpu_torch.ops.attention import true_fp32
from signal_tpu_torch.ops.grid_sample import bilinear_grid_sample
from signal_tpu_torch.ops.volume import gram_volume3


DAS_STRIDE = 4   # the depthwise offset conv's kernel and stride


class DAS(nn.Module):
    """Deformable offset sampler's parameters: 1×1 query projection; offset
    net 1×1 conv → GELU → depthwise 4×4/4 conv → GELU → 1×1 conv to one
    channel (no bias)."""

    def __init__(self, c: int):
        super().__init__()
        self.proj_q = nn.Conv2d(c, c, 1)
        self.conv_offset = nn.Sequential(
            nn.Conv2d(c, c, 1), nn.GELU(),
            nn.Conv2d(c, c, DAS_STRIDE, stride=DAS_STRIDE, groups=c), nn.GELU(),
            nn.Conv2d(c, 1, 1, bias=False))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """`init_das_params`: weights U(±1/√fan_in) (torch's default bound),
        biases ZERO (torch's default would draw them)."""
        for conv in (self.proj_q, self.conv_offset[0], self.conv_offset[2], self.conv_offset[4]):
            fan_in = conv.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            conv.weight.uniform_(-bound, bound, generator=gen)
            if conv.bias is not None:
                conv.bias.zero_()


class AlignM(nn.Module):
    """GAM/LAM parameters."""

    def __init__(self, feat_dim: int):
        super().__init__()
        self.contra_temp = nn.Parameter(torch.tensor(0.07))
        self.DAS_r, self.DAS_n, self.DAS_t = DAS(feat_dim), DAS(feat_dim), DAS(feat_dim)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.contra_temp.fill_(0.07)
        for das in (self.DAS_r, self.DAS_n, self.DAS_t):
            das.reset_parameters(gen)


def das_reference_points(hk: int, wk: int, device=None) -> torch.Tensor:
    """[hk, wk, 2] (y, x) reference points, the reference's normalization:
    centers (0.5 … n − 0.5) over (n − 1), so the far corners exceed +1 and
    are clamped after the offset add."""
    ys = (torch.arange(hk, dtype=torch.float32, device=device) + 0.5) / max(hk - 1.0, 1.0) * 2.0 - 1.0
    xs = (torch.arange(wk, dtype=torch.float32, device=device) + 0.5) / max(wk - 1.0, 1.0) * 2.0 - 1.0
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)


def das_sample_positions(das: DAS, x32: torch.Tensor) -> torch.Tensor:
    """Offset half of DAS: x [B, C, H, W] fp32 → clamped sample positions
    [B, H/4, W/4, 2] in (y, x) normalized coords. The offset is
    tanh(net(x)) · (1/(Hk−1), 1/(Wk−1)) · 2, the reference's range factor."""
    _, C, H, W = x32.shape
    if H < DAS_STRIDE or W < DAS_STRIDE:
        raise ValueError(
            f"DAS needs a patch grid of at least {DAS_STRIDE}x{DAS_STRIDE}, got "
            f"{H}x{W}; the Signal configs use 16x8 (256x128 images)")
    conv1, dw, out = das.conv_offset[0], das.conv_offset[2], das.conv_offset[4]
    with true_fp32():
        q = F.conv2d(x32, das.proj_q.weight, das.proj_q.bias)
        h = F.gelu(F.conv2d(q, conv1.weight, conv1.bias), approximate="none")
        h = F.gelu(F.conv2d(h, dw.weight, dw.bias, stride=DAS_STRIDE, groups=C),
                   approximate="none")
        offset = F.conv2d(h, out.weight)                          # [B, 1, Hk, Wk]
    hk, wk = offset.shape[2], offset.shape[3]
    rng = torch.tensor([1.0 / max(hk - 1.0, 1.0), 1.0 / max(wk - 1.0, 1.0)],
                       dtype=torch.float32, device=x32.device)
    offset = torch.tanh(offset) * rng[None, :, None, None] * 2.0
    offset = offset.permute(0, 2, 3, 1)                           # [B, Hk, Wk, 2] (dy, dx)
    return torch.clamp(offset + das_reference_points(hk, wk, x32.device)[None], -1.0, 1.0)


def das_forward(das: DAS, x: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] → sampled [B, C, H/4, W/4]."""
    x32 = x.float()
    pos = das_sample_positions(das, x32)
    return bilinear_grid_sample(x32, pos.flip(-1), align_corners=True).to(x.dtype)


def _smooth_ce(logits: torch.Tensor, smoothing: float = 0.1) -> torch.Tensor:
    """CE against the diagonal with label smoothing: (1 − ε) on the
    diagonal plus ε/N everywhere."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -(1.0 - smoothing) * logp.diagonal() - smoothing * logp.mean(dim=-1)
    return loss.mean()


def gam_loss(patches: torch.Tensor, contra_temp: torch.Tensor) -> torch.Tensor:
    """patches [B, 3, L, D] (RGB, NI, TI) → scalar GAM loss (fp32)."""
    feats = patches.float().mean(dim=2)                           # [B, 3, D]
    feats = feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-12)
    v = gram_volume3(feats[:, 0], feats[:, 1], feats[:, 2]) / contra_temp
    return 0.5 * (_smooth_ce(-v) + _smooth_ce(-v.T))


def lam_loss(align: AlignM, patches: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """patches [B, 3, L, D] → scalar LAM loss. h·w must equal L."""
    B, M, L, D = patches.shape
    grids = patches.float().reshape(B, M, h, w, D).permute(0, 1, 4, 2, 3)
    r = das_forward(align.DAS_r, grids[:, 0])
    n = das_forward(align.DAS_n, grids[:, 1])
    t = das_forward(align.DAS_t, grids[:, 2])
    mse = lambda a, b: ((a - b) ** 2).mean()  # noqa: E731
    return (mse(n, r) + mse(t, r) + mse(t, n)) / 3.0


def align_forward(align: AlignM, patches: torch.Tensor, *, h: int, w: int,
                  stage: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """stage 'CLS' → (gam, None); 'together_CLS_Patch' → (gam, lam)."""
    gam = gam_loss(patches, align.contra_temp)
    if stage == "CLS":
        return gam, None
    return gam, lam_loss(align, patches, h, w)
