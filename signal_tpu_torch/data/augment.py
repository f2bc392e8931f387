"""Device-side image ops (port of `signal_tpu/data/augment.py`).

``normalize_images`` runs torchvision's Normalize on the device for eval
and training. The train-time augmentation the reference runs in its loader
workers (RandomHorizontalFlip → Pad(10) + RandomCrop → RandomErasing
'pixel', `data/datasets/make_dataloader.py:186-194` in maxingan2412/Signal)
runs here on the device, batched, after Normalize (DATALOADER.DEVICE_AUGMENT):

* each op is split into *draws* (the random variates, from a
  ``torch.Generator`` on the batch's device) and *apply* (a pure function
  of the images and the draws), so a test can replay the JAX package's
  ``jax.random`` draws through the port's apply functions;
* each modality draws its own randomness (each torchvision call drew
  fresh randomness), modalities in sorted name order;
* the pad fill is pixel value 0 after Normalize, −mean/std;
* erasing draws 10 candidate geometries per sample and takes the first
  valid one (timm's rejection loop).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F


def normalize_images(imgs, mean: Sequence[float], std: Sequence[float]):
    """torchvision ``Normalize`` on the device: uint8 pixels → float32
    ``(x/255 − mean)/std``, as one multiply-add ``x·a + b`` per channel.
    Float inputs pass through untouched (already normalized on the host).

    Takes a packed [B, 3modal, 3ch, H, W] tensor (channel axis 2) or a
    {modality: [B, 3, H, W]} dict."""
    def affine(x: torch.Tensor, ch_axis: int) -> torch.Tensor:
        if x.dtype != torch.uint8:
            return x
        shape = [1] * x.dim()
        shape[ch_axis] = 3
        a = torch.tensor([1.0 / (255.0 * s) for s in std], dtype=torch.float32,
                         device=x.device).reshape(shape)
        b = torch.tensor([-m / s for m, s in zip(mean, std)], dtype=torch.float32,
                         device=x.device).reshape(shape)
        return x.float() * a + b

    if isinstance(imgs, dict):
        return {name: affine(x, 1) for name, x in imgs.items()}
    return affine(imgs, 2)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return torch.empty(shape, device=device).uniform_(lo, hi, generator=gen)


def flip_draws(gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """U[0, 1) per sample [B]."""
    return _uniform(gen, (batch,), 0.0, 1.0, device)


def apply_flip(x: torch.Tensor, u: torch.Tensor, prob: float) -> torch.Tensor:
    """Horizontal flip of the samples with u < prob. x [B, C, H, W]."""
    return torch.where((u < prob)[:, None, None, None], x.flip(-1), x)


def pad_crop_draws(gen: torch.Generator, batch: int, pad: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top, left) offsets into the padded image, uniform in [0, 2·pad]."""
    ty = torch.randint(0, 2 * pad + 1, (batch,), generator=gen, device=device)
    tx = torch.randint(0, 2 * pad + 1, (batch,), generator=gen, device=device)
    return ty, tx


def apply_pad_crop(x: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor, pad: int,
                   fill: torch.Tensor) -> torch.Tensor:
    """Pad by ``pad`` with ``fill`` (per channel), then crop the original
    size at (ty, tx) per sample. The fill is added back after a zero pad,
    as the JAX package does, so the values match it to the bit."""
    B, C, H, W = x.shape
    f = fill.to(x.device, x.dtype)[None, :, None, None]
    xp = F.pad(x - f, (pad, pad, pad, pad)) + f
    iy = ty[:, None] + torch.arange(H, device=x.device)          # [B, H]
    ix = tx[:, None] + torch.arange(W, device=x.device)          # [B, W]
    b = torch.arange(B, device=x.device)[:, None, None]
    out = xp.permute(0, 2, 3, 1)[b, iy[:, :, None], ix[:, None, :]]  # [B, H, W, C]
    return out.permute(0, 3, 1, 2).contiguous()


def erase_draws(gen: torch.Generator, shape, device, min_area: float = 0.02,
                max_area: float = 1 / 3, min_aspect: float = 0.3) -> Dict[str, torch.Tensor]:
    """The random variates of pixel-mode RandomErasing for a batch of
    ``shape`` [B, C, H, W]: 10 candidate area fractions and aspect ratios
    per sample, uniforms for top, left and the erase decision, and the
    N(0, 1) noise that fills the region."""
    B = shape[0]
    return {
        "area": _uniform(gen, (B, 10), min_area, max_area, device),
        "aspect": torch.exp(_uniform(gen, (B, 10), math.log(min_aspect),
                                     math.log(1.0 / min_aspect), device)),
        "u_top": _uniform(gen, (B,), 0.0, 1.0, device),
        "u_left": _uniform(gen, (B,), 0.0, 1.0, device),
        "u_do": _uniform(gen, (B,), 0.0, 1.0, device),
        "noise": torch.randn(shape, generator=gen, device=device),
    }


def apply_erase(x: torch.Tensor, d: Dict[str, torch.Tensor], prob: float) -> torch.Tensor:
    """Erase one rectangle per selected sample with the drawn noise: the
    first of the 10 candidate geometries with 0 < h < H and 0 < w < W, at
    a top/left uniform over the valid range."""
    B, C, H, W = x.shape
    target = d["area"] * float(H * W)
    hs = torch.round(torch.sqrt(target * d["aspect"])).to(torch.int32)
    ws = torch.round(torch.sqrt(target / d["aspect"])).to(torch.int32)
    valid = (hs < H) & (ws < W) & (hs > 0) & (ws > 0)
    pick = valid.int().argmax(dim=1, keepdim=True)               # first valid
    h = hs.gather(1, pick)[:, 0]
    w = ws.gather(1, pick)[:, 0]
    top = torch.floor(d["u_top"] * (H - h + 1).float()).to(torch.int32)
    left = torch.floor(d["u_left"] * (W - w + 1).float()).to(torch.int32)
    rows = torch.arange(H, device=x.device)[None, :]
    cols = torch.arange(W, device=x.device)[None, :]
    rmask = (rows >= top[:, None]) & (rows < (top + h)[:, None])
    cmask = (cols >= left[:, None]) & (cols < (left + w)[:, None])
    do = (d["u_do"] < prob) & valid.any(dim=1)
    region = rmask[:, None, :, None] & cmask[:, None, None, :] & do[:, None, None, None]
    return torch.where(region, d["noise"].to(x.dtype), x)


def augment_batch(gen: torch.Generator, imgs: Dict[str, torch.Tensor], *,
                  flip_prob: float = 0.5, re_prob: float = 0.5, padding: int = 10,
                  fill: Tuple[float, ...] = (-1.0, -1.0, -1.0)) -> Dict[str, torch.Tensor]:
    """{'RGB', 'NI', 'TI'}: [B, 3, H, W] normalized → same shapes with flip,
    pad + crop and erase applied, each modality with its own draws.
    ``fill`` = (0 − mean)/std per channel."""
    fill_t = torch.tensor(fill, dtype=torch.float32)
    out = {}
    for name, x in sorted(imgs.items()):
        B, dev = x.shape[0], x.device
        x = apply_flip(x, flip_draws(gen, B, dev), flip_prob)
        if padding > 0:
            x = apply_pad_crop(x, *pad_crop_draws(gen, B, padding, dev), padding, fill_t)
        if re_prob > 0:
            x = apply_erase(x, erase_draws(gen, x.shape, dev), re_prob)
        out[name] = x
    return out
