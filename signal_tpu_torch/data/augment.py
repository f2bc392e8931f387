"""Device-side image ops (port of `signal_tpu/data/augment.py`).

Only ``normalize_images`` is on the eval path; the train-time flip /
pad-crop / erase come with the train slice (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from typing import Sequence

import torch


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
