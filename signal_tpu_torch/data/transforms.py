"""Image transforms: numpy/PIL host-side, matching the reference pipeline
(the port's own copy of `signal_tpu/data/transforms.py`).

Train (`data/datasets/make_dataloader.py:186-194` in maxingan2412/Signal):
  Resize(bicubic) → RandomHorizontalFlip(p) → Pad(10) → RandomCrop →
  ToTensor → Normalize(.5,.5,.5) → RandomErasing(mode='pixel', max_count=1)
Val (`make_dataloader.py:196-200`): Resize(bilinear) → ToTensor → Normalize.

The flip/crop/erase random draws follow torchvision's *semantics* (not its
bit-exact RNG): per-sample decisions from a seeded numpy Generator, the
same random-erasing geometry distribution (`make_dataloader.py:100-122`,
timm's pixel-mode variant).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
from PIL import Image


def resize(img: Image.Image, size: Tuple[int, int], interpolation=Image.BICUBIC) -> Image.Image:
    h, w = size
    return img.resize((w, h), interpolation)


def to_normalized_array(img: Image.Image, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """→ [3, H, W] float32, ((x/255) − mean) / std."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr.transpose(2, 0, 1)


def random_erasing_pixel(
    arr: np.ndarray,
    rng: np.random.Generator,
    probability: float = 0.5,
    min_area: float = 0.02,
    max_area: float = 1 / 3,
    min_aspect: float = 0.3,
) -> np.ndarray:
    """timm 'pixel'-mode RandomErasing on a normalized [3, H, W] array."""
    if rng.random() > probability:
        return arr
    _, img_h, img_w = arr.shape
    area = img_h * img_w
    log_aspect = (math.log(min_aspect), math.log(1 / min_aspect))
    for _ in range(10):
        target_area = rng.uniform(min_area, max_area) * area
        aspect = math.exp(rng.uniform(*log_aspect))
        h = int(round(math.sqrt(target_area * aspect)))
        w = int(round(math.sqrt(target_area / aspect)))
        if w < img_w and h < img_h:
            top = rng.integers(0, img_h - h, endpoint=True)
            left = rng.integers(0, img_w - w, endpoint=True)
            arr[:, top:top + h, left:left + w] = rng.standard_normal(
                (3, h, w)).astype(arr.dtype)
            break
    return arr


class TrainTransform:
    def __init__(self, size: Tuple[int, int], prob: float, re_prob: float,
                 padding: int, mean, std):
        self.size = tuple(size)
        self.prob = prob
        self.re_prob = re_prob
        self.padding = padding
        self.mean, self.std = mean, std

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> np.ndarray:
        img = resize(img, self.size, Image.BICUBIC)
        if rng.random() < self.prob:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        h, w = self.size
        # Pad(10) + RandomCrop(size)
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        p = self.padding
        padded = np.zeros((h + 2 * p, w + 2 * p, 3), arr.dtype)
        padded[p:p + h, p:p + w] = arr
        top = int(rng.integers(0, 2 * p, endpoint=True))
        left = int(rng.integers(0, 2 * p, endpoint=True))
        arr = padded[top:top + h, left:left + w]
        out = (arr.astype(np.float32) / 255.0 - np.asarray(self.mean, np.float32)) \
            / np.asarray(self.std, np.float32)
        out = out.transpose(2, 0, 1)
        return random_erasing_pixel(out, rng, self.re_prob)


class ValTransform:
    # the native decoder's filter matching this transform's resize
    native_filter = "bilinear"

    def __init__(self, size: Tuple[int, int], mean, std):
        self.size = tuple(size)
        self.mean, self.std = mean, std

    def __call__(self, img: Image.Image, rng=None) -> np.ndarray:
        # torchvision Resize default interpolation is bilinear (val path)
        img = resize(img, self.size, Image.BILINEAR)
        return to_normalized_array(img, self.mean, self.std)

    def raw_u8(self, img: Image.Image) -> np.ndarray:
        """→ [3, H, W] uint8: resize only; Normalize runs on device
        (`signal_tpu_torch.data.augment.normalize_images`)."""
        img = resize(img, self.size, Image.BILINEAR)
        arr = np.asarray(img, dtype=np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return arr.transpose(2, 0, 1)


class RawTrainDecode:
    """Decode-only train transform: bicubic resize + normalize, NO
    flip/crop/erase — those run on the device in the train step. The
    native decoder takes whole jpg batches on this path (filter
    'bicubic'); ``__call__`` serves the PIL path."""

    native_filter = "bicubic"

    def __init__(self, size: Tuple[int, int], mean, std):
        self.size = tuple(size)
        self.mean, self.std = mean, std

    def __call__(self, img: Image.Image, rng=None) -> np.ndarray:
        img = resize(img, self.size, Image.BICUBIC)
        return to_normalized_array(img, self.mean, self.std)

    def raw_u8(self, img: Image.Image) -> np.ndarray:
        """Resize-only uint8 (see ValTransform.raw_u8); bicubic to match
        the reference train resize."""
        img = resize(img, self.size, Image.BICUBIC)
        arr = np.asarray(img, dtype=np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return arr.transpose(2, 0, 1)
