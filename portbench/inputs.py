"""What the benchmark makes from ``--seed`` and hands to both sides: the
model's weights and the pool of packed uint8 batches with their labels.

Weights are drawn on the device in one call from a ``torch.Generator``
there and cut into the reference state dict's tensors, float32 as the
port keeps them: LayerNorm and BNNeck scales 1 and their shifts 0, the
running statistics 0 and 1, GAM's temperature 0.07, the tower's class and
position embeddings and output projection N(0, width^-1/2), the camera
table N(0, 0.02), the classifiers N(0, 0.001), every other bias
N(0, 0.02), and every other weight N(0, 1/(3·fan_in)) (the variance of
PyTorch's default uniform). The images are uniform uint8 triplets, made
on the device and kept in pinned host memory, as a loader hands them
over.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.model import param_shapes
from portbench.spec import subseed


def _std(name: str, shape, arch: dict):
    """None: a constant (see :func:`_constant`); else the normal's σ."""
    if name.endswith(("class_embedding", "positional_embedding", "base.proj")):
        return arch["width"] ** -0.5
    if name.endswith("cv_embed"):
        return 0.02
    if name.startswith("classifier"):
        return 0.001
    if len(shape) == 1 and name.endswith("bias") and not _norm_or_neck(name):
        return 0.02
    if len(shape) >= 2:
        return (3.0 * int(np.prod(shape[1:]))) ** -0.5
    return None


def _norm_or_neck(name: str) -> bool:
    return any(k in name for k in ("ln_", "norm", "bottleneck"))


def _constant(name: str) -> float:
    if name.endswith("contra_temp"):
        return 0.07
    if name.endswith(("running_var", ".weight")):
        return 1.0
    return 0.0


def make_weights(arch: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights for ``seed``: one normal draw on ``device``,
    sliced and scaled (the same seed gives the same tensors)."""
    shapes = param_shapes(arch)
    sizes = [int(np.prod(s)) if s else 1 for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        t = flat[at:at + n].view(shape)
        at += n
        std = _std(name, shape, arch)
        if std is None:
            t.fill_(_constant(name))
        else:
            t.mul_(std)
        out[name] = t
    return out


def make_pool(arch: dict, batch: int, pool: int, seed: int, device, *, num_instance: int = 0
              ) -> List[dict]:
    """``pool`` batches as a loader yields them: {'packed': uint8
    [B, 3, 3, H, W] (a view of pinned host memory), 'pids', 'camids'} (numpy
    int64). With ``num_instance`` K the labels are P×K: B/K identities
    drawn without repeats, K rows each; else any identity a row."""
    H, W = arch["img_h"], arch["img_w"]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "images"))
    host = torch.empty((pool, batch, 3, 3, H, W), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    for i in range(pool):
        host[i].copy_(torch.randint(0, 256, (batch, 3, 3, H, W), dtype=torch.uint8,
                                    device=device, generator=gen))
    labels = torch.Generator().manual_seed(subseed(seed, "labels"))
    C, cams = arch["num_classes"], arch["camera_num"]
    out = []
    for i in range(pool):
        if num_instance:
            ids = torch.randperm(C, generator=labels)[:batch // num_instance]
            pids = ids.repeat_interleave(num_instance)
        else:
            pids = torch.randint(0, C, (batch,), generator=labels)
        camids = torch.randint(0, cams, (batch,), generator=labels)
        out.append({"packed": host[i].numpy(), "pids": pids.numpy(), "camids": camids.numpy()})
    return out
