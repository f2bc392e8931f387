"""ResNet-50/101/152 with last stride 1 (port of
`signal_tpu/models/resnet.py`).

Torchvision's bottleneck trunk: a 7×7/2 stem and 3×3/2 max-pool, four
stages of bottlenecks (3×3 conv carrying the stride, a 1×1 projection
shortcut on each stage's first block), the last stage at stride 1 so the
final grid is /16. Convolutions take their operands in the compute dtype
with fp32 accumulation, and their output is rounded to it before the fp32
cast, as JAX's. BatchNorm runs in fp32 with running statistics as module
buffers: in training it normalises with the batch's biased variance and
moves the running statistics (momentum 0.1, the unbiased variance) in
place, ``F.batch_norm``'s convention and JAX's ``_bn_apply``. No block is
ever checkpointed: a recompute would move the running statistics twice.

The final feature map is the "patch token" grid for SIM / GAM / LAM
(tokens [B, H·W, 2048]); its global average is the CLS analogue.
Parameters carry torchvision's names (``conv1``, ``bn1``,
``layer{1-4}.{i}.conv{1-3}`` / ``bn{1-3}`` / ``downsample.{0,1}``), so
:func:`load_torchvision_resnet50` loads a torchvision checkpoint by name.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from signal_tpu_torch.models.lora import copy_plain_
from signal_tpu_torch.ops.attention import true_fp32

# depth (the spec's ``layers``) → bottlenecks per stage
RESNET_BLOCK_COUNTS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
EXPANSION = 4
WIDTHS = (64, 128, 256, 512)


class BatchNorm(nn.Module):
    """BatchNorm2d's parameters and running statistics (``weight``,
    ``bias``, ``running_mean``, ``running_var``) without
    ``num_batches_tracked``, which the JAX package does not carry; the
    forward is :func:`bn_apply`."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


def bn_apply(bn: BatchNorm, x: torch.Tensor, training: bool) -> torch.Tensor:
    """x [B, C, H, W] → fp32, statistics over (B, H, W); in training the
    running statistics move in place."""
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=training, momentum=0.1, eps=1e-5)


def conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, compute_dtype=torch.bfloat16,
         groups: int = 1) -> torch.Tensor:
    """SAME-padded conv (pad (k−1)/2), operands in the compute dtype, the
    output rounded to it, then fp32; an fp32 conv is a true-fp32 one."""
    pad = (weight.shape[-1] - 1) // 2
    guard = true_fp32() if compute_dtype == torch.float32 else contextlib.nullcontext()
    with guard:
        y = F.conv2d(x.to(compute_dtype), weight.to(compute_dtype), stride=stride,
                     padding=pad, groups=groups)
    return y.float()


def kaiming_(weight: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Kaiming-normal, fan out, relu: N(0, √(2/(k·k·cout)))."""
    cout, _, kh, kw = weight.shape
    return weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)), generator=gen)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = nn.Conv2d(width, width * EXPANSION, 1, bias=False)
        self.bn3 = BatchNorm(width * EXPANSION)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(nn.Conv2d(cin, width * EXPANSION, 1, bias=False),
                                            BatchNorm(width * EXPANSION))


class ResNet(nn.Module):
    """Parameters and BatchNorm statistics of the trunk
    (`init_resnet50_params`); the forward is :func:`resnet_forward`."""

    def __init__(self, block_counts: Tuple[int, ...] = RESNET_BLOCK_COUNTS[50]):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for si, (w, n) in enumerate(zip(WIDTHS, block_counts)):
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(cin, w, downsample=bi == 0))
                cin = w * EXPANSION
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Kaiming-normal (fan out) convs; BatchNorm ones and zeros, running
        mean 0 and variance 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_(m.weight, gen)
            elif isinstance(m, BatchNorm):
                for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                             (m.running_var, 1.0)):
                    t.fill_(v)


def _bottleneck(blk: Bottleneck, x: torch.Tensor, stride: int, training: bool,
                compute_dtype) -> torch.Tensor:
    h = F.relu(bn_apply(blk.bn1, conv(x, blk.conv1.weight, 1, compute_dtype), training))
    h = F.relu(bn_apply(blk.bn2, conv(h, blk.conv2.weight, stride, compute_dtype), training))
    h = bn_apply(blk.bn3, conv(h, blk.conv3.weight, 1, compute_dtype), training)
    if blk.downsample is not None:
        sc = bn_apply(blk.downsample[1],
                      conv(x, blk.downsample[0].weight, stride, compute_dtype), training)
    else:
        sc = x
    return F.relu(h + sc)


def resnet_forward(net: ResNet, images: torch.Tensor, *, training: bool = False,
                   compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, 3, H, W] → (tokens [B, (H/16)(W/16), 2048], pooled
    [B, 2048]), fp32. ``training`` normalises with the batch's statistics
    and moves the running ones in place."""
    x = F.relu(bn_apply(net.bn1, conv(images, net.conv1.weight, 2, compute_dtype), training))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for si in range(4):
        stride = 1 if si in (0, 3) else 2          # last stride 1
        for bi, blk in enumerate(getattr(net, f"layer{si + 1}")):
            x = _bottleneck(blk, x, stride if bi == 0 else 1, training, compute_dtype)
    B, C = x.shape[:2]
    return x.reshape(B, C, -1).transpose(1, 2), x.mean(dim=(2, 3))


def read_state_dict(path: str) -> dict:
    """A torchvision / torchreid ``.pth``: nested under ``state_dict`` or
    not, a DataParallel ``module.`` prefix dropped, fp32."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v.float() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def load_torchvision_resnet50(path: str, net: ResNet) -> ResNet:
    """Import a torchvision / timm ResNet ``.pth`` (any depth of the
    family) into ``net`` in place (`load_torchvision_resnet50`): every conv
    and BatchNorm of the trunk, its running statistics included, by
    torchvision's names; the classifier ``fc`` and the BatchNorms'
    ``num_batches_tracked`` are not read. → ``net``."""
    sd = read_state_dict(path)
    return copy_plain_(net, {k: sd[k] for k in net.state_dict()})
