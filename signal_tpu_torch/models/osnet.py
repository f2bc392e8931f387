"""OSNet backbone (port of `signal_tpu/models/osnet.py`; Zhou et al.,
ICCV'19, torchreid's definition).

A 7×7/2 stem and 3×3/2 max-pool, three stages of two omni-scale blocks
(four branches of 1–4 lite 3×3 convs — a 1×1 then a depthwise 3×3 — fused
by ONE shared channel gate), a 1×1 conv + 2×2 average pool after stages 1
and 2, and a 1×1 conv head. The final grid is /16 at ``channels[3]``
features (512 for x1_0); its tokens and their global average are the
outputs, as ResNet's. Convolutions and BatchNorm follow
``models/resnet.py`` (compute-dtype operands, fp32 BatchNorm with running
statistics as buffers, never checkpointed); the gate's two 1×1 convs act
on the pooled vector in fp32.

Parameters carry torchreid's names (``conv1.conv`` / ``conv1.bn``,
``conv2.{0,1}`` blocks and ``conv2.2.0`` the transition, ``conv3`` the
same, ``conv4.{0,1}``, ``conv5``; a block's ``conv1``, ``conv2a``,
``conv2b.{0,1}``, ``conv2c.{0-2}``, ``conv2d.{0-3}`` (each ``conv1``,
``conv2``, ``bn``), ``gate.fc1`` / ``gate.fc2``, ``conv3``,
``downsample``), so :func:`load_torchreid_osnet` loads a torchreid
checkpoint by name.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from signal_tpu_torch.models.lora import copy_plain_
from signal_tpu_torch.models.resnet import BatchNorm, bn_apply, conv, kaiming_, read_state_dict
from signal_tpu_torch.ops.attention import true_fp32

# torchreid's factory channels (`osnet.py:522-580`); two blocks a stage
OSNET_VARIANTS = {
    "osnet_x1_0": (64, 256, 384, 512),
    "osnet_x0_75": (48, 192, 288, 384),
    "osnet_x0_5": (32, 128, 192, 256),
    "osnet_x0_25": (16, 64, 96, 128),
}
# the spec carries only feat_dim (= channels[3]); invert it
OSNET_BY_FEAT_DIM = {v[3]: v for v in OSNET_VARIANTS.values()}
OSNET_LAYERS = (2, 2, 2)
GATE_REDUCTION = 16


class ConvBN(nn.Module):
    """A conv without bias and its BatchNorm (torchreid's ConvLayer,
    Conv1x1, Conv1x1Linear)."""

    def __init__(self, cin: int, cout: int, k: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, bias=False)
        self.bn = BatchNorm(cout)


class LightConv3x3(nn.Module):
    """1×1 (no BatchNorm) then depthwise 3×3, then BatchNorm."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 1, bias=False)
        self.conv2 = nn.Conv2d(c, c, 3, bias=False, groups=c)
        self.bn = BatchNorm(c)


class ChannelGate(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc1 = nn.Conv2d(c, c // GATE_REDUCTION, 1)
        self.fc2 = nn.Conv2d(c // GATE_REDUCTION, c, 1)


class OSBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        mid = cout // 4
        self.conv1 = ConvBN(cin, mid)
        self.conv2a = LightConv3x3(mid)
        self.conv2b = nn.Sequential(*(LightConv3x3(mid) for _ in range(2)))
        self.conv2c = nn.Sequential(*(LightConv3x3(mid) for _ in range(3)))
        self.conv2d = nn.Sequential(*(LightConv3x3(mid) for _ in range(4)))
        self.gate = ChannelGate(mid)
        self.conv3 = ConvBN(mid, cout)
        self.downsample = ConvBN(cin, cout) if cin != cout else None

    def branches(self):
        """The four branches as lists of their lite convs, depth 1 to 4."""
        return [[self.conv2a], list(self.conv2b), list(self.conv2c), list(self.conv2d)]


class OSNet(nn.Module):
    """Parameters and BatchNorm statistics of the trunk
    (`init_osnet_params`); the forward is :func:`osnet_forward`."""

    def __init__(self, channels: Sequence[int] = OSNET_VARIANTS["osnet_x1_0"],
                 layers: Sequence[int] = OSNET_LAYERS):
        super().__init__()
        self.conv1 = ConvBN(3, channels[0], 7)
        cin = channels[0]
        for si, cout in enumerate(channels[1:]):
            stage = []
            for _ in range(layers[si]):
                stage.append(OSBlock(cin, cout))
                cin = cout
            if si < 2:   # the transition of stages 1-2 (`osnet.py:304-318`)
                stage.append(nn.Sequential(ConvBN(cout, cout)))
            setattr(self, f"conv{si + 2}", nn.Sequential(*stage))
        self.conv5 = ConvBN(channels[3], channels[3])

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Kaiming-normal (fan out) convs and gate kernels, zero gate
        biases; BatchNorm ones and zeros, running mean 0 and variance 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_(m.weight, gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                             (m.running_var, 1.0)):
                    t.fill_(v)


def _cbr(u: ConvBN, x, *, stride=1, relu=True, training, compute_dtype):
    h = bn_apply(u.bn, conv(x, u.conv.weight, stride, compute_dtype), training)
    return F.relu(h) if relu else h


def _gate(g: ChannelGate, x: torch.Tensor) -> torch.Tensor:
    """Shared channel gate, fp32: mean → fc1 → relu → fc2 → sigmoid → scale."""
    with true_fp32():
        h = F.relu(F.linear(x.mean(dim=(2, 3)), g.fc1.weight[:, :, 0, 0], g.fc1.bias))
        s = torch.sigmoid(F.linear(h, g.fc2.weight[:, :, 0, 0], g.fc2.bias))
    return x * s[:, :, None, None]


def _os_block(blk: OSBlock, x, *, training, compute_dtype):
    kw = dict(training=training, compute_dtype=compute_dtype)
    x1 = _cbr(blk.conv1, x, **kw)
    fused = None
    for lights in blk.branches():
        h = x1
        for lc in lights:
            h = conv(h, lc.conv1.weight, 1, compute_dtype)
            h = conv(h, lc.conv2.weight, 1, compute_dtype, groups=h.shape[1])
            h = F.relu(bn_apply(lc.bn, h, training))
        g = _gate(blk.gate, h)
        fused = g if fused is None else fused + g
    x3 = _cbr(blk.conv3, fused, relu=False, **kw)
    identity = x if blk.downsample is None else _cbr(blk.downsample, x, relu=False, **kw)
    return F.relu(x3 + identity)


def osnet_forward(net: OSNet, images: torch.Tensor, *, training: bool = False,
                  compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, 3, H, W] → (tokens [B, (H/16)(W/16), C3], pooled
    [B, C3]), fp32; ``training`` as ``resnet_forward``'s."""
    kw = dict(training=training, compute_dtype=compute_dtype)
    x = _cbr(net.conv1, images, stride=2, **kw)
    x = F.max_pool2d(x, 3, 2, padding=1)
    for si in (2, 3, 4):
        for m in getattr(net, f"conv{si}"):
            if isinstance(m, OSBlock):
                x = _os_block(m, x, **kw)
            else:   # the transition: 1×1 conv + BatchNorm + relu, 2×2 average
                x = F.avg_pool2d(_cbr(m[0], x, **kw), 2, 2)
    x = _cbr(net.conv5, x, **kw)
    B, C = x.shape[:2]
    return x.reshape(B, C, -1).transpose(1, 2), x.mean(dim=(2, 3))


def load_torchreid_osnet(path: str, net: OSNet) -> OSNet:
    """Import a torchreid OSNet ``.pth`` into ``net`` in place
    (`load_torchreid_osnet`): every conv, gate and BatchNorm of the trunk,
    running statistics included, by torchreid's names; its ``fc`` and
    ``classifier`` and the ``num_batches_tracked`` counters are not read.
    → ``net``."""
    sd = read_state_dict(path)
    return copy_plain_(net, {k: sd[k] for k in net.state_dict()})
