"""ImageNet-pretrained timm-style ViT tower, TransReID flavour (port of
`signal_tpu/models/vit_imagenet.py`).

  conv patch embed (stride may overlap; bias added in fp32) → [CLS] +
  pos-embed (+ SIE on ALL tokens) → N × pre-LN (MHA → +res → MLP(exact
  GELU) → +res, each branch through stochastic depth) → LayerNorm

LayerNorms use eps 1e-6 and there is no output projection (feature dim =
width). Variants (`MODEL.TRANSFORMER_TYPE`, the spec's widths):
vit_base / deit_base 768 × 12 layers × 12 heads, mlp 4; vit_small 768 × 8
× 8, mlp 3, qk scale 768^-0.5 (so its attention runs the eager core, as in
JAX); deit_small 384 × 12 × 6, mlp 4.

Parameters carry timm's / TransReID's names (``patch_embed.proj``,
``cls_token [1, 1, D]``, ``pos_embed [1, N, D]``, ``sie_embed [slots, 1,
D]``, ``blocks.{i}.norm1`` / ``.attn.qkv`` / ``.attn.proj`` / ``.norm2`` /
``.mlp.fc1`` / ``.mlp.fc2``, ``norm``), so :func:`load_timm_vit_params`
loads a timm checkpoint by name.

Stochastic depth: each layer's per-sample keep masks are drawn BEFORE the
blocks (:func:`drop_path_masks`) and passed in. A mask drawn inside a
checkpointed block would be drawn again, differently, in the recompute
(``torch.utils.checkpoint`` restores the default generator's state, not an
explicit ``torch.Generator``'s), and the gradient would be wrong. It also
lets a test hand in JAX's masks.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from signal_tpu_torch.models.lora import copy_plain_
from signal_tpu_torch.models.vit import resize_pos_embed
from signal_tpu_torch.ops.attention import (
    attention,
    layer_norm,
    linear,
    stored_weight,
    true_fp32,
    trunc_normal_,
)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, stride_size: int, width: int):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch_size, stride=stride_size)


class Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)


class Block(nn.Module):
    """A pre-LN block's parameters (the forward is :func:`block_forward`)."""

    def __init__(self, width: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = Attention(width)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = Mlp(width, int(width * mlp_ratio))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Trunc-normal σ 0.02 kernels, zero biases, unit LayerNorms."""
        for lin in (self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2):
            trunc_normal_(stored_weight(lin, "weight"), gen)
            lin.bias.zero_()
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()


def sie_slots(camera_num: int, view_num: int) -> int:
    """SIE table rows (`vit_pytorch.py:421-428`): cam·view when both axes
    are > 1, else whichever is > 1, else none."""
    if camera_num > 1 and view_num > 1:
        return camera_num * view_num
    if camera_num > 1 or view_num > 1:
        return max(camera_num, view_num)
    return 0


class ImageNetViT(nn.Module):
    """Parameters of the tower (`init_imagenet_vit_params`); the forward is
    :func:`imagenet_vit_forward`."""

    def __init__(self, *, img_size: Tuple[int, int], patch_size: int = 16,
                 stride_size: int = 16, width: int = 768, layers: int = 12,
                 camera_num: int = 0, view_num: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        num_y = (img_size[0] - patch_size) // stride_size + 1
        num_x = (img_size[1] - patch_size) // stride_size + 1
        self.patch_embed = PatchEmbed(patch_size, stride_size, width)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_y * num_x + 1, width))
        slots = sie_slots(camera_num, view_num)
        self.sie_embed = nn.Parameter(torch.zeros(slots, 1, width)) if slots else None
        self.blocks = nn.ModuleList(Block(width, mlp_ratio) for _ in range(layers))
        self.norm = nn.LayerNorm(width, eps=1e-6)

    def lora_paths(self):
        """The kernels MODEL.FROZEN adapts (``models/lora.py``)."""
        for i in range(len(self.blocks)):
            for path in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
                yield f"blocks.{i}.{path}.weight"

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """`init_imagenet_vit_params`' distributions: the conv N(0,
        √(2/(k²·width))) with a zero bias, trunc-normal σ 0.02 tokens,
        pos embed, SIE and kernels."""
        conv = self.patch_embed.proj
        k, width = conv.kernel_size[0], conv.out_channels
        conv.weight.normal_(0.0, math.sqrt(2.0 / (k * k * width)), generator=gen)
        conv.bias.zero_()
        trunc_normal_(self.cls_token, gen)
        trunc_normal_(self.pos_embed, gen)
        if self.sie_embed is not None:
            trunc_normal_(self.sie_embed, gen)
        for blk in self.blocks:
            blk.reset_parameters(gen)
        self.norm.reset_parameters()


def drop_path_rates(n_layers: int, rate: float) -> List[float]:
    """timm's stochastic-depth decay: layer i drops at i/(L−1) · rate."""
    return [rate * i / max(n_layers - 1, 1) for i in range(n_layers)]


def drop_path_masks(gen: torch.Generator, n_layers: int, rate: float, rows: int,
                    device) -> List[Optional[torch.Tensor]]:
    """Each layer's per-row keep masks, drawn from ``gen`` in one call: a
    bool [2, rows] (the attention branch, then the MLP branch) per layer,
    None where the layer's rate is 0."""
    u = torch.rand(n_layers, 2, rows, generator=gen, device=device)
    return [None if r == 0.0 else u[i] < 1.0 - r
            for i, r in enumerate(drop_path_rates(n_layers, rate))]


def _drop_path(h: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Stochastic depth (`vit_pytorch.py:48-65`): a dropped row is zero,
    a kept one scaled by 1/keep. Identity without a mask."""
    if mask is None:
        return h
    return h * mask.to(h.dtype)[:, None, None] / (1.0 - rate)


def block_forward(blk: Block, x: torch.Tensor, masks: Optional[torch.Tensor] = None,
                  rate: float = 0.0, *, num_heads: int, compute_dtype,
                  use_flash: bool = False, qk_scale=None) -> torch.Tensor:
    """One block on the fp32 residual stream: x + dp(attn(norm1 x)), then
    + dp(fc2(gelu(fc1(norm2 x)))). ``masks`` [2, rows] and ``rate`` are the
    layer's stochastic depth."""
    a = blk.attn
    h = attention(a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias,
                  layer_norm(blk.norm1, x, eps=blk.norm1.eps), num_heads=num_heads,
                  compute_dtype=compute_dtype, use_flash=use_flash, scale=qk_scale)
    x = x + _drop_path(h, None if masks is None else masks[0], rate)
    h = layer_norm(blk.norm2, x, eps=blk.norm2.eps)
    h = F.gelu(linear(blk.mlp.fc1.weight, blk.mlp.fc1.bias, h, compute_dtype))
    h = linear(blk.mlp.fc2.weight, blk.mlp.fc2.bias, h, compute_dtype)
    return x + _drop_path(h, None if masks is None else masks[1], rate)


def run_blocks(blocks: Sequence[Block], x: torch.Tensor, *, remat: bool = False,
               masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
               drop_path_rate: float = 0.0, **kw) -> torch.Tensor:
    """The blocks in order; under ``remat`` (and grad mode) each is a
    ``torch.utils.checkpoint`` segment, the JAX tower's per-block
    ``jax.checkpoint``. The masks enter each segment as inputs, so its
    recompute uses the same ones."""
    rates = drop_path_rates(len(blocks), drop_path_rate)
    checkpointed = remat and torch.is_grad_enabled()
    for i, blk in enumerate(blocks):
        fn = functools.partial(block_forward, blk, rate=rates[i], **kw)
        m = None if masks is None else masks[i]
        if checkpointed:
            x = torch.utils.checkpoint.checkpoint(fn, x, m, use_reentrant=False)
        else:
            x = fn(x, m)
    return x


def sie_index(cam_label, view_label, camera_num: int, view_num: int):
    """The SIE row of each sample (`vit_pytorch.py:422-428`), or None."""
    if camera_num > 1 and view_num > 1 and cam_label is not None and view_label is not None:
        return cam_label * view_num + view_label
    if camera_num > 1 and cam_label is not None:
        return cam_label
    if view_num > 1 and view_label is not None:
        return view_label
    return None


def imagenet_vit_forward(vit: ImageNetViT, images: torch.Tensor, cam_label=None,
                         view_label=None, *, camera_num: int = 0, view_num: int = 0,
                         sie_xishu: float = 1.0, num_heads: int = 12, stride_size: int = 16,
                         drop_path_rate: float = 0.0,
                         drop_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
                         compute_dtype=torch.bfloat16, use_flash: bool = False,
                         qk_scale=None, remat: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, 3, H, W] → (patch tokens [B, L, width], cls [B, width]),
    fp32. ``drop_masks``: :func:`drop_path_masks` of ``drop_path_rate``
    for the B rows (training), or None (no stochastic depth). The blocks'
    attention takes the kernel when ``use_flash`` and no ``qk_scale``."""
    B = images.shape[0]
    conv = vit.patch_embed.proj
    # compute-dtype conv in and out, rounded before the fp32 cast; the bias
    # is added in fp32
    guard = true_fp32() if compute_dtype == torch.float32 else contextlib.nullcontext()
    with guard:
        x = F.conv2d(images.to(compute_dtype), conv.weight.to(compute_dtype),
                     stride=stride_size)
    x = x.float() + conv.bias.float()[None, :, None, None]
    width = x.shape[1]
    x = x.reshape(B, width, -1).transpose(1, 2)
    x = torch.cat([vit.cls_token.float().expand(B, 1, width), x], dim=1)
    x = x + vit.pos_embed.float()
    if vit.sie_embed is not None:
        idx = sie_index(cam_label, view_label, camera_num, view_num)
        if idx is not None:
            x = x + sie_xishu * vit.sie_embed[idx].float()
    x = run_blocks(vit.blocks, x, remat=remat, masks=drop_masks,
                   drop_path_rate=drop_path_rate, num_heads=num_heads,
                   compute_dtype=compute_dtype, use_flash=use_flash, qk_scale=qk_scale)
    x = layer_norm(vit.norm, x, eps=vit.norm.eps)
    return x[:, 1:], x[:, 0]


_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
               "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


def load_timm_vit_params(path: str, vit: ImageNetViT, num_y: int, num_x: int) -> ImageNetViT:
    """Import a timm / TransReID ``.pth`` into ``vit`` in place
    (`load_timm_vit_params`, `Trans.load_param`): the state dict is taken
    from under ``model`` or ``state_dict`` where nested; the patch embed,
    tokens, final norm and pos embed load where the file has them; every
    block's tensors must be there. The pos embed drops DeiT's distillation
    token when ``path`` says "distilled" and is resized from its square
    grid to num_y × num_x. The SIE table is not in a timm file and stays.
    → ``vit``."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    sd = {k: v.float() for k, v in sd.items() if isinstance(v, torch.Tensor)}
    src = {}
    for weight, bias in (("patch_embed.proj.weight", "patch_embed.proj.bias"),
                         ("norm.weight", "norm.bias")):
        if weight in sd:
            src[weight], src[bias] = sd[weight], sd[bias]
    if "cls_token" in sd:
        src["cls_token"] = sd["cls_token"].reshape(vit.cls_token.shape)
    if "pos_embed" in sd:
        pos = sd["pos_embed"][0]
        if "distilled" in path:
            pos = torch.cat([pos[:1], pos[2:]], dim=0)
        src["pos_embed"] = resize_pos_embed(pos, num_y, num_x)[None]
    for i in range(len(vit.blocks)):
        for name in _BLOCK_KEYS:
            src[f"blocks.{i}.{name}"] = sd[f"blocks.{i}.{name}"]
    return copy_plain_(vit, src)
