"""T2T-ViT backbone, the 'transformer' token type (port of
`signal_tpu/models/t2t.py`; the reference's `modeling/backbones/t2t.py`
and `token_transformer.py`).

Two soft splits (``F.unfold``), each followed by a single-head token
transformer (with the v-skip ``x = v + o`` and the attention scale of the
INPUT dim, the reference's quirks), a third soft split and a linear
projection to the embed dim, then a [CLS] token, the fixed sinusoid
positional table, SIE on all tokens and standard pre-LN blocks
(``models/vit_imagenet.block_forward``, no stochastic depth; under
MODEL.USE_PALLAS_ATTENTION the blocks' attention takes the kernels, as
the ImageNet tower's does). The two token transformers run in fp32
whatever MODEL.COMPUTE_DTYPE, as JAX's ``t2t_forward`` calls them, their
attention through the registered ``signal_tpu_torch::token_attention``
(``ops/token_attention.py``). The tokens-to-token module is the span
``model.t2t``. MODEL.TRANSFORMER_TYPE t2t_vit_t_14 and t2t_vit_t_24: embed
384, depth 14 / 24, 6 heads, mlp ratio 3.

Parameters carry the reference's names (``tokens_to_token.attention{1,2}``
with ``norm1``, ``attn.qkv`` (no bias), ``attn.proj``, ``norm2``,
``mlp.fc1``, ``mlp.fc2``; ``tokens_to_token.project``; ``cls_token``,
``pos_embed`` (frozen by the solver, as the reference's), ``sie_embed``,
``blocks.{i}.*``, ``norm``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from signal_tpu_torch.models.vit_imagenet import Block, run_blocks, sie_slots
from signal_tpu_torch.ops.attention import layer_norm, linear, stored_weight, true_fp32, \
    trunc_normal_
from signal_tpu_torch.ops.token_attention import token_attention
from signal_tpu_torch.utils.profiler import span

TOKEN_DIM = 64


def sinusoid_pos_embed(n_position: int, d_hid: int) -> torch.Tensor:
    """The classic sinusoid table (the reference's get_sinusoid_encoding),
    on the default device (a model built under ``torch.device(...)`` gets
    it there)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.tensor(table)


def unfold(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """``nn.Unfold`` as tokens: [B, C, H, W] → [B, L, C·k·k] (channel-major,
    index c·k·k + ky·k + kx)."""
    return F.unfold(x, k, padding=pad, stride=stride).transpose(1, 2)


class _TokenAttention(nn.Module):
    def __init__(self, dim: int, in_dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * in_dim, bias=False)
        self.proj = nn.Linear(in_dim, in_dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class TokenTransformer(nn.Module):
    """One single-head token transformer (`init_token_transformer`,
    mlp ratio 1); the forward is :func:`token_transformer`."""

    def __init__(self, dim: int, in_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _TokenAttention(dim, in_dim)
        self.norm2 = nn.LayerNorm(in_dim)
        self.mlp = _Mlp(in_dim, in_dim)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for lin in (self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2):
            trunc_normal_(stored_weight(lin, "weight"), gen)
            if lin.bias is not None:
                lin.bias.zero_()
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()


def token_transformer(tt: TokenTransformer, x: torch.Tensor) -> torch.Tensor:
    """x [B, N, dim] → [B, N, in_dim] in true fp32: one head over the whole
    in_dim, logits scaled by dim^-0.5 of the INPUT dim, x = v + proj(attn),
    then x + fc2(gelu(fc1(norm2 x)))."""
    dim = x.shape[-1]
    f32 = torch.float32
    with true_fp32():
        h = layer_norm(tt.norm1, x)
        q, k, v = linear(tt.attn.qkv.weight, None, h, f32).chunk(3, dim=-1)
        o = linear(tt.attn.proj.weight, tt.attn.proj.bias, token_attention(q, k, v, dim ** -0.5),
                   f32)
        x = v + o
        h = F.gelu(linear(tt.mlp.fc1.weight, tt.mlp.fc1.bias, layer_norm(tt.norm2, x), f32))
        return x + linear(tt.mlp.fc2.weight, tt.mlp.fc2.bias, h, f32)


class T2TModule(nn.Module):
    def __init__(self, embed_dim: int, token_dim: int = TOKEN_DIM):
        super().__init__()
        self.attention1 = TokenTransformer(3 * 7 * 7, token_dim)
        self.attention2 = TokenTransformer(token_dim * 3 * 3, token_dim)
        self.project = nn.Linear(token_dim * 3 * 3, embed_dim)


def token_map(t2t: T2TModule, images: torch.Tensor) -> torch.Tensor:
    """The two soft splits and their token transformers, in fp32: images
    [B, 3, H, W] → [B, token_dim, H/8, W/8], the map the third soft split
    unfolds."""
    B, _, H, W = images.shape
    td = t2t.attention1.attn.proj.in_features
    x = token_transformer(t2t.attention1, unfold(images.float(), 7, 4, 2))
    x = x.transpose(1, 2).reshape(B, td, H // 4, W // 4)
    x = token_transformer(t2t.attention2, unfold(x, 3, 2, 1))
    return x.transpose(1, 2).reshape(B, td, H // 8, W // 8)


class T2TViT(nn.Module):
    """Parameters of the T2T tower (`init_t2t_params`); the forward is
    :func:`t2t_forward`."""

    def __init__(self, *, img_size: Tuple[int, int], embed_dim: int = 384, depth: int = 14,
                 camera_num: int = 0, mlp_ratio: float = 3.0):
        super().__init__()
        H, W = img_size
        self.tokens_to_token = T2TModule(embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        # three soft splits: /4, /2, /2
        self.pos_embed = nn.Parameter(
            sinusoid_pos_embed((H // 16) * (W // 16) + 1, embed_dim)[None])
        slots = sie_slots(camera_num, 0)
        self.sie_embed = nn.Parameter(torch.zeros(slots, 1, embed_dim)) if slots else None
        self.blocks = nn.ModuleList(Block(embed_dim, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def lora_paths(self):
        """The kernels MODEL.FROZEN adapts (``models/lora.py``)."""
        for name in ("attention1", "attention2"):
            yield f"tokens_to_token.{name}.attn.qkv.weight"
        for i in range(len(self.blocks)):
            for path in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
                yield f"blocks.{i}.{path}.weight"

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """`init_t2t_params`' distributions: trunc-normal σ 0.02 kernels and
        tokens, zero biases; the sinusoid table is fixed."""
        t2t = self.tokens_to_token
        t2t.attention1.reset_parameters(gen)
        t2t.attention2.reset_parameters(gen)
        trunc_normal_(t2t.project.weight, gen)
        t2t.project.bias.zero_()
        trunc_normal_(self.cls_token, gen)
        if self.sie_embed is not None:
            trunc_normal_(self.sie_embed, gen)
        for blk in self.blocks:
            blk.reset_parameters(gen)
        self.norm.reset_parameters()


def t2t_forward(net: T2TViT, images: torch.Tensor, cam_label=None, *, sie_xishu: float = 1.0,
                num_heads: int = 6, compute_dtype=torch.bfloat16, use_flash: bool = False,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, 3, H, W] → (patch tokens [B, L, D], cls [B, D]), fp32.
    The blocks' attention takes the kernels when ``use_flash``."""
    B = images.shape[0]
    t2t = net.tokens_to_token
    with span("model.t2t"):
        x = linear(t2t.project.weight, t2t.project.bias, unfold(token_map(t2t, images), 3, 2, 1),
                   compute_dtype)
    width = x.shape[-1]
    x = torch.cat([net.cls_token.float().expand(B, 1, width), x], dim=1)
    x = x + net.pos_embed.float()
    if net.sie_embed is not None and cam_label is not None:
        x = x + sie_xishu * net.sie_embed[cam_label].float()
    x = run_blocks(net.blocks, x, remat=remat, num_heads=num_heads,
                   compute_dtype=compute_dtype, use_flash=use_flash)
    x = layer_norm(net.norm, x, eps=net.norm.eps)
    return x[:, 1:], x[:, 0]
