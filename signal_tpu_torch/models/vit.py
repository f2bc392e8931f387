"""CLIP ViT-B/16 vision tower (port of `signal_tpu/models/vit.py`).

  conv 16×16/16 patch embed (no bias) → [CLS] (+SIE) + pos-embed → ln_pre →
  N × pre-LN (MHA → +res → MLP(QuickGELU) → +res) → ln_post → proj

Parameters carry the reference CLIP ``VisionTransformer``'s names
(``conv1.weight``, ``transformer.resblocks.{i}.attn.in_proj_weight``, …),
so a reference-named state dict loads as it is. The blocks run as a plain
Python loop. In training, ``remat`` (MODEL.REMAT) checkpoints the blocks
under MODEL.REMAT_POLICY (:func:`vit_forward` says which tensors each
policy keeps). The JAX tower's scan, pipeline, sequence-parallel and MoE
machinery is not ported.

bf16 rounding points follow the JAX tower exactly: the patch conv rounds
its output to the compute dtype before the fp32 cast; the residual stream
rides in the compute dtype between blocks and each branch is cast to it
before the add; the MLP hidden is emitted in the compute dtype; ln_post →
proj is one compute-dtype product with fp32 accumulation.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from signal_tpu_torch.ops.attention import (
    MultiheadAttentionParams,
    layer_norm,
    linear,
    matmul_f32,
    mha,
    quick_gelu,
    true_fp32,
    trunc_normal_,
)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadAttentionParams(width)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = _MLP(width)


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width) for _ in range(layers))


class VisionTransformer(nn.Module):
    """Parameters of the CLIP tower; the forward is :func:`vit_forward`."""

    def __init__(self, *, h_resolution: int, w_resolution: int, patch_size: int = 16,
                 width: int = 768, layers: int = 12, output_dim: int = 512):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(h_resolution * w_resolution + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = _Transformer(width, layers)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random init with `signal_tpu/models/vit.py::init_vit_params`'
        distributions (CLIP checkpoints overwrite these in practice)."""
        width = self.class_embedding.shape[0]
        scale = width ** -0.5
        trunc_normal_(self.conv1.weight, gen, scale)
        self.class_embedding.normal_(0.0, scale, generator=gen)
        self.positional_embedding.normal_(0.0, scale, generator=gen)
        self.proj.normal_(0.0, scale, generator=gen)
        for blk in self.transformer.resblocks:
            blk.attn.reset_parameters(gen)
            trunc_normal_(blk.mlp.c_fc.weight, gen)
            trunc_normal_(blk.mlp.c_proj.weight, gen)
            blk.mlp.c_fc.bias.zero_()
            blk.mlp.c_proj.bias.zero_()
        for ln in (self.ln_pre, self.ln_post,
                   *(m for blk in self.transformer.resblocks for m in (blk.ln_1, blk.ln_2))):
            ln.reset_parameters()


def _attn_branch(blk: ResidualAttentionBlock, x: torch.Tensor, *, num_heads: int,
                 compute_dtype, use_flash: bool) -> torch.Tensor:
    """ln_1 → MHA, in the residual stream's dtype (JAX's ``attn_out``)."""
    return mha(blk.attn, layer_norm(blk.ln_1, x), num_heads=num_heads,
               compute_dtype=compute_dtype, use_flash=use_flash).to(x.dtype)


def _mlp_hidden(blk: ResidualAttentionBlock, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """ln_2 → fc → QuickGELU, in the compute dtype (JAX's ``mlp_hidden``)."""
    h = layer_norm(blk.ln_2, x)
    return quick_gelu(linear(blk.mlp.c_fc.weight, blk.mlp.c_fc.bias, h, compute_dtype,
                             out_dtype=compute_dtype))


def _mlp_out(blk: ResidualAttentionBlock, x: torch.Tensor, hidden: torch.Tensor,
             compute_dtype) -> torch.Tensor:
    """x + proj(hidden), the block's output in the residual stream's dtype."""
    h = linear(blk.mlp.c_proj.weight, blk.mlp.c_proj.bias, hidden, compute_dtype)
    return x + h.to(x.dtype)


def _block(blk: ResidualAttentionBlock, x: torch.Tensor, *, num_heads: int,
           compute_dtype, use_flash: bool, policy: str | None = None) -> torch.Tensor:
    """One residual block. ``policy`` 'attn' or 'attn_mlp' runs it as
    checkpoint segments whose inputs are what the policy keeps: the block
    input and ``attn_out`` (and ``mlp_hidden``); None runs it plainly."""
    attn = functools.partial(_attn_branch, blk, num_heads=num_heads,
                             compute_dtype=compute_dtype, use_flash=use_flash)
    if policy is None:
        x = x + attn(x)
        return _mlp_out(blk, x, _mlp_hidden(blk, x, compute_dtype), compute_dtype)
    ckpt = functools.partial(torch.utils.checkpoint.checkpoint, use_reentrant=False)
    attn_out = ckpt(attn, x)
    if policy == "attn":
        def tail(x, attn_out):
            x = x + attn_out
            return _mlp_out(blk, x, _mlp_hidden(blk, x, compute_dtype), compute_dtype)

        return ckpt(tail, x, attn_out)
    # attn_mlp: the residual sum is recomputed outside the hidden's segment
    # (the same bf16 add, so the same values); proj keeps its own input
    hidden = ckpt(lambda x, attn_out: _mlp_hidden(blk, x + attn_out, compute_dtype),
                  x, attn_out)
    return _mlp_out(blk, x + attn_out, hidden, compute_dtype)


REMAT_POLICIES = ("full", "dots", "attn", "attn_mlp", "half")


def _keep_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of 'dots': keep the outputs of 2-D
    products (``aten.mm``, and on the card ``_MatmulF32``'s ``out_dtype``
    overload of it); recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype)


def _save_products():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(_keep_products)


def embed_patches(vit: VisionTransformer, images: torch.Tensor, cv_emb=None, *,
                  stride: int | None = None, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Conv patch embed → CLS (+SIE) → pos embed → ln_pre. images
    [B, 3, H, W] → [B, 1+L, width] fp32."""
    B = images.shape[0]
    stride = stride or vit.conv1.kernel_size[0]
    # compute-dtype conv in and out (fp32 accumulation inside), rounded
    # before the fp32 cast; an fp32 conv is a true-fp32 one (cuDNN would
    # take TF32 by default)
    guard = true_fp32() if compute_dtype == torch.float32 else contextlib.nullcontext()
    with guard:
        x = F.conv2d(images.to(compute_dtype), vit.conv1.weight.to(compute_dtype),
                     stride=stride)
    x = x.float()  # [B, width, h, w]
    width = x.shape[1]
    x = x.reshape(B, width, -1).transpose(1, 2)
    cls_tok = vit.class_embedding.float().expand(B, 1, width)
    if cv_emb is not None:
        cls_tok = cls_tok + cv_emb[:, None, :].float()
    x = torch.cat([cls_tok, x], dim=1)
    x = x + vit.positional_embedding.float()[None]
    return layer_norm(vit.ln_pre, x)


def vit_forward(vit: VisionTransformer, images: torch.Tensor, cv_emb=None, *,
                num_heads: int = 12, compute_dtype=torch.bfloat16, use_flash: bool = False,
                stride: int | None = None, remat: bool = False,
                remat_policy: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, 3, H, W] → (patch tokens [B, L, out], cls [B, out]), fp32.

    ``cv_emb`` [B, width]: SIE camera embedding, added to the CLS token
    only. ``use_flash``: each block's attention goes through the fused
    kernel (one launch per block on the card, one more per block whose
    backward recomputes it).

    ``remat`` (under grad mode) keeps for each block's backward what the
    JAX tower's ``jax.checkpoint`` policy keeps (`signal_tpu/models/
    vit.py:252-291,353-372`) and recomputes the rest:

    * 'full': the block's input only (``torch.utils.checkpoint`` of the
      block);
    * 'dots': also the outputs of the block's non-batched products (q, k,
      v, out-proj, fc, proj). A selective checkpoint whose policy saves
      ``aten.mm``'s outputs: the products are the only ops it must tell
      apart, and it does so inside ``_MatmulF32`` and ``_FusedAttention``
      as they are (the attention kernel is a ctypes call the policy never
      sees, so it is recomputed);
    * 'attn': ``attn_out``; 'attn_mlp': ``attn_out`` and ``mlp_hidden``.
      Explicit checkpoint segments (:func:`_block`): a segment's inputs are
      what it keeps, so the kept set is exact whatever ops a branch runs;
    * 'half': the first ``layers // 2`` blocks as 'full', the rest keep
      everything.

    The out-proj's weight gradient needs the attention core's output, so
    every block that is recomputed at all launches the forward kernel
    again: 2 launches per block under 'full', 'dots', 'attn' and
    'attn_mlp', 1.5 under 'half', 1 without remat. Remat never changes the
    numbers, only memory and recompute."""
    if remat and remat_policy not in REMAT_POLICIES:
        raise ValueError(f"MODEL.REMAT_POLICY={remat_policy!r}: one of {REMAT_POLICIES}")
    x = embed_patches(vit, images, cv_emb, stride=stride, compute_dtype=compute_dtype)
    x = x.to(compute_dtype)
    checkpointed = remat and torch.is_grad_enabled()
    blocks = vit.transformer.resblocks
    for i, blk in enumerate(blocks):
        fn = functools.partial(_block, blk, num_heads=num_heads, compute_dtype=compute_dtype,
                               use_flash=use_flash)
        if not checkpointed or (remat_policy == "half" and i >= len(blocks) // 2):
            x = fn(x)
        elif remat_policy in ("full", "half"):
            x = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
        elif remat_policy == "dots":
            x = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False,
                                                  context_fn=_save_products)
        else:
            x = fn(x, policy=remat_policy)
    x_post = layer_norm(vit.ln_post, x)
    x_proj = matmul_f32(x_post.to(compute_dtype), vit.proj.to(compute_dtype))
    return x_proj[:, 1:], x_proj[:, 0]


def _bilinear_resize_no_aa(grid: torch.Tensor, h_new: int, w_new: int) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear', align_corners=False)``: half-pixel
    centers, NO antialiasing on downsample, edge clamping. grid [H, W, C]."""
    g = grid.permute(2, 0, 1)[None].float()
    out = F.interpolate(g, size=(h_new, w_new), mode="bilinear", align_corners=False,
                        antialias=False)
    return out[0].permute(1, 2, 0)


def resize_pos_embed(posemb: torch.Tensor, h_new: int, w_new: int) -> torch.Tensor:
    """Bilinear-resize a square [1+L, width] pos-embed grid to (h_new, w_new),
    token 0 kept (the reference's checkpoint-load resize,
    `clip/model.py:712-729`). Square sources only: a flat grid carries no
    layout, so a trained (non-square) grid must be imported as it is."""
    tok, grid = posemb[:1], posemb[1:]
    gs_old = int(math.sqrt(grid.shape[0]))
    if gs_old * gs_old != grid.shape[0]:
        raise ValueError(
            f"pos embed has {grid.shape[0]} grid tokens — not a square "
            f"pretrained grid; a trained checkpoint's grid must be imported "
            f"verbatim at its own layout, not resized")
    width = grid.shape[-1]
    grid = _bilinear_resize_no_aa(grid.reshape(gs_old, gs_old, width), h_new, w_new)
    return torch.cat([tok, grid.reshape(h_new * w_new, width).to(posemb.dtype)], dim=0)
