"""CLIP ViT-B/16 vision tower (port of `signal_tpu/models/vit.py`).

  conv 16×16/16 patch embed (no bias) → [CLS] (+SIE) + pos-embed → ln_pre →
  N × pre-LN (MHA → +res → MLP(QuickGELU) → +res) → ln_post → proj

Parameters carry the reference CLIP ``VisionTransformer``'s names
(``conv1.weight``, ``transformer.resblocks.{i}.attn.in_proj_weight``, …),
so a reference-named state dict loads as it is. The blocks run as a plain
Python loop. In training, ``remat`` (MODEL.REMAT) checkpoints the blocks
under MODEL.REMAT_POLICY (:func:`vit_forward` says which tensors each
policy keeps). The JAX tower's scan, pipeline and sequence-parallel
machinery is not ported.

The tower's variants live in its blocks, under the reference's names
where it has them (`modeling/clip/model.py:183-209` in
maxingan2412/Signal):

* MODEL.ADAPTER: ``adapter_ffn`` (Linear d → d/2, QuickGELU, Linear
  d/2 → d), the MambaPro parallel adapter on the pre-ln_2 stream;
* MODEL.PROMPT: ``adapter_prompt_{rgb,nir,tir} [4, d]`` and the
  ``adapter_transfer`` / ``adapter_{r,n,t}`` MLPs (Linear, QuickGELU,
  Dropout, Linear), which ``models/vit_prompt.py`` runs;
* MODEL.MOE_EXPERTS > 1: ``moe`` (``ops/moe.py``) in place of ``mlp``; a
  block then returns (tokens, aux) and the tower the mean aux over its
  layers;
* MODEL.FROZEN: LoRA factors on the block's four kernels
  (``models/lora.py``).

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

from signal_tpu_torch.models.lora import TARGETS
from signal_tpu_torch.ops.attention import (
    MultiheadAttentionParams,
    layer_norm,
    linear,
    matmul_f32,
    mha,
    quick_gelu,
    stored_weight,
    true_fp32,
    trunc_normal_,
)
from signal_tpu_torch.ops.moe import MoE, moe_dispatch, moe_hidden, moe_mlp, moe_route

K_PROMPT = 4     # MambaPro prompt tokens per modality and block


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class QuickGELU(nn.Module):
    """x·sigmoid(1.702x); it holds a place in the reference's Sequentials
    (the forwards call :func:`quick_gelu`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


def _prompt_mlp(width: int) -> nn.Sequential:
    """d → d/2 → QuickGELU → (Dropout) → d, as the reference's prompt MLPs
    (their Linears are ``.0`` and ``.3``)."""
    return nn.Sequential(nn.Linear(width, width // 2), QuickGELU(), nn.Dropout(0.0),
                         nn.Linear(width // 2, width))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, *, adapter: bool = False, prompt: bool = False,
                 moe_experts: int = 0):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadAttentionParams(width)
        self.ln_2 = nn.LayerNorm(width)
        if moe_experts > 1:
            self.moe = MoE(width, 4 * width, moe_experts)
        else:
            self.mlp = _MLP(width)
        self.adapter_ffn = None
        if adapter:
            self.adapter_ffn = nn.Sequential(nn.Linear(width, width // 2), QuickGELU(),
                                             nn.Linear(width // 2, width))
        if prompt:
            for m in ("rgb", "nir", "tir"):
                setattr(self, f"adapter_prompt_{m}",
                        nn.Parameter(torch.zeros(K_PROMPT, width)))
            for name in ("adapter_transfer", "adapter_r", "adapter_n", "adapter_t"):
                setattr(self, name, _prompt_mlp(width))

    @property
    def is_moe(self) -> bool:
        return hasattr(self, "moe")

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """`init_vit_params`' draws for one block: the attention, the MLP
        (trunc-normal σ 0.02, zero biases) or the MoE, the adapter
        (`init_adapter_params`) and the prompts (`init_prompt_params`:
        zero prompt tokens, trunc-normal MLPs)."""
        self.attn.reset_parameters(gen)
        if self.is_moe:
            self.moe.reset_parameters(gen)
        else:
            for lin in (self.mlp.c_fc, self.mlp.c_proj):
                trunc_normal_(stored_weight(lin, "weight"), gen)
                lin.bias.zero_()
        linears = []
        if self.adapter_ffn is not None:
            linears += [self.adapter_ffn[0], self.adapter_ffn[2]]
        if hasattr(self, "adapter_transfer"):
            for name in ("adapter_transfer", "adapter_r", "adapter_n", "adapter_t"):
                mlp = getattr(self, name)
                linears += [mlp[0], mlp[3]]
            for m in ("rgb", "nir", "tir"):
                getattr(self, f"adapter_prompt_{m}").zero_()
        for lin in linears:
            trunc_normal_(lin.weight, gen)
            lin.bias.zero_()
        self.ln_1.reset_parameters()
        self.ln_2.reset_parameters()


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, **variants):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, **variants)
                                       for _ in range(layers))


class VisionTransformer(nn.Module):
    """Parameters of the CLIP tower; the forward is :func:`vit_forward`
    (with MODEL.PROMPT, ``models/vit_prompt.vit_forward_prompt``)."""

    def __init__(self, *, h_resolution: int, w_resolution: int, patch_size: int = 16,
                 width: int = 768, layers: int = 12, output_dim: int = 512,
                 adapter: bool = False, prompt: bool = False, moe_experts: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(h_resolution * w_resolution + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = _Transformer(width, layers, adapter=adapter, prompt=prompt,
                                        moe_experts=moe_experts)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def lora_paths(self):
        """The kernels MODEL.FROZEN adapts (``models/lora.py``)."""
        for i in range(len(self.transformer.resblocks)):
            for module, weight in TARGETS:
                yield f"transformer.resblocks.{i}.{module}.{weight}"

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
            blk.reset_parameters(gen)
        self.ln_pre.reset_parameters()
        self.ln_post.reset_parameters()


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


def _adapter(blk: ResidualAttentionBlock, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """MODEL.ADAPTER's branch on the pre-ln_2 stream, fp32: d → d/2 →
    QuickGELU → d (`signal_tpu/models/vit.py:142-151`)."""
    down, up = blk.adapter_ffn[0], blk.adapter_ffn[2]
    a = quick_gelu(linear(down.weight, down.bias, x, compute_dtype))
    return linear(up.weight, up.bias, a, compute_dtype)


def _mlp_out(blk: ResidualAttentionBlock, x: torch.Tensor, hidden: torch.Tensor,
             compute_dtype, adapter_out: torch.Tensor | None = None) -> torch.Tensor:
    """x + proj(hidden) (+ the adapter's branch), the block's output in the
    residual stream's dtype: x + mlp(ln_2 x) + adapter(x)."""
    h = linear(blk.mlp.c_proj.weight, blk.mlp.c_proj.bias, hidden, compute_dtype)
    if blk.adapter_ffn is not None:
        h = h + (_adapter(blk, x, compute_dtype) if adapter_out is None else adapter_out)
    return x + h.to(x.dtype)


def _moe_out(blk: ResidualAttentionBlock, x: torch.Tensor, *, compute_dtype, moe_topk: int,
             moe_capacity: float, expert_in=None, hidden=None):
    """x + moe(ln_2 x) → (the block's output, aux); ``expert_in`` and
    ``hidden`` are a remat segment's kept tensors (:func:`moe_mlp`)."""
    y, aux = moe_mlp(blk.moe, layer_norm(blk.ln_2, x), top_k=moe_topk,
                     capacity_factor=moe_capacity, compute_dtype=compute_dtype,
                     expert_in=expert_in, hidden=hidden)
    return x + y.to(x.dtype), aux


def _block(blk: ResidualAttentionBlock, x: torch.Tensor, *, num_heads: int,
           compute_dtype, use_flash: bool, policy: str | None = None,
           moe_topk: int = 1, moe_capacity: float = 1.25):
    """One residual block → its output, or (output, aux) for an MoE block.
    ``policy`` 'attn' or 'attn_mlp' runs it as checkpoint segments whose
    inputs are what the policy keeps: the block input and ``attn_out`` (and
    ``mlp_hidden``; on an MoE block ``moe_dispatch``, and ``moe_hidden``
    under 'attn_mlp'); None runs it plainly."""
    attn = functools.partial(_attn_branch, blk, num_heads=num_heads,
                             compute_dtype=compute_dtype, use_flash=use_flash)
    moe = dict(compute_dtype=compute_dtype, moe_topk=moe_topk, moe_capacity=moe_capacity)
    if policy is None:
        x = x + attn(x)
        if blk.is_moe:
            return _moe_out(blk, x, **moe)
        return _mlp_out(blk, x, _mlp_hidden(blk, x, compute_dtype), compute_dtype)
    ckpt = functools.partial(torch.utils.checkpoint.checkpoint, use_reentrant=False)
    attn_out = ckpt(attn, x)
    if blk.is_moe:
        # the routing is cheap and recomputed in each segment that needs
        # it; the dispatched slots (and under 'attn_mlp' the expert hidden)
        # are kept
        def dispatch(x, attn_out):
            h = layer_norm(blk.ln_2, x + attn_out)
            combine, _ = moe_route(blk.moe, h, top_k=moe_topk, capacity_factor=moe_capacity)
            return moe_dispatch(combine, h, compute_dtype)

        expert_in = ckpt(dispatch, x, attn_out)
        if policy == "attn":
            return ckpt(lambda x, a, e: _moe_out(blk, x + a, expert_in=e, **moe),
                        x, attn_out, expert_in)
        hidden = ckpt(lambda e: moe_hidden(blk.moe, e, compute_dtype), expert_in)
        return ckpt(lambda x, a, h: _moe_out(blk, x + a, hidden=h, **moe),
                    x, attn_out, hidden)
    if policy == "attn":
        def tail(x, attn_out):
            x = x + attn_out
            return _mlp_out(blk, x, _mlp_hidden(blk, x, compute_dtype), compute_dtype)

        return ckpt(tail, x, attn_out)
    # attn_mlp: the residual sum is recomputed outside the hidden's segment
    # (the same bf16 add, so the same values); proj keeps its own input,
    # and the adapter's branch is a segment of its own on the kept tensors
    hidden = ckpt(lambda x, attn_out: _mlp_hidden(blk, x + attn_out, compute_dtype),
                  x, attn_out)
    adapter_out = None
    if blk.adapter_ffn is not None:
        adapter_out = ckpt(lambda x, a: _adapter(blk, x + a, compute_dtype), x, attn_out)
    return _mlp_out(blk, x + attn_out, hidden, compute_dtype, adapter_out)


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
                remat_policy: str = "full", moe_topk: int = 1,
                moe_capacity: float = 1.25,
                return_intermediate: bool = False) -> Tuple[torch.Tensor, ...]:
    """images [B, 3, H, W] → (patch tokens [B, L, out], cls [B, out]), fp32;
    an MoE tower (MODEL.MOE_EXPERTS > 1) adds the mean load-balance aux
    over its layers: (patches, cls, moe_aux).

    ``return_intermediate``: CLIP-ReID's triple of full sequences, CLS
    first, instead (`signal_tpu/models/vit.py:229-231`): (the stream after
    ``layers − 1`` blocks [B, 1+L, width] and the ln_post output, both in
    the compute dtype, and the projection [B, 1+L, out] fp32), plus the aux
    on an MoE tower.

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
      apart, and it does so inside ``_MatmulF32`` and the attention
      operator as they are (``signal_tpu_torch::attention_fwd`` is not a
      product, so it is recomputed);
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
    auxs = []
    for i, blk in enumerate(blocks):
        if i == len(blocks) - 1:
            x_last = x
        fn = functools.partial(_block, blk, num_heads=num_heads, compute_dtype=compute_dtype,
                               use_flash=use_flash, moe_topk=moe_topk,
                               moe_capacity=moe_capacity)
        if not checkpointed or (remat_policy == "half" and i >= len(blocks) // 2):
            out = fn(x)
        elif remat_policy in ("full", "half"):
            out = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
        elif remat_policy == "dots":
            out = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False,
                                                    context_fn=_save_products)
        else:
            out = fn(x, policy=remat_policy)
        if blk.is_moe:
            x, aux = out
            auxs.append(aux)
        else:
            x = out
    x_post = layer_norm(vit.ln_post, x)
    x_proj = matmul_f32(x_post.to(compute_dtype), vit.proj.to(compute_dtype))
    aux = (torch.stack(auxs).sum() / len(blocks),) if auxs else ()
    if return_intermediate:
        return (x_last, x_post, x_proj, *aux)
    return (x_proj[:, 1:], x_proj[:, 0], *aux)


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
