"""Attention / norm / activation primitives (port of
`signal_tpu/ops/attention.py`).

Numerics follow the JAX package op for op:

* a matmul takes its operands in the compute dtype and accumulates in
  fp32, and its result is fp32 (JAX's ``preferred_element_type``);
* LayerNorm and softmax run in fp32 and LayerNorm returns its input's
  dtype;
* fp32 compute means true fp32: nothing here turns TF32 on, and
  :func:`true_fp32` turns it off where the JAX package asks for
  ``Precision.HIGHEST``.

Parameters live in modules named like the reference's torch model
(``nn.MultiheadAttention``'s packed ``in_proj_weight [3D, D]``,
``nn.LayerNorm``'s ``weight``/``bias``), so the functions here take those
modules.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def true_fp32():
    """Full-fp32 matmuls and cuDNN convolutions inside the block, whatever
    the process-wide TF32 flags say; restores them on exit."""
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` of two bf16 matrices → fp32, fp32 accumulation. On the
    card the tensor cores write their fp32 accumulator (``out_dtype``); on
    the CPU the bf16 values are widened first, which is exact (a product
    of two bf16 values fits in fp32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """bf16 × bf16 → fp32 product with the VJP of JAX's
    ``dot_general(bf16, bf16, preferred_element_type=f32)``: the fp32
    cotangent is dotted with the other bf16 operand, accumulating in fp32,
    and the result is rounded to bf16, the operand's gradient (the cast
    in front of the product then widens it).

    On the CPU the fp32 cotangent enters the product as it is, as in the
    JAX package on the CPU. On the card it is rounded to bf16 first and
    the product runs on the tensor cores, as XLA's DEFAULT precision does
    on the TPU."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = _mm_f32(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        a2, g2 = a.reshape(-1, a.shape[-1]), g.reshape(-1, g.shape[-1])
        if g.is_cuda:
            g2 = g2.to(b.dtype)
            da = _mm_f32(g2, b.t())
            db = _mm_f32(a2.t(), g2)
        else:
            da = g2 @ b.float().t()
            db = a2.float().t() @ g2
        return da.to(a.dtype).reshape(a.shape), db.to(b.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` → fp32, with the operands as given (the compute dtype)
    and fp32 accumulation. ``b`` is 2-D. An fp32 product is a plain one
    (true fp32 under :func:`true_fp32`); a bf16 one is :class:`_MatmulF32`."""
    if a.dtype == torch.float32:
        return a @ b
    return _MatmulF32.apply(a, b)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm over the last axis; returns x's original dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(), ln.bias.float(), eps)
    return y.to(x.dtype)


def linear(weight: torch.Tensor, bias, x: torch.Tensor,
           compute_dtype=torch.bfloat16, out_dtype=None) -> torch.Tensor:
    """``x @ weightᵀ + bias`` (``weight`` is ``nn.Linear``'s ``[out, in]``):
    operands in ``compute_dtype``, fp32 accumulation, bias added in fp32,
    result fp32 unless ``out_dtype`` is given."""
    y = matmul_f32(x.to(compute_dtype), weight.to(compute_dtype).t())
    if bias is not None:
        y = y + bias.float()
    return y if out_dtype is None else y.to(out_dtype)


def _attention_core(q, k, v, num_heads: int, compute_dtype=torch.bfloat16, scale=None):
    """Eager softmax attention. q [B, Lq, D], k/v [B, Lk, D] → fp32
    [B, Lq, D]. q is scaled BEFORE the cast to the compute dtype
    (`signal_tpu/ops/attention.py:83`); the kernel path scales after the
    dot instead (`ops/flash_attention.py`). ``scale``: the qk scale
    (default 1/√head_dim)."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // num_heads
    q = q.reshape(B, Lq, num_heads, hd).transpose(1, 2)
    k = k.reshape(B, Lk, num_heads, hd).transpose(1, 2)
    v = v.reshape(B, Lk, num_heads, hd).transpose(1, 2)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    # operands rounded to the compute dtype, then multiplied in fp32:
    # the exact value of a compute-dtype product with fp32 accumulation
    qs = (q * scale).to(compute_dtype).float()
    logits = qs @ k.to(compute_dtype).float().transpose(-1, -2)
    probs = torch.softmax(logits, dim=-1)
    out = probs.to(compute_dtype).float() @ v.to(compute_dtype).float()
    return out.transpose(1, 2).reshape(B, Lq, D)


def attention(qkv_weight: torch.Tensor, qkv_bias: torch.Tensor, out_weight: torch.Tensor,
              out_bias: torch.Tensor, q_in: torch.Tensor, kv_in: torch.Tensor | None = None,
              *, num_heads: int, compute_dtype=torch.bfloat16, use_flash: bool = False,
              scale=None) -> torch.Tensor:
    """Multi-head (self or cross) attention from a packed ``[3D, D]``
    q|k|v projection and a ``[D, D]`` output projection (torch's
    ``[out, in]`` weights). The core goes through
    :func:`signal_tpu_torch.ops.flash_attention.flash_attention` (the CUDA
    kernel on the card) only when ``use_flash`` and no ``scale`` override
    is given, else the eager core: the JAX package's rule
    (`signal_tpu/ops/attention.py:131-138`)."""
    if kv_in is None:
        kv_in = q_in
    wq, wk, wv = qkv_weight.chunk(3, dim=0)
    bq, bk, bv = qkv_bias.chunk(3, dim=0)
    q = linear(wq, bq, q_in, compute_dtype)
    k = linear(wk, bk, kv_in, compute_dtype)
    v = linear(wv, bv, kv_in, compute_dtype)
    if use_flash and scale is None:
        from signal_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(q, k, v, num_heads=num_heads,
                              compute_dtype=compute_dtype)
    else:
        out = _attention_core(q, k, v, num_heads, compute_dtype, scale=scale)
    return linear(out_weight, out_bias, out, compute_dtype)


def mha(attn: nn.Module, q_in: torch.Tensor, kv_in: torch.Tensor | None = None, *,
        num_heads: int, compute_dtype=torch.bfloat16, use_flash: bool = False,
        scale=None) -> torch.Tensor:
    """:func:`attention` over ``nn.MultiheadAttention``'s packed layout:
    ``in_proj_weight [3D, D]``, ``in_proj_bias [3D]``, ``out_proj.weight
    [D, D]``, ``out_proj.bias [D]``."""
    return attention(attn.in_proj_weight, attn.in_proj_bias, attn.out_proj.weight,
                     attn.out_proj.bias, q_in, kv_in, num_heads=num_heads,
                     compute_dtype=compute_dtype, use_flash=use_flash, scale=scale)


class MultiheadAttentionParams(nn.Module):
    """Parameter holder with ``nn.MultiheadAttention``'s names (the forward
    is :func:`mha`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """`signal_tpu/ops/attention.py::init_mha`: xavier-uniform over the
        packed in_proj, U(±1/√D) out_proj, zero biases."""
        in_proj = stored_weight(self, "in_proj_weight")
        dim = in_proj.shape[1]
        bound = math.sqrt(6.0 / (dim + 3 * dim))
        in_proj.uniform_(-bound, bound, generator=gen)
        stored_weight(self.out_proj, "weight").uniform_(-1 / math.sqrt(dim), 1 / math.sqrt(dim),
                                                         generator=gen)
        self.in_proj_bias.zero_()
        self.out_proj.bias.zero_()


def stored_weight(module: nn.Module, name: str) -> torch.Tensor:
    """``module.<name>`` as stored: under a parametrization (LoRA,
    ``models/lora.py``) the base tensor, not the merged value a read
    returns, so that an in-place init reaches it."""
    params = getattr(module, "parametrizations", None)
    if params is not None and name in params:
        return params[name].original
    return getattr(module, name)


def trunc_normal_(t: torch.Tensor, gen: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """Truncated normal in (−2σ, 2σ) (timm's ``trunc_normal_``)."""
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
