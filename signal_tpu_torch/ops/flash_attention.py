"""Fused attention, forward and backward (port of
`signal_tpu/ops/flash_attention.py`).

``flash_attention`` is the post-projection attention the ViT blocks call
through ``mha(use_flash=True)``. It casts q, k, v to the compute dtype and
runs :class:`_FusedAttention`, the port of the JAX ``custom_vjp``:

* on CPU tensors the forward is :func:`flash_attention_reference` and the
  backward :func:`flash_attention_bwd_reference`, the plain PyTorch
  versions of what the TPU kernels compute;
* on CUDA tensors the forward launches ``csrc/attention_fwd.cu``
  (:func:`attention_fwd_cuda`) and the backward ``csrc/attention_bwd.cu``
  (:func:`attention_bwd_cuda`), or raises. There is no fallback from one
  to the other.

The kernels replace ``_attn_kernel`` and ``_attn_bwd_kernel``. On an H100
both are bound by memory, not arithmetic, at the ViT-B shape
([3B, 129, 768], 12 heads of 64, bf16): tens of FLOP per byte moved,
against the card's ~295 FLOP/B ridge. Their designs read each head's
operands from device memory once into shared memory, keep everything of
size [Lq, Lk] on chip, and read the heads by stride from [B, L, D] so no
transpose copies are made. The sources say more. Mesh and tensor-parallel
routing (`:263-281` of the JAX module) come with tensor parallelism.
"""

from __future__ import annotations

import ctypes
import math

import torch

# the kernels' limits: 16-byte vector loads of a head's columns, and one
# warp's column pairs stepping by 64
MAX_HEAD_DIM = 128


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] → fp32 [B, H, L, hd]."""
    B, L, D = t.shape
    return t.reshape(B, L, num_heads, D // num_heads).transpose(1, 2).float()


def _merge(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, L, hd] → [B, L, H·hd] in ``dtype``."""
    B, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, H * hd).to(dtype)


def _probs(qh: torch.Tensor, kh: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 softmax of the logits, scaled AFTER the dot (the kernels'
    order, unlike the eager core), row max subtracted, then e / Σe."""
    logits = (qh @ kh.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """What the forward kernel computes, in plain PyTorch. q [B, Lq, D],
    k/v [B, Lk, D], all in the operand dtype → [B, Lq, D] in q's dtype.

    Per head: logits = (q·kᵀ from operand-dtype values, fp32 accumulation)
    × scale, fp32 softmax, P rounded to the operand dtype, P·V accumulated
    in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    probs = _probs(_heads(q, num_heads), _heads(k, num_heads), scale)
    out = probs.to(v.dtype).float() @ _heads(v, num_heads)
    return _merge(out, q.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  g: torch.Tensor, num_heads: int):
    """What the backward kernel computes, in plain PyTorch, at the TPU
    kernel's rounding points (`_attn_bwd_kernel`), not autograd's. q, g
    [B, Lq, D], k/v [B, Lk, D], all in the operand dtype → (dq, dk, dv) in
    that dtype.

    Per head: P in fp32; dV = round(P)ᵀ·g; dP = g·Vᵀ in fp32;
    dS = P∘(dP − rowsum(dP∘P)) from the fp32 P; dQ = (round(dS)·K)·scale,
    dK = (round(dS)ᵀ·Q)·scale; round() is to the operand dtype and every
    product accumulates in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    qh, kh, vh, gh = (_heads(t, num_heads) for t in (q, k, v, g))
    p = _probs(qh, kh, scale)
    dv = p.to(v.dtype).float().transpose(-1, -2) @ gh
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(q.dtype).float()
    dq = (dsc @ kh) * scale
    dk = (dsc.transpose(-1, -2) @ qh) * scale
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(name: str, num_heads: int, q, *rest) -> int:
    """Raise on anything the kernels do not take; → head dim. ``rest`` is
    k, v (and g for the backward)."""
    k = rest[0]
    tensors = (q, *rest)
    if not (q.is_cuda and all(t.device == q.device for t in rest)):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in rest):
        raise ValueError(f"{name} takes fp32 or bf16 tensors of one dtype, got "
                         f"{[t.dtype for t in tensors]}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != rest[1].shape:
        raise ValueError(f"want q [B, Lq, D], k = v [B, Lk, D], got "
                         f"{[tuple(t.shape) for t in tensors]}")
    B, Lq, D = q.shape
    if k.shape[0] != B or k.shape[2] != D or Lq < 1 or k.shape[1] < 1:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if len(rest) > 2 and rest[2].shape != q.shape:
        raise ValueError(f"g {tuple(rest[2].shape)} differs from q {tuple(q.shape)}")
    if D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    hd = D // num_heads
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes hd % 8 == 0 and "
                         f"hd <= {MAX_HEAD_DIM}")
    for label, t in zip("qkvg", tensors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{label} must be contiguous and 16-byte aligned")
    return hd


def _load(name: str) -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    from signal_tpu_torch.ops._build import load

    lib = load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "attention_fwd":
        lib.attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        lib.attention_fwd_smem_bytes.argtypes = [i, i, i]
    else:
        lib.attention_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                      ctypes.c_float, p]
        lib.attention_bwd_smem_bytes.argtypes = [i, i, i, i]
    getattr(lib, name).restype = i
    getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_size_t
    getattr(lib, f"{name}_smem_limit").argtypes = [i]
    getattr(lib, f"{name}_smem_limit").restype = i
    return lib


def _guard_smem(name: str, lib: ctypes.CDLL, need: int, device: torch.device, what: str):
    limit = getattr(lib, f"{name}_smem_limit")(device.index)
    if need > limit:
        raise ValueError(f"{what} needs {need} B of shared memory; the card "
                         f"allows {limit} B per block")


def _tile(n: int) -> int:
    """Rows per block: a whole short sequence in one tile, so each block
    reads its head's staged operands once."""
    return -(-n // -(-n // 256))


def attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """Launch ``csrc/attention_fwd.cu`` on the current stream. q [B, Lq, D],
    k/v [B, Lk, D], fp32 or bf16, on the card → o [B, Lq, D]. Counts each
    launch in ``attention_fwd_cuda.launches``.

    Its output carries no gradient, so it raises under grad mode when an
    input requires grad: a graph goes through :func:`flash_attention`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("attention_fwd_cuda's output has no grad_fn; call "
                           "flash_attention (which has a backward) in a graph")
    hd = _check("attention_fwd_cuda", num_heads, q, k, v)
    lib = _load("attention_fwd")
    B, Lq, D = q.shape
    Lk = k.shape[1]
    code = _DTYPE_CODE[q.dtype]
    _guard_smem("attention_fwd", lib, lib.attention_fwd_smem_bytes(code, Lk, hd), q.device,
                f"Lk={Lk}, hd={hd} ({q.dtype})")
    o = torch.empty_like(q)
    rc = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           code, B, num_heads, Lq, Lk, hd, _tile(Lq),
                           1.0 / math.sqrt(hd),
                           torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {rc}")
    attention_fwd_cuda.launches += 1
    return o


attention_fwd_cuda.launches = 0


def attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                       num_heads: int):
    """Launch ``csrc/attention_bwd.cu`` (its row and column kernels) on the
    current stream. q, g [B, Lq, D], k/v [B, Lk, D], fp32 or bf16, on the
    card → (dq, dk, dv) in the same shapes and dtype. Counts each call in
    ``attention_bwd_cuda.launches``."""
    hd = _check("attention_bwd_cuda", num_heads, q, k, v, g)
    lib = _load("attention_bwd")
    B, Lq, D = q.shape
    Lk = k.shape[1]
    code = _DTYPE_CODE[q.dtype]
    _guard_smem("attention_bwd", lib, lib.attention_bwd_smem_bytes(code, Lq, Lk, hd),
                q.device, f"Lq={Lq}, Lk={Lk}, hd={hd} ({q.dtype})")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per query row: the softmax max and sum and rowsum(dP∘P), fp32
    stats = torch.empty(3, B * num_heads * Lq, dtype=torch.float32, device=q.device)
    rc = lib.attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                           code, B, num_heads, Lq, Lk, hd, _tile(Lq), _tile(Lk),
                           1.0 / math.sqrt(hd),
                           torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_bwd launch failed: cudaError {rc}")
    attention_bwd_cuda.launches += 1
    return dq, dk, dv


attention_bwd_cuda.launches = 0


class _FusedAttention(torch.autograd.Function):
    """The JAX ``custom_vjp`` (`flash_attention.py:195-209`): saves only q,
    k and v; the backward recomputes P. CPU tensors take the plain
    versions, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, num_heads)
        return attention_fwd_cuda(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()   # `flash_attention.py:206`
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, g, ctx.num_heads)
        else:
            dq, dk, dv = attention_bwd_cuda(q, k, v, g, ctx.num_heads)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Post-projection fused attention. q [B, Lq, D], k/v [B, Lk, D] arrive
    fp32 from the projections and are cast to ``compute_dtype``
    (`signal_tpu/ops/flash_attention.py:258-259`) → [B, Lq, D] in
    ``compute_dtype``, differentiable in q, k and v."""
    q, k, v = (t.to(compute_dtype).contiguous() for t in (q, k, v))
    return _FusedAttention.apply(q, k, v, num_heads)
