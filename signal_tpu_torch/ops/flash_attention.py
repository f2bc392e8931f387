"""Fused attention forward (port of `signal_tpu/ops/flash_attention.py`).

``flash_attention`` is the post-projection attention the ViT blocks call
through ``mha(use_flash=True)``. It casts q, k, v to the compute dtype,
then:

* on a CPU tensor runs :func:`flash_attention_reference`, the plain
  PyTorch version of what the TPU kernel computes;
* on a CUDA tensor launches the hand-written kernel
  ``signal_tpu_torch/csrc/attention_fwd.cu`` (:func:`attention_fwd_cuda`)
  or raises. There is no fallback from one to the other.

The kernel replaces ``_attn_kernel`` (`signal_tpu/ops/flash_attention.py`,
called from ``_fused_attention_fwd_impl``). On an H100 it is bound by
memory, not arithmetic: at the ViT-B shape ([3B, 129, 768], 12 heads of
64, bf16) it does ~64 FLOP per byte of q, k, v and o, against the card's
~295 FLOP/B ridge. Its design reads each head's K and V from device memory
once into shared memory, keeps the [Lq, Lk] logits on chip, and reads the
heads by stride from [B, L, D] so no transpose copies are made. The source
says more. Mesh and tensor-parallel routing (`:263-281` of the JAX module)
come with tensor parallelism.
"""

from __future__ import annotations

import ctypes
import math

import torch

# the kernel's limits: 16-byte vector loads of a head's columns, and one
# warp's column pairs stepping by 64
MAX_HEAD_DIM = 128


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch. q [B, Lq, D], k/v
    [B, Lk, D], all in the operand dtype → [B, Lq, D] in q's dtype.

    Per head: logits = (q·kᵀ from operand-dtype values, fp32 accumulation)
    × scale — the scale comes AFTER the dot, unlike the eager core — fp32
    softmax, P rounded to the operand dtype, P·V accumulated in fp32."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // num_heads
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, Lq, num_heads, hd).transpose(1, 2).float()
    kh = k.reshape(B, Lk, num_heads, hd).transpose(1, 2).float()
    vh = v.reshape(B, Lk, num_heads, hd).transpose(1, 2).float()
    logits = (qh @ kh.transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    out = probs.to(v.dtype).float() @ vh
    return out.transpose(1, 2).reshape(B, Lq, D).to(q.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, num_heads: int) -> int:
    """Raise on anything the kernel does not take; → head dim."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention_fwd_cuda needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention_fwd_cuda takes fp32 or bf16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"want q [B, Lq, D], k = v [B, Lk, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, D = q.shape
    if k.shape[0] != B or k.shape[2] != D or Lq < 1 or k.shape[1] < 1:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    hd = D // num_heads
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes hd % 8 == 0 and "
                         f"hd <= {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return hd


def attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """Launch ``csrc/attention_fwd.cu`` on the current stream. q [B, Lq, D],
    k/v [B, Lk, D], fp32 or bf16, on the card → o [B, Lq, D]. Counts each
    launch in ``attention_fwd_cuda.launches``."""
    hd = _check(q, k, v, num_heads)
    from signal_tpu_torch.ops._build import load

    lib = load("attention_fwd")
    _declare(lib)
    B, Lq, D = q.shape
    Lk = k.shape[1]
    code = _DTYPE_CODE[q.dtype]
    need = lib.attention_fwd_smem_bytes(code, Lk, hd)
    limit = lib.attention_fwd_smem_limit(q.device.index)
    if need > limit:
        raise ValueError(f"Lk={Lk}, hd={hd} ({q.dtype}) needs {need} B of shared "
                         f"memory; the card allows {limit} B per block")
    # one block per (batch row, head, tile of query rows): a whole short
    # sequence in one tile reads each head's K and V once
    n_tiles = -(-Lq // 256)
    rows = -(-Lq // n_tiles)
    o = torch.empty_like(q)
    rc = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           code, B, num_heads, Lq, Lk, hd, rows,
                           1.0 / math.sqrt(hd),
                           torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {rc}")
    attention_fwd_cuda.launches += 1
    return o


attention_fwd_cuda.launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.attention_fwd.restype = i
    lib.attention_fwd_smem_bytes.argtypes = [i, i, i]
    lib.attention_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.attention_fwd_smem_limit.argtypes = [i]
    lib.attention_fwd_smem_limit.restype = i


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Post-projection fused attention. q [B, Lq, D], k/v [B, Lk, D] arrive
    fp32 from the projections and are cast to ``compute_dtype``
    (`signal_tpu/ops/flash_attention.py:258-259`) → [B, Lq, D] in
    ``compute_dtype``. CPU tensors take the plain version; CUDA tensors
    the kernel."""
    q, k, v = q.to(compute_dtype), k.to(compute_dtype), v.to(compute_dtype)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, num_heads)
    return attention_fwd_cuda(q, k, v, num_heads)
