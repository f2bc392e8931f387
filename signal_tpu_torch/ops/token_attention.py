"""The tokens-to-token module's attention as a registered operator,
``torch.ops.signal_tpu_torch.token_attention``.

T2T's two token transformers (``models/t2t.token_transformer``) attend
with one head over the whole token width (64) at 2,048 and 512 tokens of
a 256×128 image, in fp32 whatever MODEL.COMPUTE_DTYPE, with the logits
scaled by the INPUT dim's ``dim^-1/2`` (147^-1/2, 576^-1/2), the
published quirk. The operator takes q, k, v [B, L, d] and that scale and
returns ``softmax((q·scale)·kᵀ)·v``; the v-skip and the out-projection
stay outside it.

Its body's route is chosen by the device alone:

* on the card, :func:`token_attention_cuda` launches
  ``csrc/token_attention.cu``: a flash-style forward on the tensor cores,
  fp32-accurate by 3xTF32, with no [B, L, L] tensor in memory. It takes
  fp32 q, k, v of head dim 64 (T2T's token_dim) and raises on anything
  else; it reads them as they lie where TMA can address them (last
  stride 1, row and batch strides and bases in 16-byte multiples, as the
  ``.chunk(3, -1)`` views of the qkv product are) and from a contiguous
  copy where not;
* on the CPU, the eager fp32 core, :func:`eager_core`, with TF32 off: the
  same operations, in the same order, as the expression it replaced, so
  the same bits. It is also the card tests' reference.

Being an operator, it is one host event in a profile (the device work
under it is linked to it by name). Its backward
(:func:`_token_attention_bwd`) saves q, k and v, not the [B, L, L]
probabilities (6.4 GB at a gallery batch's first stage), and recomputes
them eagerly, the eager core's bits:

    dV = Aᵀ·dO,   dA = dO·Vᵀ,   dS = A ⊙ (dA − rowsum(dA ⊙ A)),
    dQ = (dS·K)·s,   dK = dSᵀ·(Q·s).

:func:`token_attention` calls the operator and counts its calls in
``token_attention.calls``.
"""

from __future__ import annotations

import ctypes

import torch

from signal_tpu_torch.ops.attention import true_fp32

HEAD_DIM = 64  # the only head dim the kernel takes: T2T's token_dim


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1)


def eager_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """``softmax((q·scale)·kᵀ)·v`` in fp32 ATen operations with TF32 off:
    the operator's route on the CPU."""
    with true_fp32():
        return _probs(q, k, scale) @ v


def _tma_fits(t: torch.Tensor) -> bool:
    """Whether TMA can read t [B, L, 64] as it lies: last stride 1, its
    row and batch strides multiples of 4 floats (16 bytes) that keep rows
    and batch rows apart, and a 16-byte aligned base."""
    batch, row, col = t.stride()
    return (col == 1 and row % 4 == 0 and batch % 4 == 0 and row >= HEAD_DIM
            and batch >= t.shape[1] * row and t.data_ptr() % 16 == 0)


def _operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v as the kernel reads them: each as it lies where
    :func:`_tma_fits`, else a contiguous copy. Raises unless they are fp32
    q [B, Lq, 64] and k, v [B, Lk, 64] on one device, none of B, Lq, Lk
    zero."""
    B, Lq = q.shape[:2] if q.dim() == 3 else (0, 0)
    Lk = k.shape[1] if k.dim() == 3 else 0
    if min(B, Lq, Lk) == 0 or q.shape[2] != HEAD_DIM or k.shape != (B, Lk, HEAD_DIM) or \
            v.shape != k.shape or \
            any(t.dtype != torch.float32 or t.device != q.device for t in (q, k, v)):
        raise ValueError("the token attention kernel takes fp32 q [B, Lq, 64] and k, v "
                         "[B, Lk, 64] on one device, got "
                         f"{[(t.dtype, tuple(t.shape), t.device) for t in (q, k, v)]}")
    return tuple(t if _tma_fits(t) else t.clone(memory_format=torch.contiguous_format)
                 for t in (q, k, v))


_lib = None


def _load() -> ctypes.CDLL:
    """The built library with its C signature declared (once)."""
    global _lib
    if _lib is None:
        from signal_tpu_torch.ops._build import load

        lib = load("token_attention")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.token_attention_fwd.argtypes = [p, p, p, p, i, i, i, ll, ll, ll, ll, ll, ll,
                                            ctypes.c_float, p]
        lib.token_attention_fwd.restype = i
        _lib = lib
    return _lib


def token_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Launch ``token_attention_fwd`` on the current stream: q [B, Lq, 64],
    k, v [B, Lk, 64] as they lie (strided views included) → o [B, Lq, 64]
    contiguous, ``softmax((q·scale)·kᵀ)·v`` fp32-accurate. Raises on CPU
    tensors and on inputs :func:`_operands` refuses. Counts each launch in
    ``token_attention_cuda.launches``."""
    if not q.is_cuda:
        raise ValueError(f"token_attention_cuda takes CUDA tensors, got q on {q.device}")
    q, k, v = _operands(q, k, v)
    B, Lq, Lk = q.shape[0], q.shape[1], k.shape[1]
    o = torch.empty(B, Lq, HEAD_DIM, dtype=torch.float32, device=q.device)
    rc = _load().token_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Lq, Lk,
        q.stride(1), q.stride(0), k.stride(1), k.stride(0), v.stride(1), v.stride(0),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"token_attention_fwd launch failed: cudaError {rc}")
    token_attention_cuda.launches += 1
    return o


token_attention_cuda.launches = 0


@torch.library.custom_op("signal_tpu_torch::token_attention", mutates_args=())
def _token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    if q.is_cuda:
        return token_attention_cuda(q, k, v, scale)
    return eager_core(q, k, v, scale)


@_token_attention.register_fake
def _token_attention_fake(q, k, v, scale):
    return q.new_empty(*q.shape[:-1], v.shape[-1])


def _token_attention_setup(ctx, inputs, output):
    q, k, v, scale = inputs
    ctx.scale = scale
    ctx.save_for_backward(q, k, v)


def _token_attention_bwd(ctx, g):
    q, k, v = ctx.saved_tensors
    s = ctx.scale
    with true_fp32():
        a = _probs(q, k, s)
        dv = a.transpose(-1, -2) @ g
        # autograd's softmax backward, one pass: A ⊙ (dA − rowsum(dA ⊙ A))
        ds = torch._softmax_backward_data(g @ v.transpose(-1, -2), a, -1, a.dtype)
        dq = (ds @ k) * s
        dk = ds.transpose(-1, -2) @ (q * s)
    return dq, dk, dv, None


_token_attention.register_autograd(_token_attention_bwd, setup_context=_token_attention_setup)


def token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """``softmax((q·scale)·kᵀ)·v`` through the registered operator. q, k, v
    [B, L, d] (one head) → [B, L, d], differentiable in all three."""
    token_attention.calls += 1
    return _token_attention(q, k, v, scale)


token_attention.calls = 0
