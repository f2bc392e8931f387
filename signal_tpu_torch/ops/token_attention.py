"""The tokens-to-token module's attention as a registered operator,
``torch.ops.signal_tpu_torch.token_attention``.

T2T's two token transformers (``models/t2t.token_transformer``) attend
with one head over the whole token width (64) at 2,048 and 512 tokens of
a 256×128 image, in fp32 whatever MODEL.COMPUTE_DTYPE, with the logits
scaled by the INPUT dim's ``dim^-1/2`` (147^-1/2, 576^-1/2), the
published quirk. The operator takes q, k, v [B, L, d] and that scale and
returns ``softmax((q·scale)·kᵀ)·v``; the v-skip and the out-projection
stay outside it.

Its body is the eager fp32 core, with TF32 off: the same operations, in
the same order, as the expression it replaced, so the same bits. Being an
operator, it is one host event in a profile (the device work under it is
linked to it by name) and the seam where a kernel can take its place.
Its backward (:func:`_token_attention_bwd`) saves q, k and v, not the
[B, L, L] probabilities (6.4 GB at a gallery batch's first stage), and
recomputes them, the same bits:

    dV = Aᵀ·dO,   dA = dO·Vᵀ,   dS = A ⊙ (dA − rowsum(dA ⊙ A)),
    dQ = (dS·K)·s,   dK = dSᵀ·(Q·s).

:func:`token_attention` calls the operator and counts its calls in
``token_attention.calls``.
"""

from __future__ import annotations

import torch

from signal_tpu_torch.ops.attention import true_fp32


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1)


@torch.library.custom_op("signal_tpu_torch::token_attention", mutates_args=())
def _token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    with true_fp32():
        return _probs(q, k, scale) @ v


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
