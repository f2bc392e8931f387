"""Mixture-of-Experts MLP for the ViT blocks on one device (port of
`signal_tpu/ops/moe.py`).

MODEL.MOE_EXPERTS > 1 swaps each CLIP block's dense MLP for a top-k
routed expert MLP (Switch/GShard), and the load-balance aux loss it emits
is weighted by MODEL.MoE_Loss_weight (the reference declares that knob
and reads it nowhere). The JAX module's formulation is kept: static
shapes, a fixed expert capacity ``C`` per token group (one image row of
L tokens), one-hot dispatch and combine tensors, the kept tokens' slots
in row order (a cumsum, no RNG), and dropped tokens contributing zero, so
the residual stream carries them unchanged. The router runs in fp32.

Parameters keep the JAX tree's layout and names, since the reference has
none for them: ``router [d, E]`` (fp32), ``fc_kernel [E, d, h]``,
``fc_bias [E, h]``, ``proj_kernel [E, h, d]``, ``proj_bias [E, d]``; in a
block they are ``transformer.resblocks.{i}.moe.*``.

The expert products take compute-dtype operands with fp32 accumulation on
every device, one :func:`matmul_f32` per expert: the TPU semantics. The
JAX module widens the whole layer to fp32 off the TPU only to work around
XLA:CPU, so in bf16 on the CPU the two packages differ; parity is held in
fp32. The dispatch and combine products multiply by one-hot entries and
sum at most k nonzero terms, so they are exact in fp32 from compute-dtype
values and run as fp32 einsums. The expert-parallel axis
(``moe_constrain``) comes with scale-out.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from signal_tpu_torch.ops.attention import matmul_f32, quick_gelu, trunc_normal_


class MoE(nn.Module):
    """One block's routed expert MLP: the router and the expert-stacked
    dense weights (the forward is :func:`moe_mlp`)."""

    def __init__(self, width: int, hidden: int, num_experts: int):
        super().__init__()
        self.router = nn.Parameter(torch.empty(width, num_experts))
        self.fc_kernel = nn.Parameter(torch.empty(num_experts, width, hidden))
        self.fc_bias = nn.Parameter(torch.zeros(num_experts, hidden))
        self.proj_kernel = nn.Parameter(torch.empty(num_experts, hidden, width))
        self.proj_bias = nn.Parameter(torch.zeros(num_experts, width))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """`init_moe_params`: the router and every expert trunc-normal
        (σ 0.02, each expert drawn on its own, as the dense MLP it
        replaces), zero biases."""
        for p in (self.router, self.fc_kernel, self.proj_kernel):
            trunc_normal_(p, gen)
        self.fc_bias.zero_()
        self.proj_bias.zero_()


def upcycle_dense_mlp(fc_weight: torch.Tensor, fc_bias: torch.Tensor,
                      proj_weight: torch.Tensor, proj_bias: torch.Tensor,
                      num_experts: int) -> Dict[str, torch.Tensor]:
    """Sparse upcycling (Komatsuzaki et al.): a dense MLP given in
    ``nn.Linear`` layout (``c_fc.weight [h, d]``, ``c_proj.weight [d, h]``)
    tiled into every expert → the :class:`MoE` tensors but the router.
    With the router at its fresh init, step 0 computes the dense model:
    normalised gates make identical experts sum to the dense MLP, and only
    over-capacity drops deviate."""
    def tile(a):
        return a[None].expand(num_experts, *a.shape).clone()

    return {"fc_kernel": tile(fc_weight.t()), "fc_bias": tile(fc_bias),
            "proj_kernel": tile(proj_weight.t()), "proj_bias": tile(proj_bias)}


def moe_capacity(group_len: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-group expert capacity C."""
    return max(1, int(math.ceil(capacity_factor * top_k * group_len / num_experts)))


def _route(probs: torch.Tensor, top_k: int, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs [G, S, E] → (combine [G, S, E, C], top1_mask [G, S, E]).

    Iterative top-k (argmax, mask, repeat; the first index on ties, as
    JAX's argmax) with per-group capacity: earlier choices take slots
    first, and within one choice tokens take slots in row order. Gates are
    normalised over the chosen experts, so with k = 1 a kept token passes
    at weight exactly 1.0; there the denominator is held constant in the
    backward (straight-through), so the task loss still trains the router
    (d gate / d p = 1 / p)."""
    G, S, E = probs.shape
    remaining = probs
    onehots, gates = [], []
    for _ in range(top_k):
        oh = torch.nn.functional.one_hot(remaining.argmax(dim=-1), E).to(probs.dtype)
        gates.append((remaining * oh).sum(dim=-1))
        remaining = remaining * (1.0 - oh)
        onehots.append(oh)
    denom = sum(gates) + 1e-9
    if top_k == 1:
        denom = denom.detach()
    gates = [g / denom for g in gates]

    slots = torch.arange(capacity, device=probs.device, dtype=probs.dtype)
    combine = probs.new_zeros(G, S, E, capacity)
    offset = probs.new_zeros(G, 1, E)                         # slots used
    for oh, gate in zip(onehots, gates):
        pos_in_e = torch.cumsum(oh, dim=1) - oh + offset      # [G, S, E]
        pos = (pos_in_e * oh).sum(dim=-1)                     # [G, S]
        # a position at or past the capacity matches no slot: the token
        # drops out of combine, gate included
        poh = (pos[..., None] == slots).to(probs.dtype)       # [G, S, C]
        combine = combine + (oh * gate[..., None])[..., None] * poh[:, :, None, :]
        offset = offset + oh.sum(dim=1, keepdim=True)
    return combine, onehots[0]


def moe_route(moe: MoE, x: torch.Tensor, *, top_k: int, capacity_factor: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 router of x [G, S, d] → (combine [G, S, E, C], aux).

    aux is the Switch load-balance loss E·Σ_e f_e·P_e over all tokens
    (f_e: the share routed first to e; P_e: the mean router probability),
    1.0 at perfect balance."""
    G, S, _ = x.shape
    E = moe.router.shape[-1]
    capacity = moe_capacity(S, E, top_k, capacity_factor)
    probs = torch.softmax(x.float() @ moe.router.float(), dim=-1)
    combine, top1 = _route(probs, top_k, capacity)
    aux = E * (top1.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()
    return combine, aux


def moe_dispatch(combine: torch.Tensor, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Each expert's slots: [G, E, C, d] in the compute dtype (JAX's
    ``moe_dispatch``)."""
    dispatch = (combine > 0).float()
    xc = x.to(compute_dtype).float()
    return torch.einsum("gsec,gsd->gecd", dispatch, xc).to(compute_dtype)


def moe_hidden(moe: MoE, expert_in: torch.Tensor, compute_dtype) -> torch.Tensor:
    """fc → QuickGELU per expert: [G, E, C, h] in the compute dtype (JAX's
    ``moe_hidden``)."""
    h = torch.stack([matmul_f32(expert_in[:, e], moe.fc_kernel[e].to(compute_dtype))
                     for e in range(expert_in.shape[1])], dim=1)
    return quick_gelu(h + moe.fc_bias.float()[None, :, None, :]).to(compute_dtype)


def moe_combine(moe: MoE, h: torch.Tensor, combine: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """proj per expert, then each token's gated sum over its slots → fp32
    [G, S, d]."""
    out = torch.stack([matmul_f32(h[:, e], moe.proj_kernel[e].to(compute_dtype))
                       for e in range(h.shape[1])], dim=1)
    out = (out + moe.proj_bias.float()[None, :, None, :]).to(compute_dtype)
    return torch.einsum("gsec,gecd->gsd", combine.to(compute_dtype).float(), out.float())


def moe_mlp(moe: MoE, x: torch.Tensor, *, top_k: int = 1, capacity_factor: float = 1.25,
            compute_dtype=torch.bfloat16, expert_in: torch.Tensor | None = None,
            hidden: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [G, S, d] (post-ln_2 tokens, grouped by image row) → (y [G, S, d]
    fp32, aux fp32 scalar). ``expert_in`` (:func:`moe_dispatch`'s output)
    or ``hidden`` (:func:`moe_hidden`'s), when a remat segment kept them,
    are used instead of being computed again; the routing always is."""
    combine, aux = moe_route(moe, x, top_k=top_k, capacity_factor=capacity_factor)
    if hidden is None:
        if expert_in is None:
            expert_in = moe_dispatch(combine, x, compute_dtype)
        hidden = moe_hidden(moe, expert_in, compute_dtype)
    return moe_combine(moe, hidden, combine, compute_dtype), aux
