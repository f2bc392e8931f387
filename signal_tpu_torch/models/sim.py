"""SIM — Selective Interaction Module (port of `signal_tpu/models/sim.py`).

* intra-modal selection: per-modality CLS attends its own patches; top-k1
  mask;
* inter-modal selection: projected CLS stack attends the 3L concatenated
  patches; per-modality cross-scores exclude the own modality; top-2k
  indices mapped back onto per-modality masks;
* union of masks, optional exact keep_ratio trim/fill;
* masked (zeroed) patches fused into the CLS stack by an 8-head MHCA + FFN
  block, output [B, 3·dim]. The MHCA takes the eager attention core, as in
  the JAX package (`sim.py:142` calls ``mha`` without ``use_flash``).

Selection scores and the W_q/W_k projections are true fp32, so top-k
choices do not depend on the platform's matmul passes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from signal_tpu_torch.ops.attention import (
    MultiheadAttentionParams,
    layer_norm,
    linear,
    mha,
    true_fp32,
)
from signal_tpu_torch.ops.topk_mask import exact_keep, scatter_mask, topk_indices, topk_mask


class TokenSelection(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # W_v exists in the reference but is unused (`useA.py:48`); kept
        # for checkpoint-shape parity
        self.W_q = nn.Linear(dim, dim)
        self.W_k = nn.Linear(dim, dim)
        self.W_v = nn.Linear(dim, dim)


class ModalInteractive(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.cross_attn = MultiheadAttentionParams(dim)
        self.ffn = nn.Sequential(nn.Linear(dim, 2 * dim), nn.GELU(), nn.Linear(2 * dim, dim))
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)


class SIM(nn.Module):
    """Parameters with the reference's ``SIM.*`` names; the forward is
    :func:`sim_forward`."""

    def __init__(self, dim: int):
        super().__init__()
        self.token_selection = TokenSelection(dim)
        self.modal_interactive = ModalInteractive(dim)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """`signal_tpu/models/sim.py::init_sim_params`: nn.Linear's default
        U(±1/√din) for weights and biases, ``init_mha`` for the MHCA."""
        lins = [self.token_selection.W_q, self.token_selection.W_k,
                self.token_selection.W_v, self.modal_interactive.ffn[0],
                self.modal_interactive.ffn[2]]
        for lin in lins:
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=gen)
            lin.bias.uniform_(-bound, bound, generator=gen)
        self.modal_interactive.cross_attn.reset_parameters(gen)
        self.modal_interactive.norm1.reset_parameters()
        self.modal_interactive.norm2.reset_parameters()


def _intra_masks(patches: torch.Tensor, cls: torch.Tensor, k1: int) -> torch.Tensor:
    """patches [B, 3, L, D], cls [B, 3, D] → masks [B, 3, L]."""
    dim = patches.shape[-1]
    with true_fp32():
        scores = torch.einsum("bmd,bmld->bml", cls, patches) / math.sqrt(dim)
    scores = torch.softmax(scores.float(), dim=-1)
    B, M, L = scores.shape
    return topk_mask(scores.reshape(B * M, L), k1).reshape(B, M, L)


def _inter_masks(patches: torch.Tensor, cls: torch.Tensor, sel: TokenSelection,
                 k2: int) -> torch.Tensor:
    """Cross-modal selection. patches [B, 3, L, D], cls [B, 3, D] → [B, 3, L]."""
    B, M, L, D = patches.shape
    with true_fp32():
        q = linear(sel.W_q.weight, sel.W_q.bias, cls, torch.float32)            # [B, 3, D]
        k = linear(sel.W_k.weight, sel.W_k.bias, patches.reshape(B, M * L, D),
                   torch.float32)                                              # [B, 3L, D]
        scores = torch.einsum("bmd,bnd->bmn", q, k) / math.sqrt(D)
    scores = torch.softmax(scores.float(), dim=-1)                              # [B, 3, 3L]

    # for querying modality m, the two other modalities' score slices are
    # concatenated in ascending modality order (`useA.py:136-151`)
    others = [[1, 2], [0, 2], [0, 1]]
    kk = min(k2, 2 * L)
    votes = torch.zeros(B, M, L, dtype=torch.float32, device=patches.device)
    for m in range(M):
        a, b = others[m]
        cross = torch.cat([scores[:, m, a * L:(a + 1) * L],
                           scores[:, m, b * L:(b + 1) * L]], dim=-1)           # [B, 2L]
        flat = scatter_mask(topk_indices(cross, kk), 2 * L)                    # [B, 2L]
        votes[:, a] = torch.maximum(votes[:, a], flat[:, :L])
        votes[:, b] = torch.maximum(votes[:, b], flat[:, L:])
    return votes


def token_selection(patches: torch.Tensor, cls: torch.Tensor, sel: TokenSelection, *,
                    k: int, keep_ratio: float | None = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (selected_patches [B, 3, L, D], masks [B, 3, L])."""
    B, M, L, D = patches.shape
    inter = _inter_masks(patches, cls, sel, 2 * k)
    intra = _intra_masks(patches, cls, min(k, L))
    masks = ((inter + intra) > 0).float()
    if keep_ratio is not None:
        max_keep = int(L * keep_ratio)
        # raw CLS·patch scores (no softmax/scale), `useA.py:259-261`
        with true_fp32():
            raw = torch.einsum("bmd,bmld->bml", cls, patches).float()
        masks = exact_keep(masks.reshape(B * M, L), raw.reshape(B * M, L),
                           max_keep).reshape(B, M, L)
    return patches * masks[..., None], masks


def modal_interactive(mi: ModalInteractive, selected: torch.Tensor, cls: torch.Tensor, *,
                      num_heads: int = 8, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """MHCA fusion → [B, 3·D]. selected [B, 3, L, D], cls [B, 3, D]."""
    B, M, L, D = selected.shape
    kv = selected.reshape(B, M * L, D)
    attn = mha(mi.cross_attn, cls, kv, num_heads=num_heads, compute_dtype=compute_dtype)
    x = layer_norm(mi.norm1, cls + attn)
    fc1, fc2 = mi.ffn[0], mi.ffn[2]
    h = F.gelu(linear(fc1.weight, fc1.bias, x, compute_dtype), approximate="none")
    h = linear(fc2.weight, fc2.bias, h, compute_dtype)
    x = layer_norm(mi.norm2, x + h)
    return x.reshape(B, M * D)


def sim_forward(sim: SIM, patches: torch.Tensor, cls: torch.Tensor, *, k: int,
                keep_ratio: float | None = None, compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full SIM. patches [B, 3, L, D] (RGB, NI, TI order), cls [B, 3, D] →
    (fused [B, 3·D], {'RGB','NI','TI'}: masks [B, L])."""
    selected, masks = token_selection(patches, cls, sim.token_selection, k=k,
                                      keep_ratio=keep_ratio)
    fused = modal_interactive(sim.modal_interactive, selected, cls,
                              compute_dtype=compute_dtype)
    return fused, {"RGB": masks[:, 0], "NI": masks[:, 1], "TI": masks[:, 2]}
