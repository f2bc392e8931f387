"""Top-k → binary-mask ops for SIM token selection (port of
`signal_tpu/ops/topk_mask.py`).

``lax.top_k`` breaks ties toward the lowest index (`tests/test_topk_ties.py`)
while ``torch.topk`` leaves tie order undefined, so the top k here are the
first k of a STABLE descending sort: equal scores keep index order, and
the masks equal the JAX package's even under ties.
"""

from __future__ import annotations

import torch


def scatter_mask(indices: torch.Tensor, length: int) -> torch.Tensor:
    """[B, K] int indices → [B, length] {0,1} float mask."""
    out = torch.zeros(indices.shape[0], length, dtype=torch.float32, device=indices.device)
    return out.scatter_(1, indices, 1.0)


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] → [B, k] indices of the k largest per row, ties to the lowest
    index (``lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] scores → [B, L] mask with 1s at the top-k positions per row."""
    k = min(k, scores.shape[-1])
    return scatter_mask(topk_indices(scores, k), scores.shape[-1])


def exact_keep(mask: torch.Tensor, scores: torch.Tensor, max_keep: int) -> torch.Tensor:
    """Trim/fill ``mask`` to exactly ``max_keep`` ones per row: rank by
    score + BIG·selected and take the top ``max_keep`` (the closed form of
    the reference's keep_ratio loop, `useA.py:265-314`)."""
    big = (scores.abs().max() + 1.0) * 4.0
    return topk_mask(scores + big * mask, max_keep)
