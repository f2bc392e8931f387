"""k-reciprocal re-ranking (CVPR'17) as dense algebra on the features'
device (port of `signal_tpu/reranking.py`, itself the reference's
`utils/reranking.py:29-100` re-expressed).

* rank positions from a STABLE argsort (``jnp.argsort`` is stable, so tied
  distances rank by index exactly as in the JAX package) → rank matrix;
* k-reciprocal sets R(i) = {j : rank_i(j) ≤ k1 ∧ rank_j(i) ≤ k1}, and the
  half-k sets Rh with k1/2 rounded half to even (``np.around``);
* candidate expansion: R(i) ∪= Rh(j) for j ∈ R(i) with
  |Rh(j) ∩ R(i)| > 2/3 |Rh(j)|, the overlap counts one GEMM;
* V rows: exp(−d) masked by the expanded set, L1-normalized; query
  expansion V ← mean of V over each row's k2 nearest (a GEMM);
* Jaccard: Σ_k min(Vq[i,k], V[j,k]) streamed over [block, chunk, N]
  pieces, never [block, N, N].

Every GEMM runs in true fp32 (no TF32 on the card). Like the JAX package
it keeps fp32 where the reference accumulates in fp16.
"""

from __future__ import annotations

import numpy as np
import torch

from signal_tpu_torch.ops.attention import true_fp32


def _rank_matrix(dist: torch.Tensor) -> torch.Tensor:
    """rank[i, j] = position of j in row i's ascending ordering (0-based)."""
    order = torch.argsort(dist, dim=1, stable=True)
    pos = torch.arange(dist.shape[1], device=dist.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, pos)


def _re_ranking_core(original_dist: torch.Tensor, num_query: int, k1: int, k2: int,
                     lambda_value: float, block: int = 32, chunk: int = 128) -> torch.Tensor:
    """original_dist [N, N] (queries first) → re-ranked [Nq, N − Nq]."""
    n = original_dist.shape[0]
    # the reference's transpose(dist / colmax) (`reranking.py:46`)
    d = (original_dist / original_dist.amax(dim=0, keepdim=True)).t().contiguous()
    rank = _rank_matrix(d)

    # forward top-(k1+1) includes self (distance 0 ranks first)
    f1 = rank <= k1
    R = f1 & f1.t()
    fh = rank <= int(np.around(k1 / 2))
    Rh = fh & fh.t()

    Rf, Rhf = R.float(), Rh.float()
    with true_fp32():
        overlap = Rf @ Rhf.t()                             # |R(i) ∩ Rh(j)|
        passes = R & (overlap > (2.0 / 3.0) * Rhf.sum(dim=1)[None, :])
        expanded = R | ((passes.float() @ Rhf) > 0)
        w = torch.exp(-d) * expanded.float()
        V = w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)
        if k2 != 1:
            V = ((rank < k2).float() @ V) / k2             # k2 nearest incl. self

    # V rows are L1-normalized, so jaccard = 1 − minsum / (2 − minsum)
    minsum = torch.empty(num_query, n, dtype=V.dtype, device=V.device)
    for q0 in range(0, num_query, block):
        vq = V[q0:min(q0 + block, num_query)]
        for c0 in range(0, n, chunk):
            v = V[c0:c0 + chunk]
            minsum[q0:q0 + vq.shape[0], c0:c0 + v.shape[0]] = torch.minimum(
                vq[:, None, :], v[None, :, :]).sum(dim=-1)
    jaccard = 1.0 - minsum / (2.0 - minsum)
    final = jaccard * (1 - lambda_value) + d[:num_query] * lambda_value
    return final[:, num_query:]


def re_ranking(probFea: torch.Tensor, galFea: torch.Tensor, k1: int, k2: int,
               lambda_value: float) -> torch.Tensor:
    """`utils/reranking.py:29`'s API for global features (its local-distance
    arguments have no caller): query and gallery features, on the device
    that should do the work → the re-ranked [Nq, Ng] distance matrix, fp32,
    on that device."""
    feat = torch.cat([probFea, galFea.to(probFea.device)], dim=0).float()
    sq = (feat * feat).sum(dim=1)
    with true_fp32():
        original_dist = sq[:, None] + sq[None, :] - 2.0 * feat @ feat.t()
    return _re_ranking_core(original_dist, probFea.shape[0], int(k1), int(k2),
                            float(lambda_value))
