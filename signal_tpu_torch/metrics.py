"""Retrieval metrics: CMC / mAP, market1501 + MSVR310 protocols, on the
device (port of `signal_tpu/metrics.py`).

* `eval_func`: per query, gallery entries with the same pid AND same camid
  are removed; CMC is the cumulative first-match curve over the kept
  ranking; AP is mean precision at the kept match positions; queries with
  no kept match are dropped.
* `eval_func_msvr`: removal is same pid AND same *scene* id.

The ranking is a STABLE argsort (``jnp.argsort`` is stable), so tied
distances rank by gallery index exactly as in the JAX package; the
per-query loop of the reference is cumsum algebra over the sorted
keep/match masks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _cmc_map_from_distmat(distmat: torch.Tensor, q_pids: torch.Tensor, g_pids: torch.Tensor,
                          q_remove_key: torch.Tensor, g_remove_key: torch.Tensor,
                          max_rank: int = 50) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Core protocol. remove ⇔ same pid AND same remove_key (camid or
    sceneid). → (cmc [max_rank], mAP scalar, num_valid_q scalar)."""
    order = torch.argsort(distmat, dim=1, stable=True)                # [Nq, Ng]
    g_pids_sorted = g_pids[order]
    g_key_sorted = g_remove_key[order]

    same_pid = g_pids_sorted == q_pids[:, None]
    matches = same_pid.float()
    remove = same_pid & (g_key_sorted == q_remove_key[:, None])
    keep = (~remove).float()

    kept_matches = matches * keep
    kept_rank = torch.cumsum(keep, dim=1)          # 1-based rank among kept entries
    cum_match = torch.cumsum(kept_matches, dim=1)

    num_rel = kept_matches.sum(dim=1)
    valid = num_rel > 0
    n_valid = valid.sum()

    prec = torch.where(kept_rank > 0, cum_match / kept_rank.clamp_min(1.0),
                       torch.zeros_like(cum_match))
    ap = (prec * kept_matches).sum(dim=1) / num_rel.clamp_min(1.0)
    mAP = torch.where(valid, ap, torch.zeros_like(ap)).sum() / n_valid.clamp_min(1).float()

    big = torch.full_like(kept_rank, 1e9)
    first_rank = torch.where(kept_matches > 0, kept_rank, big).amin(dim=1)  # [Nq]
    ranks = torch.arange(1, max_rank + 1, dtype=torch.float32, device=distmat.device)[None, :]
    hits = (first_rank[:, None] <= ranks).float()
    cmc = (hits * valid[:, None].float()).sum(dim=0) / n_valid.clamp_min(1).float()
    return cmc, mAP, n_valid


def eval_func(distmat, q_pids, g_pids, q_camids, g_camids, max_rank: int = 50):
    """market1501 protocol (same-pid & same-cam gallery entries removed)."""
    d = torch.as_tensor(distmat)
    cmc, mAP, nvalid = _cmc_map_from_distmat(
        d, torch.as_tensor(q_pids, device=d.device), torch.as_tensor(g_pids, device=d.device),
        torch.as_tensor(q_camids, device=d.device), torch.as_tensor(g_camids, device=d.device),
        max_rank=max_rank)
    if int(nvalid) == 0:
        raise ValueError("Error: all query identities do not appear in gallery")
    return cmc.cpu().numpy(), float(mAP)


def eval_func_msvr(distmat, q_pids, g_pids, q_camids, g_camids,
                   q_sceneids, g_sceneids, max_rank: int = 50):
    """MSVR310 protocol: the removal key is the scene id."""
    del q_camids, g_camids  # ranking unaffected; kept for signature parity
    d = torch.as_tensor(distmat)
    cmc, mAP, nvalid = _cmc_map_from_distmat(
        d, torch.as_tensor(q_pids, device=d.device), torch.as_tensor(g_pids, device=d.device),
        torch.as_tensor(q_sceneids, device=d.device), torch.as_tensor(g_sceneids, device=d.device),
        max_rank=max_rank)
    if int(nvalid) == 0:
        raise ValueError("Error: all query identities do not appear in gallery")
    return cmc.cpu().numpy(), float(mAP)


def dump_msvr_rank_lists(path: str, distmat, q_pids, g_pids, q_camids,
                         g_camids, q_sceneids, g_sceneids, max_rank: int = 50):
    """MSVR310 rank-list dump in the reference's `re.txt` format
    (`utils/metrics.py:38,71-78`): one `{pid}_s{scene}_v{cam}:` header per
    query followed by its kept top-`max_rank` gallery line."""
    distmat = (distmat.cpu().numpy() if torch.is_tensor(distmat) else np.asarray(distmat))
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    q_camids, g_camids = np.asarray(q_camids), np.asarray(g_camids)
    q_sceneids, g_sceneids = np.asarray(q_sceneids), np.asarray(g_sceneids)
    order = np.argsort(distmat, axis=1)
    with open(path, "w") as f:
        f.write("rank list file\n")
        for qi in range(distmat.shape[0]):
            o = order[qi]
            keep = ~((g_pids[o] == q_pids[qi]) & (g_sceneids[o] == q_sceneids[qi]))
            f.write(f"{q_pids[qi]}_s{q_sceneids[qi]}_v{q_camids[qi]}:\n")
            for vid, vsc, vcam in zip(g_pids[o][keep][:max_rank],
                                      g_sceneids[o][keep][:max_rank],
                                      g_camids[o][keep][:max_rank]):
                f.write(f"{vid}_s{vsc}_v{vcam}  ")
            f.write("\n")
    return path


class R1mAPEvaluator:
    """Feature accumulator + metric computation (reference `R1_mAP_eval`,
    `metrics.py:173-300`): features stay on their device; ``compute``
    normalizes, builds the distmat with one true-fp32 GEMM and ranks.

    ``scene_aware=True`` selects the MSVR310 protocol; ``rank_dump_path``
    additionally writes its `re.txt`-style rank lists. ``reranking=True``
    (TEST.RE_RANKING) ranks by k-reciprocal re-ranking with k1 = 50,
    k2 = 15, λ = 0.3 instead (:mod:`signal_tpu_torch.reranking`)."""

    def __init__(self, num_query: int, max_rank: int = 50, feat_norm: bool = True,
                 reranking: bool = False, scene_aware: bool = False,
                 rank_dump_path: Optional[str] = None):
        self.num_query = num_query
        self.reranking = reranking
        self.max_rank = max_rank
        self.feat_norm = feat_norm
        self.scene_aware = scene_aware
        self.rank_dump_path = rank_dump_path
        self.reset()

    def reset(self):
        self.feats = []
        self.pids = []
        self.camids = []
        self.sceneids = []
        self.img_paths = []

    def update(self, feat, pid, camid, sceneid=None, img_path=None):
        self.feats.append(torch.as_tensor(feat))
        self.pids.extend(np.asarray(pid).tolist())
        self.camids.extend(np.asarray(camid).tolist())
        if sceneid is not None:
            self.sceneids.extend(np.asarray(sceneid).tolist())
        if img_path is not None:
            self.img_paths.extend(list(img_path))

    def compute(self):
        feats = torch.cat(self.feats, dim=0).float()
        if self.feat_norm:
            feats = feats / (torch.linalg.norm(feats, dim=1, keepdim=True) + 1e-12)
        qf, gf = feats[: self.num_query], feats[self.num_query:]
        q_pids = np.asarray(self.pids[: self.num_query])
        g_pids = np.asarray(self.pids[self.num_query:])
        q_camids = np.asarray(self.camids[: self.num_query])
        g_camids = np.asarray(self.camids[self.num_query:])
        if self.reranking:
            from signal_tpu_torch.reranking import re_ranking

            distmat = re_ranking(qf, gf, k1=50, k2=15, lambda_value=0.3)
        else:
            from signal_tpu_torch.ops.distmat import euclidean_sqdist

            # the reference leaves the squared form unrooted — monotone, so
            # ranking-identical (`metrics.py:494-500`)
            distmat = euclidean_sqdist(qf, gf)

        if self.scene_aware:
            q_sc = np.asarray(self.sceneids[: self.num_query])
            g_sc = np.asarray(self.sceneids[self.num_query:])
            cmc, mAP = eval_func_msvr(distmat, q_pids, g_pids, q_camids,
                                      g_camids, q_sc, g_sc, self.max_rank)
            if self.rank_dump_path:
                dump_msvr_rank_lists(self.rank_dump_path, distmat, q_pids,
                                     g_pids, q_camids, g_camids, q_sc, g_sc,
                                     self.max_rank)
        else:
            cmc, mAP = eval_func(distmat, q_pids, g_pids, q_camids, g_camids,
                                 self.max_rank)
        return cmc, mAP, distmat, self.pids, self.camids, qf, gf
