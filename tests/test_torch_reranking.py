"""Port parity: k-reciprocal re-ranking (`signal_tpu_torch.reranking`)
against `signal_tpu.reranking.re_ranking` on the same features, and the
evaluator's TEST.RE_RANKING path against the JAX evaluator's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import metrics as jmetrics
from signal_tpu.reranking import re_ranking as jax_re_ranking
from signal_tpu_torch import metrics as tmetrics
from signal_tpu_torch import reranking as trr

from _torch_parity import to_np

# fp32 on both sides; the JAX package's own tests hold it to a brute-force
# numpy version at the same tolerance
TOL = dict(rtol=1e-4, atol=1e-5)


def _features(seed, nq, ng, dim, tied):
    rng = np.random.default_rng(seed)
    if not tied:
        return (rng.standard_normal((nq, dim)).astype(np.float32),
                rng.standard_normal((ng, dim)).astype(np.float32))
    # small integers: every distance is exact in fp32 on both sides, and
    # repeated rows tie whole rows of the rank matrix (a stable sort
    # breaks each tie by index, as jnp.argsort does)
    feats = rng.integers(-2, 3, (nq + ng, dim)).astype(np.float32)
    feats[nq + 1::3] = feats[nq::3][: len(feats[nq + 1::3])]
    return feats[:nq], feats[nq:]


@pytest.mark.parametrize("nq,ng,dim,k1,k2,tied", [
    (8, 24, 16, 6, 3, False),       # tests/test_metrics.py's sizes
    (40, 280, 8, 10, 4, False),     # N = 320: two query blocks, 2.5 chunks
    (8, 24, 8, 6, 3, True),
    (40, 280, 8, 10, 4, True),
    (8, 24, 16, 5, 1, False),       # k1 odd (k1/2 rounds half to even), no query expansion
], ids=["small", "streamed", "small-tied", "streamed-tied", "k1-odd-k2-1"])
def test_re_ranking_matches_jax(nq, ng, dim, k1, k2, tied):
    qf, gf = _features(nq + ng, nq, ng, dim, tied)
    want = jax_re_ranking(jnp.asarray(qf), jnp.asarray(gf), k1=k1, k2=k2, lambda_value=0.3)
    got = trr.re_ranking(torch.from_numpy(qf), torch.from_numpy(gf), k1=k1, k2=k2,
                         lambda_value=0.3)
    assert got.shape == (nq, ng) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_jaccard_streaming_does_not_change_the_result():
    """Blocks and chunks that cut the query and gallery rows unevenly give
    the one-piece result."""
    qf, gf = _features(3, 10, 37, 8, False)
    feat = torch.from_numpy(np.concatenate([qf, gf]))
    sq = (feat * feat).sum(1)
    dist = sq[:, None] + sq[None, :] - 2.0 * feat @ feat.t()
    whole = trr._re_ranking_core(dist, 10, 6, 3, 0.3, block=64, chunk=256)
    pieces = trr._re_ranking_core(dist, 10, 6, 3, 0.3, block=3, chunk=5)
    torch.testing.assert_close(pieces, whole, rtol=0, atol=0)


def test_rank_matrix_is_stable_under_ties():
    d = torch.tensor([[0.0, 1.0, 1.0, 0.5], [1.0, 0.0, 1.0, 1.0]])
    assert trr._rank_matrix(d).tolist() == [[0, 2, 3, 1], [1, 0, 2, 3]]


@pytest.mark.parametrize("scene_aware", [False, True], ids=["market", "msvr"])
def test_evaluator_with_reranking_matches_jax(scene_aware):
    rng = np.random.default_rng(11)
    n_q, n = 10, 60
    feats = rng.standard_normal((n, 32)).astype(np.float32)
    pids, cams, scenes = rng.integers(0, 5, n), rng.integers(0, 3, n), rng.integers(0, 3, n)
    outs = []
    for mod, to in ((tmetrics, torch.from_numpy), (jmetrics, jnp.asarray)):
        ev = mod.R1mAPEvaluator(n_q, max_rank=10, reranking=True, scene_aware=scene_aware)
        for lo in range(0, n, 16):
            sl = slice(lo, lo + 16)
            ev.update(to(feats[sl]), pids[sl], cams[sl],
                      sceneid=scenes[sl] if scene_aware else None)
        cmc, mAP, distmat, *_ = ev.compute()
        outs.append((np.asarray(cmc), mAP, to_np(distmat)))
    (cmc_t, map_t, d_t), (cmc_j, map_j, d_j) = outs
    np.testing.assert_allclose(d_t, d_j, **TOL)
    np.testing.assert_allclose(cmc_t, cmc_j, atol=1e-6)
    assert map_t == pytest.approx(map_j, abs=1e-6)
