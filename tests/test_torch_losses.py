"""Port parity: the train losses (label-smoothed CE, batch-hard triplet,
``make_loss`` and ``total_train_loss``), values and gradients against the
JAX package on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import config as jcfg_mod
from signal_tpu import losses as jl
from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch import losses as tl

from _torch_parity import to_np

# fp32 on both sides (the distance GEMM in true fp32): summation order only
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, B=8, C=5, D=16):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, C)) * 3).astype(np.float32)
    feats = rng.standard_normal((B, D)).astype(np.float32)
    labels = np.repeat(np.arange(B // 2), 2)          # P×K batch: 4 ids × 2
    return logits, feats, labels


def _grad_pair(jfn, tfn, *arrays):
    """(value, grads) of a scalar function of float arrays in both packages."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts, allow_unused=True)   # an unused input: zero
    tg = [torch.zeros_like(t) if g is None else g for t, g in zip(ts, tg)]
    return (to_np(tv), [to_np(g) for g in tg]), (to_np(jv), [to_np(g) for g in jg])


def test_cross_entropies_match_jax():
    logits, _, labels = _inputs(0)
    jt, tt = jnp.asarray(labels), torch.from_numpy(labels)
    (tv, tg), (jv, jg) = _grad_pair(
        lambda x: jl.cross_entropy_label_smooth(x, jt, 5),
        lambda x: tl.cross_entropy_label_smooth(x, tt, 5), logits)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)
    (tv, tg), (jv, jg) = _grad_pair(lambda x: jl.cross_entropy(x, jt),
                                    lambda x: tl.cross_entropy(x, tt), logits)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)


def test_hard_example_mining_matches_jax():
    rng = np.random.default_rng(1)
    dist = rng.random((8, 8)).astype(np.float32)
    labels = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    for a, b in zip(tl.hard_example_mining(torch.from_numpy(dist), torch.from_numpy(labels)),
                    jl.hard_example_mining(jnp.asarray(dist), jnp.asarray(labels))):
        np.testing.assert_array_equal(to_np(a), to_np(b))


@pytest.mark.parametrize("margin", [None, 0.3], ids=["soft-margin", "margin"])
def test_triplet_loss_matches_jax(margin):
    _, feats, labels = _inputs(2)
    jt, tt = jnp.asarray(labels), torch.from_numpy(labels)
    (tv, tg), (jv, jg) = _grad_pair(lambda f: jl.triplet_loss(f, jt, margin)[0],
                                    lambda f: tl.triplet_loss(f, tt, margin)[0], feats)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("overrides", [
    [],                                                          # softmax_triplet, smoothing on
    ["MODEL.IF_LABELSMOOTH", "off", "MODEL.NO_MARGIN", "False"],
    ["DATALOADER.SAMPLER", "softmax"],
], ids=["smooth-soft", "plain-margin", "softmax-only"])
def test_make_loss_and_total_train_loss_match_jax(overrides):
    path = "configs/RGBNT201/Signal.yml"
    tcfg, jcfg = tcfg_mod.load_config(path, overrides), jcfg_mod.load_config(path, overrides)
    logits, feats, labels = _inputs(3)
    logits2, feats2, _ = _inputs(4)
    gam, lam = np.array(0.7, np.float32), np.array(1.3, np.float32)
    jt, tt = jnp.asarray(labels), torch.from_numpy(labels)
    jfn, tfn = jl.make_loss(jcfg, 5), tl.make_loss(tcfg, 5)

    def total(mod, fn, y, s1, f1, s2, f2, g, l_):
        out = {"scores": [s1, s2], "feats": [f1, f2], "gam": g, "lam": l_}
        return mod.total_train_loss(out, y, fn, gram_weight=0.2, pat_weight=0.1)

    (tv, tg), (jv, jg) = _grad_pair(
        lambda *a: total(jl, jfn, jt, *a), lambda *a: total(tl, tfn, tt, *a),
        logits, feats, logits2, feats2, gam, lam)
    np.testing.assert_allclose(tv, jv, **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
    if tcfg.DATALOADER.SAMPLER == "softmax":
        return                      # one score per call (a list is the triplet samplers')
    # a list of heads: the first weighs 0.5, the mean of the rest 0.5
    lst = tfn([torch.from_numpy(logits), torch.from_numpy(logits2)],
              [torch.from_numpy(feats), torch.from_numpy(feats2)], tt)
    want = jfn([jnp.asarray(logits), jnp.asarray(logits2)],
               [jnp.asarray(feats), jnp.asarray(feats2)], jt)
    np.testing.assert_allclose(to_np(lst), to_np(want), **TOL)


def test_center_loss_is_not_ported_yet():
    """Ported now: a ``center`` METRIC_LOSS_TYPE builds the same per-head
    closure, and ``center_loss`` equals JAX's in value and in both
    gradients (centres and features)."""
    cfg = tcfg_mod.load_config("configs/RGBNT201/Signal.yml",
                               ["MODEL.METRIC_LOSS_TYPE", "triplet_center"])
    assert callable(tl.make_loss(cfg, 5))
    _, feats, labels = _inputs(9)
    centers = np.random.default_rng(10).standard_normal((5, feats.shape[1])).astype(np.float32)
    jv, jg = jax.value_and_grad(jl.center_loss, argnums=(0, 1))(
        jnp.asarray(centers), jnp.asarray(feats), jnp.asarray(labels))
    tc, tf = (torch.tensor(a, requires_grad=True) for a in (centers, feats))
    tv = tl.center_loss(tc, tf, torch.from_numpy(labels))
    tv.backward()
    np.testing.assert_allclose(to_np(tv), to_np(jv), **TOL)
    np.testing.assert_allclose(to_np(tc.grad), to_np(jg[0]), **TOL)
    np.testing.assert_allclose(to_np(tf.grad), to_np(jg[1]), **TOL)
