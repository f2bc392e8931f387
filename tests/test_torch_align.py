"""Port parity: the train forward's ops and modules below the model —
``euclidean_distmat``, ``gram_volume3``, ``bilinear_grid_sample``, DAS,
GAM, LAM and the training BNNeck — values and gradients against the JAX
package on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu.models import align as jalign
from signal_tpu.models.bnneck import bnneck_apply as jax_bnneck
from signal_tpu.ops.distmat import euclidean_distmat as jax_distmat
from signal_tpu.ops.grid_sample import bilinear_grid_sample as jax_grid_sample
from signal_tpu.ops.volume import gram_volume3 as jax_volume
from signal_tpu_torch.models import align as talign
from signal_tpu_torch.models.bnneck import BNNeck, bnneck_apply
from signal_tpu_torch.ops.distmat import euclidean_distmat
from signal_tpu_torch.ops.grid_sample import bilinear_grid_sample
from signal_tpu_torch.ops.volume import gram_volume3

from _torch_parity import TRAIN_TINY, tiny_pair, to_np


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def test_euclidean_distmat_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 48)).astype(np.float32)
    got = to_np(euclidean_distmat(_t(x), _t(x)))
    want = to_np(jax_distmat(jnp.asarray(x), jnp.asarray(x)))
    off = ~np.eye(9, dtype=bool)
    # true fp32 on both sides: summation order only
    np.testing.assert_allclose(got[off], want[off], atol=1e-4, rtol=1e-5)
    # a self-distance is ‖x‖² + ‖x‖² − 2‖x‖², rounding noise of a few fp32
    # ulps of ‖x‖² ≈ 48 (or clamped), rooted: small on both sides
    assert np.diag(got).max() < 5e-3 and np.diag(want).max() < 5e-3
    # an exact zero (integer-valued rows) is clamped at 1e-12, then rooted
    ints = _t(np.arange(12).reshape(3, 4))
    assert torch.equal(euclidean_distmat(ints, ints).diagonal(), torch.full((3,), 1e-6))


def test_gram_volume3_value_and_grad_match_jax():
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal((6, 16)).astype(np.float32) for _ in range(3))
    w = rng.standard_normal((6, 6)).astype(np.float32)

    def jloss(a, b, c):
        return jnp.sum(jax_volume(a, b, c) * w)

    want_v = jax_volume(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    ta, tb, tc = _t(a, True), _t(b, True), _t(c, True)
    v = gram_volume3(ta, tb, tc)
    got_g = torch.autograd.grad((v * _t(w)).sum(), (ta, tb, tc))
    # true-fp32 dots on both sides; the det cancels, so a few fp32 ulps of
    # the largest term (|det| up to ~1e4 here)
    np.testing.assert_allclose(to_np(v), to_np(want_v), atol=1e-3, rtol=1e-4)
    for x, y in zip(got_g, want_g):
        np.testing.assert_allclose(to_np(x), to_np(y), atol=2e-3, rtol=1e-3)
    # three equal vectors span no volume: eps inside the sqrt keeps the
    # value at sqrt(eps) and the gradient finite
    ta = _t(a[:1], True)
    v0 = gram_volume3(ta, ta, ta)
    (g0,) = torch.autograd.grad(v0.sum(), (ta,))
    assert v0.item() == pytest.approx(1e-6, rel=1e-2) and torch.isfinite(g0).all()


def test_bilinear_grid_sample_value_and_grads_match_jax():
    """F.grid_sample against the JAX gather form, with points past the
    border (zero padding) and exactly on it."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 3, 4, 2)).astype(np.float32)
    grid[0, 0, 0] = (1.0, 1.0)
    grid[1, 2, 3] = (-1.0, 0.5)
    w = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)

    def jloss(x, grid):
        return jnp.sum(jax_grid_sample(x, grid, align_corners=True) * w)

    want = jax_grid_sample(jnp.asarray(x), jnp.asarray(grid), align_corners=True)
    want_gx, want_gg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(grid))
    tx, tg = _t(x, True), _t(grid, True)
    out = bilinear_grid_sample(tx, tg, align_corners=True)
    gx, gg = torch.autograd.grad((out * _t(w)).sum(), (tx, tg))
    np.testing.assert_allclose(to_np(out), to_np(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(gx), to_np(want_gx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(gg), to_np(want_gg), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def align_pair():
    """(JAX AlignM params, the port's AlignM with the same weights)."""
    _, params, _, model = tiny_pair(base=TRAIN_TINY)
    return params["AlignM"], model.AlignM


def _patches(seed, B=4, h=4, w=4, D=64):
    return np.random.default_rng(seed).standard_normal((B, 3, h * w, D)).astype(np.float32)


def _grid(seed, h, w):
    """[B, C, h, w] feature maps."""
    return _patches(seed, h=h, w=w)[:, 0].reshape(4, h, w, 64).transpose(0, 3, 1, 2).copy()


def test_das_matches_jax(align_pair):
    jp, ta = align_pair
    x = _grid(3, 8, 8)          # a 2×2 grid of sample points
    pos_j = jalign.das_sample_positions(jp["DAS_r"], jnp.asarray(x))
    pos_t = talign.das_sample_positions(ta.DAS_r, _t(x))
    # the reference points exceed ±1 before the clamp: some positions sit on it
    assert np.abs(to_np(pos_t)).max() == 1.0
    np.testing.assert_allclose(to_np(pos_t), to_np(pos_j), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(to_np(talign.das_forward(ta.DAS_r, _t(x))),
                               to_np(jalign.das_forward(jp["DAS_r"], jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="at least 4x4"):
        talign.das_sample_positions(ta.DAS_r, _t(x[:, :, :2]))


def test_das_broadcasts_one_offset_channel_to_both_axes(align_pair):
    """The offset net has ONE output channel; (dy, dx) are that field times
    the per-axis range factors (the reference's [1, 2, 1, 1] reshape)."""
    _, ta = align_pair
    x = _grid(4, 12, 8)         # 3×2 sample points: range factors 1/2 (y), 1 (x)
    pos = talign.das_sample_positions(ta.DAS_r, _t(x))
    off = pos - talign.das_reference_points(3, 2)[None]
    assert pos.shape == (4, 3, 2, 2)
    inside = (pos.abs() < 1.0).all(dim=-1)
    assert inside.any()
    torch.testing.assert_close(2 * off[..., 0][inside], off[..., 1][inside])


def test_gam_and_lam_values_and_grads_match_jax(align_pair):
    jp, ta = align_pair
    p = _patches(5)

    def jloss(patches, jp):
        gam, lam = jalign.align_forward(jp, patches, h=4, w=4, stage="together_CLS_Patch")
        return gam + lam, (gam, lam)

    (_, (gam_j, lam_j)), (gp_j, gparams_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(p), jp)
    tp = _t(p, True)
    gam_t, lam_t = talign.align_forward(ta, tp, h=4, w=4, stage="together_CLS_Patch")
    params = [ta.contra_temp, ta.DAS_t.proj_q.weight, ta.DAS_n.conv_offset[2].weight]
    gp_t, *gparams_t = torch.autograd.grad(gam_t + lam_t, [tp, *params])
    # fp32 throughout; summation order only
    assert gam_t.item() == pytest.approx(float(gam_j), rel=1e-5)
    assert lam_t.item() == pytest.approx(float(lam_j), rel=1e-5)
    np.testing.assert_allclose(to_np(gp_t), to_np(gp_j), atol=1e-6, rtol=1e-4)
    want = [gparams_j["contra_temp"],
            np.asarray(gparams_j["DAS_t"]["proj_q"]["kernel"]).transpose(3, 2, 0, 1),
            np.asarray(gparams_j["DAS_n"]["off_dw"]["kernel"]).transpose(3, 2, 0, 1)]
    for a, b in zip(gparams_t, want):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-6, rtol=1e-4)
    gam_only, none = talign.align_forward(ta, tp, h=4, w=4, stage="CLS")
    assert none is None and gam_only.item() == gam_t.item()


def test_bnneck_train_step_and_running_stats_match_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((8, 12)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(12).astype(np.float32)
    mean0 = rng.standard_normal(12).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 12).astype(np.float32)
    w = rng.standard_normal((8, 12)).astype(np.float32)
    jparams = {"scale": jnp.asarray(scale), "bias": jnp.zeros(12)}
    jstate = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def jloss(x, s):
        y, st = jax_bnneck({"scale": s, "bias": jparams["bias"]}, jstate, x, training=True)
        return jnp.sum(y * w), (y, st)

    (_, (y_j, st_j)), (gx_j, gs_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jparams["scale"])
    bn = BNNeck(12)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    tx = _t(x, True)
    y = bnneck_apply(bn, tx, training=True)
    gx, gs = torch.autograd.grad((y * _t(w)).sum(), (tx, bn.weight))
    assert not bn.bias.requires_grad                 # frozen, as the reference's
    np.testing.assert_allclose(to_np(y), to_np(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(bn.running_mean), to_np(st_j["mean"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(to_np(bn.running_var), to_np(st_j["var"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(to_np(gx), to_np(gx_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(gs), to_np(gs_j), atol=1e-5, rtol=1e-5)
    # eval normalizes with the running stats and leaves them alone
    before = bn.running_var.clone()
    y_eval = bnneck_apply(bn, tx.detach(), training=False)
    y_jeval, _ = jax_bnneck(jparams, st_j, jnp.asarray(x), training=False)
    np.testing.assert_allclose(to_np(y_eval), to_np(y_jeval), atol=1e-5, rtol=1e-5)
    assert torch.equal(bn.running_var, before)
