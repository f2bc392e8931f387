"""Port parity: the metric-learning zoo (`signal_tpu_torch.losses_metric`)
against `signal_tpu.losses_metric`, values and input gradients, on
`tests/test_losses_metric.py`'s PK batch (P 4, K 4, D 32, C 7)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import losses_metric as jm
from signal_tpu_torch import losses_metric as tm

from _torch_parity import to_np

P, K, D, C = 4, 4, 32, 7
B = P * K
# fp32 on both sides, every product true fp32: summation order only
TOL = dict(rtol=1e-5, atol=1e-6)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, B, D)).astype(np.float32)
    weight = rng.standard_normal((C, D)).astype(np.float32)
    clabels = rng.integers(0, C, size=B)
    labels = np.repeat(np.arange(P), K)                       # PK-ordered
    return feats, weight, clabels, labels


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _compare(jfn, tfn, arrays, cotangent_seed=7, tol=TOL):
    """Each function's outputs and the gradients of ⟨outputs, a random
    cotangent⟩ with respect to every float input, in both packages."""
    ja = [jnp.asarray(a) for a in arrays]
    jout = jfn(*ja)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    rng = np.random.default_rng(cotangent_seed)
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in jouts]

    def jscalar(*xs):
        o = jfn(*xs)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * jnp.asarray(c)) for a, c in zip(o, cots))

    jgrads = jax.grad(jscalar, argnums=tuple(range(len(ja))))(*ja)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tout = tfn(*ts)
    touts = tout if isinstance(tout, tuple) else (tout,)
    tscalar = sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cots))
    tgrads = torch.autograd.grad(tscalar, ts)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(to_np(t), to_np(j), **tol)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(to_np(t), to_np(j), **tol)
    return touts, tgrads


# (keyword arguments, the head's scale s: 30 by default, circle's 256)
HEADS = {
    "arcface": (dict(), 30.0),
    "arcface-easy-ls": (dict(easy_margin=True, ls_eps=0.1), 30.0),
    "cosface": (dict(), 30.0),
    "amsoftmax": (dict(), 30.0),
    "circle": (dict(), 256.0),
}


@pytest.mark.parametrize("name", list(HEADS))
def test_margin_heads_match_jax(name):
    """A head's logits are s times a cosine (circle's up to s·(1 + m)²), and
    the two packages' products round a cosine a few ulps apart (XLA's dot
    sums in another order than torch's, 4.5e-8 on the same unit rows): so
    besides rtol 1e-5 an element is held to s·2^-22 absolute, two fp32 ulps
    of a cosine near 1 times the scale."""
    feats, weight, clabels, _ = _batch()
    fn = name.split("-")[0] + "_logits"
    kw, s = HEADS[name]
    jl, tl = jnp.asarray(clabels), torch.from_numpy(clabels)
    _compare(lambda f, w: getattr(jm, fn)({"weight": w}, f, jl, **kw),
             lambda f, w: getattr(tm, fn)({"weight": w}, f, tl, **kw), [feats[0], weight],
             tol=dict(rtol=1e-5, atol=1e-6 + s * 2.0 ** -22))


# (the loss, the norm its rows are scaled to or None)
LOSSES = {
    # the contrastive loss tests sim < 1 to drop the self pair, which
    # assumes unit rows; at norm exactly 1 the self-product rounds either
    # side of 1 and each package may keep another anchor's self pair, so
    # the rows are held just inside (self pairs in) and just outside
    # (self pairs out)
    "contrastive-self-pairs-in": (lambda m, f, y: m.contrastive_loss(f[0], y, 0.3), 0.99),
    "contrastive-self-pairs-out": (lambda m, f, y: m.contrastive_loss(f[0], y, 0.3), 1.01),
    "cluster": (lambda m, f, y: m.cluster_loss(f[0], K, margin=10.0), None),
    "range": (lambda m, f, y: m.range_loss(f[0], K, k=2, margin=0.1), None),
    "range-wide-margin": (lambda m, f, y: m.range_loss(f[0], K, k=3, margin=20.0,
                                                       alpha=0.3, beta=0.7), None),
    "hetero-l2": (lambda m, f, y: m.hetero_center_loss(f[0], f[1], K, "l2"), None),
    "hetero-l1": (lambda m, f, y: m.hetero_center_loss(f[0], f[1], K, "l1"), None),
    "hetero-cos": (lambda m, f, y: m.hetero_center_loss(f[0], f[1], K, "cos"), None),
    "multi-modal-margin": (lambda m, f, y: m.multi_modal_margin_loss(f[0], f[1], f[2], K,
                                                                     margin=3.0), None),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(name):
    feats, _, _, labels = _batch(1)
    fn, norm = LOSSES[name]
    if norm is not None:
        feats = (norm * _unit(feats)).astype(np.float32)
    jy, ty = jnp.asarray(labels), torch.from_numpy(labels)
    outs, grads = _compare(lambda f: fn(jm, f, jy), lambda f: fn(tm, f, ty), [feats])
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert grads[0].abs().sum() > 0


def test_circle_alpha_is_detached():
    """The gradient of circle's logits flows through sim only, not through
    α_p/α_n (the reference's ``.detach()``): it equals JAX's and differs
    from the gradient with α left attached."""
    feats, weight, clabels, _ = _batch(2)
    f = torch.from_numpy(feats[0]).requires_grad_(True)
    w = {"weight": torch.from_numpy(weight)}
    labels = torch.from_numpy(clabels)
    g = torch.autograd.grad(tm.circle_logits(w, f, labels).square().sum(), f)[0]
    want = jax.grad(lambda x: jnp.sum(jm.circle_logits(
        {"weight": jnp.asarray(weight)}, x, jnp.asarray(clabels)) ** 2))(jnp.asarray(feats[0]))
    np.testing.assert_allclose(to_np(g), to_np(want), **TOL)

    def attached(x, s=256.0, m=0.25):
        sim = tm._cosine(w, x)
        onehot = torch.nn.functional.one_hot(labels, C).float()
        return (onehot * s * torch.relu(-sim + 1 + m) * (sim - (1 - m))
                + (1 - onehot) * s * torch.relu(sim + m) * (sim - m))

    g_att = torch.autograd.grad(attached(f).square().sum(), f)[0]
    assert not torch.allclose(g, g_att, rtol=1e-2)


def _integer_members(seed):
    """[P, K, D] small-integer features: every sum and distance below is
    exact, so equal distances tie to the bit in both packages."""
    return np.random.default_rng(seed).integers(-3, 4, (P, K, D)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2])
def test_range_loss_ties_match_jax(k):
    """Tied distances: each class holds a repeated member a and a far one
    c, so d(a, c) appears four times at the top of the sorted distances.
    The stable sort sends the gradient to the same copy of a as JAX's (the
    first by flat index), so the two copies' gradients differ."""
    f = _integer_members(3)
    f[:, 1] = f[:, 0]
    f[:, 3] = f[:, 0] + 8.0                  # the far member
    _, grads = _compare(lambda x: jm.range_loss(x, K, k=k, margin=30.0),
                        lambda x: tm.range_loss(x, K, k=k, margin=30.0), [f.reshape(B, D)])
    g = grads[0].reshape(P, K, D)
    assert not torch.allclose(g[:, 0], g[:, 1])


def test_cluster_loss_ties_match_jax():
    """Two members equally far from their centre: ``amax`` shares the
    gradient between them, as JAX's max does."""
    c, d = _integer_members(5)[:, :1], _integer_members(6)[:, :1]
    # members c ± 2d and c ± d: the centre is c, the two far members tie
    f = np.concatenate([c + 2 * d, c - 2 * d, c + d, c - d], axis=1)
    _, grads = _compare(lambda x: jm.cluster_loss(x, K, margin=50.0),
                        lambda x: tm.cluster_loss(x, K, margin=50.0), [f.reshape(B, D)])
    # an even share leaves the centre no gradient from the maximum, so the
    # two tied members' gradients sum to the two others' (the inter-centre
    # term, the same for every member); all to one would shift both sums
    g = grads[0].reshape(P, K, D)
    assert not torch.allclose(g[:, 0], g[:, 1])
    torch.testing.assert_close(g[:, 0] + g[:, 1], g[:, 2] + g[:, 3])


@pytest.mark.parametrize("kind", ["arcface", "cosface", "circle", "amsoftmax"])
def test_margin_head_init_laws(kind):
    """Shape, mean and variance of each kind's law (JAX draws its own
    bits; the port draws from a torch generator): xavier-uniform
    U(±√(6/(in+out))), kaiming-uniform(a=√5) U(±√(1/in)), xavier-normal
    N(0, 2/(in+out))."""
    din, dout = 512, 171
    p = tm.init_margin_head(torch.Generator().manual_seed(0), din, dout, kind)
    j = jm.init_margin_head(jax.random.PRNGKey(0), din, dout, kind)
    w = p["weight"]
    assert w.shape == j["weight"].shape == (dout, din) and w.dtype == torch.float32
    var = {"arcface": 2.0 / (din + dout), "cosface": 2.0 / (din + dout),
           "circle": 1.0 / (3 * din), "amsoftmax": 2.0 / (din + dout)}[kind]
    n = w.numel()
    for x in (to_np(w), to_np(j["weight"])):
        assert abs(x.mean()) < 4 * math.sqrt(var / n)
        assert abs(x.var() / var - 1) < 0.03
    if kind != "amsoftmax":
        bound = math.sqrt(3 * var)
        assert w.abs().max() <= bound and w.abs().max() > 0.99 * bound
    with pytest.raises(ValueError, match="unknown margin head"):
        tm.init_margin_head(torch.Generator(), din, dout, "nope")
