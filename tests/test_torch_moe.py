"""Port parity: MoE on one device (`signal_tpu_torch/ops/moe.py` against
`signal_tpu/ops/moe.py`), after the single-device cases of
`tests/test_moe.py`.

The same seeded expert weights and tokens go through both ``moe_mlp``s in
fp32: the JAX module widens the layer to fp32 off the TPU, so fp32 is
where the two compute the same thing (the port keeps bf16 operands on
every device, a standing divergence that the bf16 cases here hold against
the dense MLP instead). Then the MoE tower through ``forward_eval`` and
its remat segments, and the CLIP import's sparse upcycling.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu.models import signal_model as jsm
from signal_tpu.ops import moe as jmoe
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.ops import moe as tmoe
from signal_tpu_torch.ops.attention import linear, quick_gelu

from _torch_parity import TRAIN_IMG_HW, TRAIN_TINY, images, tiny_pair, to_np

FP32 = dict(atol=2e-5, rtol=1e-5)      # summation order only (PERF.md §2)


def _pair(d=16, hidden=32, E=4, seed=0):
    """JAX ``init_moe_params`` and a port ``MoE`` holding the same tensors."""
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.PRNGKey(seed), d,
                                                           hidden, E))
    moe = tmoe.MoE(d, hidden, E)
    moe.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    return params, moe


def _tokens(shape, seed, positive=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return 0.1 + np.abs(x) if positive else x


def _dense(fc_w, fc_b, proj_w, proj_b, x, dtype):
    """The dense MLP in ``nn.Linear`` layout, in the compute dtype."""
    return linear(proj_w, proj_b, quick_gelu(linear(fc_w, fc_b, x, dtype)), dtype)


@pytest.mark.parametrize("top_k,capacity", [(1, 2), (1, 12), (2, 3), (2, 24)],
                         ids=["k1-drops", "k1-room", "k2-drops", "k2-room"])
def test_route_matches_jax(top_k, capacity):
    """combine (gates in their slots, drops past the capacity) and the
    top-1 mask equal JAX's ``_route`` on the same router probabilities."""
    logits = _tokens((2, 12, 4), 1) * 2.0
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jc, jt = jmoe._route(jnp.asarray(probs), top_k, capacity)
    tc, tt = tmoe._route(torch.from_numpy(probs.copy()), top_k, capacity)
    np.testing.assert_array_equal(to_np(tt), to_np(jt))
    np.testing.assert_allclose(to_np(tc), to_np(jc), atol=1e-7, rtol=1e-6)
    kept = (to_np(tc) > 0).sum(axis=(1, 3))                  # tokens per (group, expert)
    assert kept.max() <= capacity


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_and_its_gradients_match_jax(top_k):
    """y, the aux loss and the gradients of a task loss (router, experts,
    tokens) against JAX's in fp32; with k = 1 the straight-through gate
    gives the router a task gradient."""
    params, moe = _pair()
    x = _tokens((3, 10, 16), 2)

    def jloss(p, xx):
        y, aux = jmoe.moe_mlp(p, xx, top_k=top_k, capacity_factor=1.25,
                              compute_dtype=jnp.float32)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.moe_mlp(moe, tx, top_k=top_k, capacity_factor=1.25,
                            compute_dtype=torch.float32)
    ((ty ** 2).sum() + taux).backward()
    np.testing.assert_allclose(to_np(ty), to_np(jy), **FP32)
    assert taux.item() == pytest.approx(float(jaux), rel=1e-6)
    for name, p in moe.named_parameters():
        np.testing.assert_allclose(to_np(p.grad), to_np(jg[0][name]), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(to_np(tx.grad), to_np(jg[1]), atol=1e-5, rtol=1e-4)
    assert moe.router.grad.norm() > 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [1, 2])
def test_identical_experts_match_dense(top_k, dtype):
    """Every expert a copy of the dense MLP and room for every token: the
    layer is the dense MLP, in fp32 and in the port's bf16 semantics
    (bf16 operands, fp32 accumulation on every device)."""
    gen = torch.Generator().manual_seed(3)
    d, hidden, E = 32, 64, 4
    fc_w, proj_w = (0.05 * torch.randn(s, generator=gen) for s in ((hidden, d), (d, hidden)))
    fc_b, proj_b = torch.zeros(hidden), torch.zeros(d)
    moe = tmoe.MoE(d, hidden, E)
    moe.load_state_dict({**tmoe.upcycle_dense_mlp(fc_w, fc_b, proj_w, proj_b, E),
                         "router": 0.02 * torch.randn(d, E, generator=gen)})
    x = torch.randn(3, 10, d, generator=gen)
    y, aux = tmoe.moe_mlp(moe, x, top_k=top_k, capacity_factor=float(E), compute_dtype=dtype)
    ref = _dense(fc_w, fc_b, proj_w, proj_b, x, dtype)
    tol = FP32 if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(y, ref, **tol)
    assert 0.8 <= float(aux) <= E + 1e-4


def test_capacity_drop_and_aux_scale_match_jax():
    """Every token routed to expert 0 with room for C = 3 of 12: the kept
    slots carry the expert, the dropped tokens exactly zero, and the aux
    of the collapsed router is E; both packages alike."""
    params, moe = _pair(E=4, seed=5)
    params = dict(params, router=np.zeros((16, 4), np.float32))
    params["router"][:, 0] = 10.0
    moe.router.data = torch.from_numpy(params["router"].copy())
    x = _tokens((2, 12, 16), 4, positive=True)
    jy, jaux = jmoe.moe_mlp(jax.tree.map(jnp.asarray, params), jnp.asarray(x), top_k=1,
                            capacity_factor=1.0, compute_dtype=jnp.float32)
    ty, taux = tmoe.moe_mlp(moe, torch.from_numpy(x), top_k=1, capacity_factor=1.0,
                            compute_dtype=torch.float32)
    C = tmoe.moe_capacity(12, 4, 1, 1.0)
    assert C == jmoe.moe_capacity(12, 4, 1, 1.0) == 3
    np.testing.assert_allclose(to_np(ty), to_np(jy), **FP32)
    assert not torch.any(ty[:, C:]) and torch.all(ty[:, :C].abs().sum(-1) > 0)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    assert float(taux) == pytest.approx(4.0, rel=1e-3)


@pytest.mark.parametrize("args", [(129, 4, 1, 1.25), (129, 4, 2, 1.25), (17, 8, 1, 1.0),
                                  (3, 16, 1, 0.5)])
def test_moe_capacity_matches_jax(args):
    assert tmoe.moe_capacity(*args) == jmoe.moe_capacity(*args)


def test_upcycle_matches_jax():
    """The dense MLP (``nn.Linear`` layout in the port, [din, dout] in
    JAX) tiled into every expert: the same expert stacks."""
    rng = np.random.default_rng(6)
    dense = {"fc_kernel": rng.standard_normal((8, 16)), "fc_bias": rng.standard_normal(16),
             "proj_kernel": rng.standard_normal((16, 8)), "proj_bias": rng.standard_normal(8)}
    dense = {k: v.astype(np.float32) for k, v in dense.items()}
    want = jmoe.upcycle_dense_mlp(jax.tree.map(jnp.asarray, dense), 3)
    got = tmoe.upcycle_dense_mlp(*(torch.from_numpy(a) for a in (
        dense["fc_kernel"].T.copy(), dense["fc_bias"], dense["proj_kernel"].T.copy(),
        dense["proj_bias"])), 3)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]), err_msg=k)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_tower_forward_eval_matches_jax(top_k):
    """The MoE tower (4 experts, capacity 1.25) inside the whole eval
    forward, from the same weights: features to the fp32 tolerance."""
    jspec, params, bn, model = tiny_pair("float32", use_flash=True, base=TRAIN_TINY,
                                         moe_experts=4, moe_topk=top_k)
    assert "moe" in params["base"]["blocks"]
    x = images(np.random.default_rng(7), 2, TRAIN_IMG_HW)
    cams = np.array([0, 2])
    want = jsm.forward_eval(params, bn, jnp.asarray(x), jnp.asarray(cams), jspec)
    with torch.no_grad():
        got = tsm.forward_eval(model, torch.from_numpy(x), torch.from_numpy(cams))
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32)


def test_moe_remat_segments_change_nothing_but_memory():
    """Under every REMAT_POLICY the MoE tower's loss (task + aux) and
    gradients equal the plain run's: the 'attn' and 'attn_mlp' segments
    keep ``moe_dispatch`` (and ``moe_hidden``) and recompute the routing.
    The whole-block policies give the same bits; the segments hand a
    block's input its gradient from two segments, so those sums regroup
    (fp32 rounding, held at rtol 1e-5)."""
    _, _, _, model = tiny_pair("float32", use_flash=True, base=TRAIN_TINY, moe_experts=4,
                               moe_topk=2)
    x = torch.from_numpy(images(np.random.default_rng(8), 2, TRAIN_IMG_HW))
    cams = torch.tensor([1, 0])
    params = [p for p in model.parameters() if p.requires_grad]
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots"), (True, "attn"),
                          (True, "attn_mlp"), (True, "half")):
        model.spec = dataclasses.replace(model.spec, remat=remat, remat_policy=policy)
        out = tsm.forward_train(model, x, cams)
        loss = sum(s.logsumexp(-1).mean() for s in out["scores"]) + out["moe_aux"]
        runs[(remat, policy)] = (loss.item(), torch.autograd.grad(loss, params,
                                                                  allow_unused=True))
    loss0, plain = runs.pop((False, "full"))
    for (_, policy), (loss, grads) in runs.items():
        assert loss == loss0, policy
        for a, b in zip(grads, plain):
            assert (a is None) == (b is None), policy
            if b is None:
                continue
            if policy in ("attn", "attn_mlp"):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * b.abs().max().item())
            else:
                assert torch.equal(a, b), policy
