"""Port parity: gradient accumulation (SOLVER.ACCUM_ITER) and center loss
in the train step.

One fp32 step of the tiny train Signal at ACCUM_ITER = 2 (two contiguous
microbatches of 4 = 2 ids × 2), from the same weights, batch and class
centres, against the JAX package's ``make_train_step`` at ACCUM_ITER = 2:
the loss, every (averaged) gradient, the updated parameters, the BNNeck
running stats threaded through both microbatches, and the centres'
SGD step. Then the duplicated-batch property of `tests/test_accum.py`: a
step on [h; h] at ACCUM_ITER = 2 equals a step on h at ACCUM_ITER = 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import config as jcfg_mod
from signal_tpu import solver as js
from signal_tpu.engine.train import _device_batch
from signal_tpu.engine.train import make_train_step as jax_make_train_step
from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch.engine.train import init_centers, make_train_step
from signal_tpu_torch.models.convert import state_dict_from_jax
from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

from _torch_parity import TRAIN_IMG_HW, TRAIN_TINY, images, tiny_pair, tiny_train_cfg, to_np

NO_DECAY = ("SOLVER.WEIGHT_DECAY", "0.0", "SOLVER.WEIGHT_DECAY_BIAS", "0.0")
ZERO_GRAD = 1e-6      # test_torch_train.py: rounding noise of an analytically zero gradient
C = TRAIN_TINY["num_classes"]


def _batch(seed, uint8=False, n_ids=4):
    rng = np.random.default_rng(seed)
    if uint8:
        x = rng.integers(0, 256, (2 * n_ids, 3, 3, *TRAIN_IMG_HW), dtype=np.uint8)
    else:
        x = images(rng, 2 * n_ids, TRAIN_IMG_HW)
    pids = np.repeat(rng.permutation(C)[:n_ids], 2)                 # P×K: n_ids × 2
    camids = rng.integers(0, TRAIN_TINY["camera_num"], 2 * n_ids)
    return x, pids, camids


def _centers(spec, seed=7):
    dim = 3 * spec.feat_dim if spec.direct else spec.feat_dim
    return np.random.default_rng(seed).standard_normal((C, dim)).astype(np.float32)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "center"])
def accum_step(request):
    """Both packages after one identical ACCUM_ITER = 2 step."""
    center = request.param
    opts = (*NO_DECAY, "SOLVER.ACCUM_ITER", "2")
    if center:
        opts += ("MODEL.METRIC_LOSS_TYPE", "triplet_center")
    jcfg, tcfg = tiny_train_cfg(jcfg_mod, None, *opts), tiny_train_cfg(tcfg_mod, None, *opts)
    jspec, params, bn, model = tiny_pair("float32", use_flash=True, base=TRAIN_TINY, remat=True)
    x, pids, camids = _batch(0, uint8=center)
    centers = _centers(jspec) if center else None

    jstep = jax_make_train_step(jspec, jcfg, C)
    groups = jax.tree.map(jnp.asarray, js.build_param_groups(params, jcfg))
    lr_a, lr_b = js.schedule_coeffs(jcfg, 1)
    db = _device_batch({"packed": x, "pids": pids, "camids": camids}, None, accum=2)
    bn0 = jax.tree.map(np.asarray, bn)                  # the step donates its inputs
    jparams, jbn, opt_state, jloss, jacc, jcenters = jstep(
        params, bn, js.adam_init(params), db, jnp.float32(lr_a), jnp.float32(lr_b), groups,
        None, None if centers is None else jnp.asarray(centers))

    optimizer = make_optimizer(model, tcfg)
    set_lr(optimizer, *schedule_coeffs(tcfg, 1))
    tcenters = None if centers is None else torch.tensor(centers, requires_grad=True)
    tstep = make_train_step(model, tcfg, C, optimizer, centers=tcenters)
    tloss, tacc = tstep(torch.from_numpy(x), torch.from_numpy(pids), torch.from_numpy(camids))
    return {
        "jloss": float(jloss), "tloss": float(tloss), "jacc": float(jacc), "tacc": float(tacc),
        "jgrads": state_dict_from_jax(jax.tree.map(lambda m: np.asarray(m) / 0.1, opt_state.mu),
                                      bn0, jspec),
        "tgrads": {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                   for n, p in model.named_parameters() if p.requires_grad},
        "jstate": state_dict_from_jax(jax.tree.map(np.asarray, jparams),
                                      jax.tree.map(np.asarray, jbn), jspec),
        "tstate": model.state_dict(),
        "centers": centers, "jcenters": None if jcenters is None else np.asarray(jcenters),
        "tcenters": tcenters,
    }


def test_accum_loss_and_accuracy_match_jax(accum_step):
    assert accum_step["tloss"] == pytest.approx(accum_step["jloss"], rel=1e-5)
    assert accum_step["tacc"] == pytest.approx(accum_step["jacc"], abs=1e-6)


def test_accum_gradients_match_jax(accum_step):
    tg, jg = accum_step["tgrads"], accum_step["jgrads"]
    assert len(tg) > 30
    for name, g in tg.items():
        a, b = to_np(g), to_np(jg[name])
        if np.linalg.norm(b) < ZERO_GRAD:
            assert np.linalg.norm(a) < ZERO_GRAD, name
            continue
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-4, name


def test_accum_updates_running_stats_and_centers_match_jax(accum_step):
    ts, jp, jg = accum_step["tstate"], accum_step["jstate"], accum_step["jgrads"]
    for name, v in ts.items():
        a, b = to_np(v), to_np(jp[name])
        # Adam moves an element by ≈ ±lr where the gradient is rounding
        # noise of an analytically zero one: there the sign is noise too
        noise = np.abs(to_np(jg[name])) < 1e-7 if name in jg else np.zeros(a.shape, bool)
        np.testing.assert_allclose(a[~noise], b[~noise], atol=1e-6, rtol=1e-6, err_msg=name)
        assert np.abs(a[noise] - b[noise]).max(initial=0.0) <= 3.5e-4, name
    # the running stats moved twice, once per microbatch
    assert any(not torch.equal(ts[k], torch.ones_like(ts[k]))
               for k in ts if k.endswith("running_var"))
    if accum_step["centers"] is not None:
        got = to_np(accum_step["tcenters"])
        np.testing.assert_allclose(got, accum_step["jcenters"], atol=1e-6, rtol=1e-6)
        assert not np.array_equal(got, accum_step["centers"])


def _port_step(accum, x, pids, camids, center, seed=1):
    opts = ["SOLVER.OPTIMIZER_NAME", "SGD", "SOLVER.ACCUM_ITER", str(accum)]
    if center:
        opts += ["MODEL.METRIC_LOSS_TYPE", "triplet_center"]
    cfg = tiny_train_cfg(tcfg_mod, None, *opts)
    _, _, _, model = tiny_pair("float32", use_flash=True, base=TRAIN_TINY, seed=seed)
    optimizer = make_optimizer(model, cfg)
    set_lr(optimizer, *schedule_coeffs(cfg, 1))
    centers = init_centers(cfg, model.spec, C, torch.device("cpu"))
    step = make_train_step(model, cfg, C, optimizer, centers=centers)
    loss, acc = step(torch.from_numpy(x), torch.from_numpy(pids), torch.from_numpy(camids))
    params = {n: p.detach() for n, p in model.named_parameters()}
    return float(loss), float(acc), params, centers


@pytest.mark.parametrize("center", [False, True], ids=["plain", "center"])
def test_accum2_on_a_duplicated_batch_equals_one_step_on_half(center):
    """SGD, as tests/test_accum.py: each microbatch of [h; h] is h, so the
    averaged gradient, and the update, are h's."""
    x, pids, camids = _batch(2, uint8=center)
    dup = [np.concatenate([a, a]) for a in (x, pids, camids)]
    loss1, acc1, p1, c1 = _port_step(1, x, pids, camids, center)
    loss2, acc2, p2, c2 = _port_step(2, *dup, center)
    assert loss2 == pytest.approx(loss1, rel=1e-5) and acc2 == pytest.approx(acc1, abs=1e-6)
    for name in p1:
        torch.testing.assert_close(p2[name], p1[name], rtol=2e-4, atol=2e-5, msg=name)
    if center:
        torch.testing.assert_close(c2, c1, rtol=1e-5, atol=1e-6)


def test_accum_rejects_an_indivisible_batch():
    cfg = tiny_train_cfg(tcfg_mod, None, "SOLVER.ACCUM_ITER", "4")
    _, _, _, model = tiny_pair("float32", use_flash=True, base=TRAIN_TINY)
    step = make_train_step(model, cfg, C, make_optimizer(model, cfg))
    x, pids, camids = _batch(3, n_ids=3)                            # B = 6
    with pytest.raises(ValueError, match="ACCUM_ITER"):
        step(torch.from_numpy(x), torch.from_numpy(pids), torch.from_numpy(camids))


def test_center_loss_needs_its_centers():
    cfg = tiny_train_cfg(tcfg_mod, None, "MODEL.METRIC_LOSS_TYPE", "triplet_center")
    _, _, _, model = tiny_pair("float32", use_flash=True, base=TRAIN_TINY)
    with pytest.raises(ValueError, match="centres"):
        make_train_step(model, cfg, C, make_optimizer(model, cfg))
    centers = init_centers(cfg, model.spec, C, torch.device("cpu"))
    assert centers.shape == (C, 3 * TRAIN_TINY["feat_dim"]) and centers.requires_grad
    again = init_centers(cfg, model.spec, C, torch.device("cpu"))
    assert torch.equal(centers, again)                               # seeded by SOLVER.SEED
