"""Port parity: the train slice as a whole.

One fp32 train step of a tiny Signal (SIM, GAM + LAM, the fused attention
on its CPU plain versions, remat on), from the same weights and batch,
against the JAX package's jitted ``make_train_step`` (``device_augment``
off): the loss, every gradient, the updated parameters and the BNNeck
running stats; then three steps track JAX's losses. And the train CLI on
the CPU: an epoch, a checkpoint, and ``--resume`` from it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import config as jcfg_mod
from signal_tpu import solver as js
from signal_tpu.engine.train import make_train_step as jax_make_train_step
from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch.engine.train import make_train_step
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.models.convert import state_dict_from_jax
from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

from _torch_parity import TRAIN_IMG_HW, TRAIN_TINY, images, tiny_pair, tiny_train_cfg, to_np

# weight decay 0 in the step comparison: the first Adam moment is then
# 0.1·g exactly, so JAX's gradients are read back from its optimizer
# state (the decay's algebra is held by test_torch_solver.py)
NO_DECAY = ("SOLVER.WEIGHT_DECAY", "0.0", "SOLVER.WEIGHT_DECAY_BIAS", "0.0")


def _batch(seed, num_classes=TRAIN_TINY["num_classes"], cams=TRAIN_TINY["camera_num"]):
    rng = np.random.default_rng(seed)
    x = images(rng, 8, TRAIN_IMG_HW)
    pids = np.repeat(rng.permutation(num_classes)[:4], 2)        # P×K: 4 ids × 2
    camids = rng.integers(0, cams, 8)
    return x, pids, camids


# a gradient this small (L2 over the tensor) is rounding noise of an
# analytically zero one; true gradients here are 1e-5 and up
ZERO_GRAD = 1e-6


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module", params=[1, 0], ids=["direct1", "direct0"])
def one_step(request):
    """Both packages after one, then two more, identical train steps."""
    direct = request.param
    jspec, params, bn, model = tiny_pair("float32", use_flash=True, base=TRAIN_TINY,
                                         remat=True, direct=bool(direct))
    opts = (*NO_DECAY, "MODEL.DIRECT", str(direct))
    jcfg, tcfg = tiny_train_cfg(jcfg_mod, None, *opts), tiny_train_cfg(tcfg_mod, None, *opts)
    C = jspec.num_classes
    p0 = jax.tree.map(np.asarray, params)

    jstep = jax_make_train_step(jspec, jcfg, C)
    groups = jax.tree.map(jnp.asarray, js.build_param_groups(params, jcfg))
    lr_a, lr_b = js.schedule_coeffs(jcfg, 1)
    opt_state = js.adam_init(params)

    optimizer = make_optimizer(model, tcfg)
    set_lr(optimizer, *schedule_coeffs(tcfg, 1))
    tstep = make_train_step(model, tcfg, C, optimizer)

    out = {"spec": jspec, "p0": p0, "bn0": jax.tree.map(np.asarray, bn), "model": model,
           "jlosses": [], "tlosses": []}
    jparams, jbn = params, bn
    for i in range(3):
        x, pids, camids = _batch(i)
        batch = {"imgs": jnp.asarray(x), "pids": jnp.asarray(pids), "camids": jnp.asarray(camids)}
        jparams, jbn, opt_state, jloss, _, _ = jstep(
            jparams, jbn, opt_state, batch, jnp.float32(lr_a), jnp.float32(lr_b), groups)
        tloss, _ = tstep(torch.from_numpy(x), torch.from_numpy(pids), torch.from_numpy(camids))
        out["jlosses"].append(float(jloss))
        out["tlosses"].append(float(tloss))
        if i == 0:
            # the first step's results, as port-keyed numpy
            out["jgrads"] = state_dict_from_jax(
                jax.tree.map(lambda m: np.asarray(m) / 0.1, opt_state.mu), out["bn0"], jspec)
            out["jparams"] = state_dict_from_jax(jax.tree.map(np.asarray, jparams),
                                                 jax.tree.map(np.asarray, jbn), jspec)
            out["tgrads"] = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
                             for n, p in model.named_parameters() if p.requires_grad}
            out["tstate"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def test_train_step_loss_matches_jax(one_step):
    # fp32 throughout, the same rounding points: summation order only
    assert one_step["tlosses"][0] == pytest.approx(one_step["jlosses"][0], rel=1e-5)


def test_train_step_gradients_match_jax(one_step):
    tg, jg = one_step["tgrads"], one_step["jgrads"]
    assert len(tg) > 30
    for name, g in tg.items():
        a, b = to_np(g), to_np(jg[name])
        if np.linalg.norm(b) < ZERO_GRAD:
            # analytically zero: SIM's W_q/W_k feed only the top-k
            # selection, and a bias in front of a BatchNorm is cancelled by
            # its batch mean; both sides hold fp32 rounding noise
            assert np.linalg.norm(a) < ZERO_GRAD, name
            continue
        assert _rel_l2(a, b) < 1e-4, (name, _rel_l2(a, b))


def test_train_step_updates_and_running_stats_match_jax(one_step):
    ts, jp, jg = one_step["tstate"], one_step["jparams"], one_step["jgrads"]
    moved = 0
    for name, v in ts.items():
        a, b = to_np(v), to_np(jp[name])
        # Adam's first step moves an element by lr·g/(|g| + eps) ≈ lr·sign(g),
        # lr ≤ 1.75e-4 here: where the gradient is rounding noise of an
        # analytically zero one (|g| < 1e-7) the sign is noise too, and the
        # two sides may differ by up to 2·lr
        noise = np.abs(to_np(jg[name])) < 1e-7 if name in jg else np.zeros(a.shape, bool)
        np.testing.assert_allclose(a[~noise], b[~noise], atol=1e-6, rtol=1e-6, err_msg=name)
        assert np.abs(a[noise] - b[noise]).max(initial=0.0) <= 3.5e-4, name
        moved += int(not np.array_equal(to_np(v), to_np(state_dict_from_jax(
            one_step["p0"], one_step["bn0"], one_step["spec"])[name])))
    assert moved > 30
    # the BNNeck running stats moved with the batch statistics
    bn = [k for k in ts if k.endswith("running_var")]
    assert bn and all(not torch.equal(ts[k], torch.ones_like(ts[k])) for k in bn)


def test_three_steps_track_jax_losses(one_step):
    np.testing.assert_allclose(one_step["tlosses"], one_step["jlosses"], rtol=1e-4)


def test_remat_changes_nothing_but_memory():
    """The checkpointed blocks give the same loss and gradients as the
    plain ones, under 'full' and under the selective 'dots' policy
    (tests/test_torch_remat.py holds every policy against JAX)."""
    _, _, _, model = tiny_pair("float32", use_flash=True, base=TRAIN_TINY)
    x, pids, cams = (torch.from_numpy(a) for a in _batch(5))
    grads = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        model.spec = dataclasses.replace(model.spec, remat=remat, remat_policy=policy)
        out = tsm.forward_train(model, x, cams)
        loss = sum(s.logsumexp(-1).mean() for s in out["scores"]) + out["gam"] + out["lam"]
        grads.append(torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad],
                                         allow_unused=True))
    for plain, *checkpointed in zip(*grads):
        for g in checkpointed:
            assert (g is None and plain is None) or torch.equal(g, plain)


def test_train_main_runs_an_epoch_and_resumes(tmp_path):
    from signal_tpu_torch.cli import train_main

    shrink = ",".join(f"{k}={v}" for k, v in TRAIN_TINY.items()
                      if k not in ("num_classes", "camera_num"))
    args = ["--config_file", "configs/synthetic/smoke.yml", "--shrink", shrink,
            "--max_steps_per_epoch", "2", "MODEL.DEVICE", "cpu",
            "INPUT.SIZE_TRAIN", "[64, 64]", "INPUT.SIZE_TEST", "[64, 64]",
            "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.NUM_INSTANCE", "2",
            "TEST.IMS_PER_BATCH", "8", "DATALOADER.NUM_WORKERS", "1",
            "SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.EVAL_PERIOD", "1",
            "OUTPUT_DIR", str(tmp_path)]
    first = train_main(args + ["SOLVER.MAX_EPOCHS", "1"])
    run = tmp_path / "synthetic_run"
    assert first.epoch == 1 and np.isfinite(first.loss) and 0.0 <= first.mAP <= 1.0
    assert (run / "Signal_1.pth").exists() and (run / "Signalbest.pth").exists()
    log = (run / "train_log.txt").read_text()
    assert "Epoch[1] Iteration[2/" in log and "Validation Results - Epoch: 1" in log

    second = train_main(["--resume", str(run / "Signal_1.pth")] + args
                        + ["SOLVER.MAX_EPOCHS", "2"])
    assert second.epoch == 2 and np.isfinite(second.loss)
    log = (run / "train_log.txt").read_text()
    assert "Resumed from" in log and "Epoch[1]" not in log and "Epoch[2] Iteration[2/" in log
    # the optimizer state came back: two steps before the resume, two after
    steps = {int(s["step"]) for s in second.optimizer.state.values()}
    assert steps == {4}
    # the best checkpoint loads as a TEST.WEIGHT
    from signal_tpu_torch.models.convert import load_reference_checkpoint

    load_reference_checkpoint(tsm.init_signal(second.model.spec), str(run / "Signalbest.pth"))


def test_init_signal_draws_the_train_weights_like_jax():
    """The train-only weights follow `init_signal_params`' distributions:
    classifiers N(0, 0.001), BNNecks ones and zeros (bias frozen), DAS
    convs U(±1/√fan_in) with ZERO biases, contra_temp 0.07."""
    spec = tsm.ModelSpec(**TRAIN_TINY, direct=False)
    model = tsm.init_signal(spec, seed=3)
    for m in "rnt":
        w = getattr(model, f"classifier_{m}").weight
        assert 0.0005 < w.std().item() < 0.002
        bn = getattr(model, f"bottleneck_{m}")
        assert torch.equal(bn.weight, torch.ones_like(bn.weight)) and not bn.bias.requires_grad
    al = model.AlignM
    assert al.contra_temp.item() == pytest.approx(0.07)
    for das in (al.DAS_r, al.DAS_n, al.DAS_t):
        for conv in (das.proj_q, das.conv_offset[0], das.conv_offset[2], das.conv_offset[4]):
            bound = conv.weight[0].numel() ** -0.5
            assert conv.weight.abs().max() <= bound and conv.weight.abs().max() > 0.5 * bound
            assert conv.bias is None or torch.equal(conv.bias, torch.zeros_like(conv.bias))


def test_train_main_refuses_cuda_without_a_card(tmp_path):
    """MODEL.DEVICE cuda where there is no card raises; it never falls
    back to the CPU."""
    from signal_tpu_torch.cli import train_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--config_file", "configs/synthetic/smoke.yml", "MODEL.DEVICE", "cuda",
                    "OUTPUT_DIR", str(tmp_path)])
