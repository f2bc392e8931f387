"""Port parity: the CNN backbones (``signal_tpu_torch/models/resnet.py``,
``osnet.py``) against ``signal_tpu`` on the same seeded weights and
inputs: the trunks in eval and train (with the BatchNorm statistics they
write), the whole Signal on each, one fp32 train step, the solver groups,
the torchvision and torchreid importers, and the statistics through a
checkpoint and ``--resume``.

ResNet runs at one bottleneck a stage (the JAX ``block_counts`` argument,
registered as depth 1 in both packages' ``RESNET_BLOCK_COUNTS`` for these
tests); depths 50, 101 and 152 are held through the spec and the block
counts, not run on the CPU. OSNet runs as osnet_x0_25. Tolerances: eval
outputs atol 2e-5 + rtol 1e-5 (true fp32 both sides, summation order
only) and running statistics atol 1e-6 + rtol 1e-5; train-mode values
and the train step as ``TRAIN_TOL`` below says, and why."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import config as jcfg_mod
from signal_tpu.models import osnet as josnet
from signal_tpu.models import resnet as jresnet
from signal_tpu.models import signal_model as jsm
from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch.models import osnet as tosnet
from signal_tpu_torch.models import resnet as tresnet
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.models.convert import state_dict_from_jax

from _torch_parity import (
    assert_groups_equal_jax,
    images,
    one_train_step,
    pair_from_config,
    tiny_pair,
    to_np,
)

FP32 = dict(atol=2e-5, rtol=1e-5)
STATS = dict(atol=1e-6, rtol=1e-5)
RESNET = dict(num_classes=5, camera_num=3, backbone="resnet", layers=1, feat_dim=2048,
              width=2048, h=4, w=4, img_h=64, img_w=64, topk=3, use_a=False, use_b=False)
OSNET = dict(RESNET, backbone="osnet", layers=12, feat_dim=128, width=128)
FULL = dict(use_a=True, use_b=True, stage="together_CLS_Patch")


@pytest.fixture(scope="module", autouse=True)
def one_block_resnet():
    """Depth 1 = one bottleneck a stage, in both packages."""
    for mod in (jresnet, tresnet):
        mod.RESNET_BLOCK_COUNTS[1] = (1, 1, 1, 1)
    yield
    for mod in (jresnet, tresnet):
        del mod.RESNET_BLOCK_COUNTS[1]


def _stats(sd: dict) -> dict:
    """The trunk's running statistics, copied."""
    return {k: v.clone() for k, v in sd.items() if k.startswith("base.") and "running_" in k}


# A CNN in train mode turns on discrete switches: a ReLU or max-pool
# choice after a BatchNorm of the batch's statistics, and at x0_25 a
# channel gate of ONE hidden ReLU unit (16 // 16). fp32 rounding then moves
# train-mode values by more than summation order does: moving the input by
# one ulp moves the port's own step gradients by up to 0.26 % (ResNet) and
# 5.2 % (OSNet), and JAX's own jitted and eager evaluations of the same
# trunk differ by 1.6e-5 (ResNet) and 1.2e-4 (OSNet) in its train-mode
# outputs and by up to 0.62 % and 58 % in the step's gradients
# (scripts/parity_conditioning.py). So train-mode values are held at
# TRAIN_TOL, 8× JAX's own spread; eval mode, where nothing switches, at
# FP32; and the step's gradients at PR 2's relative L2 < 1e-4 or, where a
# switch moved one, by cosine > 0.99 (the rule for the kernels' discrete
# choices in bf16).
TRAIN_TOL = dict(atol=1e-3, rtol=1e-3)
STATS_TRAIN = dict(atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("base", [RESNET, OSNET], ids=["resnet", "osnet"])
def test_trunk_matches_jax(base, training):
    """``resnet_forward`` / ``osnet_forward`` against JAX's: tokens, the
    pooled vector, and in training the running statistics each BatchNorm
    moved to (momentum 0.1, unbiased variance), which eval leaves alone."""
    jspec, params, bn, model = tiny_pair(base=base)
    x = images(np.random.default_rng(0), 2, (64, 64)).reshape(6, 3, 64, 64)
    if base is RESNET:
        jt, jc, jbn = jresnet.resnet50_forward(params["base"], bn["base"], jnp.asarray(x),
                                               training=training, compute_dtype=jnp.float32)
        fwd = tresnet.resnet_forward
    else:
        jt, jc, jbn = josnet.osnet_forward(params["base"], bn["base"], jnp.asarray(x),
                                           training=training, compute_dtype=jnp.float32)
        fwd = tosnet.osnet_forward
    before = _stats(model.state_dict())
    tt, tc = fwd(model.base, torch.from_numpy(x), training=training, compute_dtype=torch.float32)
    assert tt.shape == (6, 16, jspec.feat_dim) and tc.shape == (6, jspec.feat_dim)
    tol = TRAIN_TOL if training else FP32
    np.testing.assert_allclose(to_np(tt), to_np(jt), **tol)
    np.testing.assert_allclose(to_np(tc), to_np(jc), **tol)
    want = _stats(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                      jax.tree.map(np.asarray, {**bn, "base": jbn}), jspec))
    got = _stats(model.state_dict())
    assert want and set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(to_np(v), to_np(want[k]), err_msg=k,
                                   **(STATS_TRAIN if training else STATS))
        assert torch.equal(v, before[k]) != training, k


@pytest.mark.parametrize("base", [RESNET, OSNET], ids=["resnet", "osnet"])
def test_signal_forwards_match_jax(base):
    """``forward_eval`` and ``forward_train`` of the whole Signal (SIM, GAM +
    LAM, the BNNecks) on each CNN: the eval forward reads the trunk's
    running statistics and leaves them, the train forward moves them as
    JAX's ``new_bn_state["base"]``."""
    jspec, params, bn, model = tiny_pair(base=dict(base, **FULL))
    rng = np.random.default_rng(1)
    x, cams = images(rng, 4, (64, 64)), np.array([0, 2, 1, 2])
    want = jsm.forward_eval(params, bn, jnp.asarray(x), jnp.asarray(cams), jspec)
    before = _stats(model.state_dict())
    with torch.inference_mode():
        got = tsm.forward_eval(model, torch.from_numpy(x), torch.from_numpy(cams))
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32)
    assert all(torch.equal(v, before[k]) for k, v in _stats(model.state_dict()).items())
    jout, jbn = jsm.forward_train(params, bn, jnp.asarray(x), jnp.asarray(cams), jspec)
    tout = tsm.forward_train(model, torch.from_numpy(x), torch.from_numpy(cams))
    for key in ("scores", "feats"):
        for g, w in zip(tout[key], jout[key], strict=True):
            np.testing.assert_allclose(to_np(g), to_np(w), **TRAIN_TOL)
    for key in ("gam", "lam"):
        assert tout[key].item() == pytest.approx(float(jout[key]), rel=1e-3)
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, jbn), jspec)
    for k, v in _stats(model.state_dict()).items():
        np.testing.assert_allclose(to_np(v), to_np(want_sd[k]), err_msg=k, **STATS_TRAIN)
        assert not torch.equal(v, before[k]), k


# the CNN families of tests/test_backbone_grads.py's VARIANTS: resnet101's
# family at one bottleneck a stage, and osnet at x0_25
STEP_VARIANTS = [("resnet101", dict(layers=1)), ("osnet_x0_25", {})]


@pytest.fixture(scope="module", params=STEP_VARIANTS, ids=[v[0] for v in STEP_VARIANTS])
def cnn_step(request, one_block_resnet):
    ttype, shrink = request.param
    return one_train_step(*pair_from_config(ttype, dict(shrink, topk=3)))


def test_cnn_train_step_loss_matches_jax(cnn_step):
    # rtol 1e-4: the train-mode forward's switches (measured 4.8e-5 at x0_25)
    assert cnn_step["tloss"] == pytest.approx(cnn_step["jloss"], rel=1e-4)


def test_cnn_train_step_gradients_match_jax(cnn_step):
    tg, jg = cnn_step["tgrads"], cnn_step["jgrads"]
    assert len(tg) > 30
    for name, g in tg.items():
        a, b = to_np(g).ravel(), to_np(jg[name]).ravel()
        if np.linalg.norm(b) < 1e-6:        # analytically zero: rounding noise
            assert np.linalg.norm(a) < 1e-6, name
            continue
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert rel < 1e-4 or cos > 0.99, (name, rel, cos)


def test_cnn_train_step_updates_and_statistics_match_jax(cnn_step):
    """After the step: every running statistic at STATS_TRAIN, and the
    parameters at PR 2's atol 1e-6 + rtol 1e-6 where the element's gradient
    itself agrees to 1e-4 relative and is not rounding noise. Adam's first
    step moves an element by lr·g/(|g| + 1e-8), about lr·sign(g): where a
    switch moved the gradient (or turned its sign) the two may differ by up
    to 2·lr (lr ≤ 7e-4 here)."""
    ts, jp, jg, tg, p0 = (cnn_step[k] for k in ("tstate", "jstate", "jgrads", "tgrads", "p0"))
    moved = 0
    for name, v in ts.items():
        a, b = to_np(v), to_np(jp[name])
        if "running_" in name:
            np.testing.assert_allclose(a, b, err_msg=name, **STATS_TRAIN)
            assert not np.array_equal(a, to_np(p0[name])), name
            continue
        free = np.zeros(a.shape, bool)
        if name in tg:
            g, t = to_np(jg[name]), to_np(tg[name])
            free = (np.abs(g) < max(1e-7, 1e-6 * np.abs(g).max(initial=0.0))) | \
                (np.abs(t - g) > 1e-4 * np.abs(g))
        np.testing.assert_allclose(a[~free], b[~free], atol=1e-6, rtol=1e-6, err_msg=name)
        assert np.abs(a[free] - b[free]).max(initial=0.0) <= 2 * 7e-4, name
        moved += int(not np.array_equal(a, to_np(p0[name])))
    assert moved > 30


def test_resnet_depths_follow_the_block_counts():
    """resnet50/101/152 build the spec JAX builds, and each depth's trunk
    holds as many tensors and elements as JAX's tree (by ``eval_shape``,
    nothing drawn)."""
    assert {k: v for k, v in tresnet.RESNET_BLOCK_COUNTS.items() if k != 1} == \
        {k: v for k, v in jresnet.RESNET_BLOCK_COUNTS.items() if k != 1}
    for depth in (50, 101, 152):
        opts = ["MODEL.TRANSFORMER_TYPE", f"resnet{depth}"]
        tspec = tsm.ModelSpec.from_config(tcfg_mod.load_config("configs/RGBNT201/Signal.yml",
                                                               opts), 171, 4)
        jspec = jsm.ModelSpec.from_config(jcfg_mod.load_config("configs/RGBNT201/Signal.yml",
                                                               opts), 171, 4)
        assert dataclasses.asdict(tspec) == {k: v for k, v in dataclasses.asdict(jspec).items()
                                             if k in dataclasses.asdict(tspec)}
        assert (tspec.layers, tspec.h, tspec.w, tspec.feat_dim) == (depth, 16, 8, 2048)
        shapes = jax.eval_shape(lambda k: jresnet.init_resnet50_params(
            k, block_counts=jresnet.RESNET_BLOCK_COUNTS[depth]), jax.random.PRNGKey(0))
        leaves = jax.tree.leaves(shapes)
        net = tresnet.ResNet(tresnet.RESNET_BLOCK_COUNTS[depth])
        sd = net.state_dict()
        assert len(sd) == len(leaves)
        assert sum(v.numel() for v in sd.values()) == sum(math.prod(a.shape) for a in leaves)


@pytest.mark.parametrize("ttype,frozen,shrink", [("resnet101", "False", dict(layers=1, topk=3)),
                                                 ("osnet_x0_25", "False", dict(topk=3)),
                                                 ("osnet_x0_25", "True", dict(topk=3))])
def test_param_groups_equal_jax_leaf_for_leaf(ttype, frozen, shrink):
    """The CNN trunk at 0.8·BASE_LR (biases at BIAS_LR_FACTOR ×, as any
    bias), frozen whole under MODEL.FROZEN (no LoRA on a CNN, as in JAX),
    leaf for leaf against ``build_param_groups``."""
    opts = ["MODEL.TRANSFORMER_TYPE", ttype, "MODEL.FROZEN", frozen]
    tcfg = tcfg_mod.load_config("configs/RGBNT201/Signal.yml", opts)
    jcfg = jcfg_mod.load_config("configs/RGBNT201/Signal.yml", opts)
    rules = assert_groups_equal_jax(tcfg, jcfg, shrink)
    base = {n: r for n, r in rules.items() if n.startswith("base.")}
    assert base and not any("lora" in n for n in base)
    if frozen == "True":
        assert not any(r[2] for r in base.values())
    else:
        assert rules["base.conv1.weight" if "resnet" in ttype else "base.conv1.conv.weight"] == \
            (0.8 * tcfg.SOLVER.BASE_LR, tcfg.SOLVER.WEIGHT_DECAY, True)


@pytest.mark.parametrize("base", [RESNET, OSNET], ids=["torchvision", "torchreid"])
def test_importer_matches_jax(base, tmp_path):
    """``load_torchvision_resnet50`` / ``load_torchreid_osnet`` on a state
    dict the test writes under the upstream names (nested under
    ``state_dict``, a DataParallel ``module.`` prefix, the classifier and
    BatchNorm counters the importers do not read) equal JAX's importers,
    running statistics included."""
    jspec, params, bn, model = tiny_pair(base=base)
    rng = np.random.default_rng(2)
    sd = {f"module.{k}": torch.from_numpy(
        rng.uniform(0.5, 1.5, tuple(v.shape)).astype(np.float32))
        for k, v in model.base.state_dict().items()}
    sd["module.fc.weight"] = torch.zeros(10, jspec.feat_dim)
    sd["module.bn1.num_batches_tracked"] = torch.tensor(3)
    path = str(tmp_path / "weights.pth")
    torch.save({"state_dict": sd}, path)
    if base is RESNET:
        jp, js_ = jresnet.load_torchvision_resnet50(path, params["base"], bn["base"])
        tresnet.load_torchvision_resnet50(path, model.base)
    else:
        jp, js_ = josnet.load_torchreid_osnet(path, params["base"], bn["base"])
        tosnet.load_torchreid_osnet(path, model.base)
    want = state_dict_from_jax(jax.tree.map(np.asarray, {**params, "base": jp}),
                               jax.tree.map(np.asarray, {**bn, "base": js_}), jspec)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(to_np(v), to_np(want[k]), err_msg=k)
    assert torch.equal(model.state_dict()["base.conv1.weight" if base is RESNET
                                          else "base.conv1.conv.weight"],
                       sd["module.conv1.weight" if base is RESNET else "module.conv1.conv.weight"])


def test_train_main_keeps_the_statistics_through_resume(tmp_path):
    """``train_main`` on osnet_x0_25: the trunk's BatchNorm statistics
    move, land in the checkpoint's state dict, and ``--resume`` restores
    them before it trains on."""
    from signal_tpu_torch.cli import train_main
    from signal_tpu_torch.utils.checkpoint import load_checkpoint

    args = ["--config_file", "configs/synthetic/smoke.yml", "--max_steps_per_epoch", "2",
            "MODEL.DEVICE", "cpu", "MODEL.TRANSFORMER_TYPE", "osnet_x0_25", "MODEL.TOPK", "3",
            "INPUT.SIZE_TRAIN", "[64, 64]", "INPUT.SIZE_TEST", "[64, 64]",
            "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.NUM_INSTANCE", "2",
            "TEST.IMS_PER_BATCH", "8", "DATALOADER.NUM_WORKERS", "1",
            "SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.EVAL_PERIOD", "1",
            "OUTPUT_DIR", str(tmp_path)]
    first = train_main(args + ["SOLVER.MAX_EPOCHS", "1"])
    assert first.epoch == 1 and np.isfinite(first.loss) and 0.0 <= first.mAP <= 1.0
    stats = _stats(first.model.state_dict())
    assert stats and all(not torch.equal(v, torch.zeros_like(v)) for k, v in stats.items()
                         if k.endswith("running_mean"))
    ckpt = tmp_path / "synthetic_run" / "Signal_1.pth"
    fresh = tsm.init_signal(first.model.spec)
    load_checkpoint(str(ckpt), fresh)
    for k, v in stats.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    second = train_main(["--resume", str(ckpt)] + args + ["SOLVER.MAX_EPOCHS", "2"])
    assert second.epoch == 2 and np.isfinite(second.loss)
    assert "Resumed from" in (tmp_path / "synthetic_run" / "train_log.txt").read_text()
    assert any(not torch.equal(second.model.state_dict()[k].cpu(), v) for k, v in stats.items())
