"""Port parity: parameter groups, optimizers and LR schedules
(`signal_tpu_torch/solver.py` against `signal_tpu/solver.py`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import config as jcfg_mod
from signal_tpu import solver as js
from signal_tpu.models import signal_model as jsm
from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch import solver as ts
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.models.convert import state_dict_from_jax

CONFIGS = ["configs/RGBNT201/Signal.yml", "configs/RGBNT100/Signal.yml",
           "configs/MSVR310/Signal.yml"]


@pytest.mark.parametrize("path", CONFIGS)
def test_param_groups_equal_jax_leaf_for_leaf(path):
    """For every port parameter, (lr, wd, trainable) equals the JAX leaf's
    that ``state_dict_from_jax`` maps to it: each JAX group tree is carried
    through the same key mapping as the weights."""
    tcfg, jcfg = tcfg_mod.load_config(path), jcfg_mod.load_config(path)
    shrink = dict(layers=1, width=64, num_heads=2, feat_dim=32, h=4, w=4, topk=3)
    jspec = dataclasses.replace(jsm.ModelSpec.from_config(jcfg, 7, 3), **shrink)
    tspec = dataclasses.replace(tsm.ModelSpec.from_config(tcfg, 7, 3), **shrink)
    params, bn = jsm.init_signal_params(jax.random.PRNGKey(0), jspec)
    bn = jax.tree.map(np.asarray, bn)
    mapped = [state_dict_from_jax(jax.tree.map(
        lambda p, v: np.full(p.shape, v, np.float32), params, tree), bn, tspec)
        for tree in js.build_param_groups(params, jcfg)]
    model = tsm.Signal(tspec)
    names = [n for n, _ in model.named_parameters()]
    assert names and set(names) <= set(mapped[0])
    for name in names:
        want = tuple(np.unique(m[name].numpy()) for m in mapped)
        assert all(len(w) == 1 for w in want), name       # one value per leaf
        lr, wd, trainable = ts.param_rule(name, tcfg)
        assert (np.float32(lr), np.float32(wd), float(trainable)) == \
            (want[0][0], want[1][0], want[2][0]), name
    # the groups hold exactly the trainable parameters, at their rules' lr
    groups = ts.build_param_groups(model, tcfg)
    in_groups = {id(p): g for g in groups for p in g["params"]}
    for name, p in model.named_parameters():
        lr, wd, trainable = ts.param_rule(name, tcfg)
        assert p.requires_grad == trainable and (id(p) in in_groups) == trainable, name
        if trainable:
            assert (in_groups[id(p)]["lr"], in_groups[id(p)]["weight_decay"]) == (lr, wd)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert any(n.endswith("W_v.weight") for n in frozen)
    assert any("bottleneck" in n and n.endswith("bias") for n in frozen)
    assert "clip_vision_encoder.cv_embed" not in frozen
    assert ts.param_rule("clip_vision_encoder.cv_embed", tcfg)[0] == tcfg.SOLVER.BASE_LR


@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_optimizer_steps_match_jax(name):
    """Two steps of the torch optimizer (one group per (lr, wd), lr set to
    a + b·base_lr) against the JAX package's update on the same grads."""
    cfg = tcfg_mod.load_config("configs/RGBNT201/Signal.yml", ["SOLVER.OPTIMIZER_NAME", name])
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "bias": (3,), "frozen_bias": (2,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    base = {"w": 3.5e-4, "bias": 7e-4, "frozen_bias": 7e-4}
    wd = {"w": 1e-4, "bias": 5e-4, "frozen_bias": 5e-4}
    tr = {"w": True, "bias": True, "frozen_bias": False}
    a, b = 1e-6, 0.9

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    groups = [{"params": [tparams[k]], "lr": base[k], "base_lr": base[k],
               "weight_decay": wd[k]} for k in ("w", "bias")]
    opt = {"Adam": lambda: torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8),
           "AdamW": lambda: torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8),
           "SGD": lambda: torch.optim.SGD(groups, momentum=cfg.SOLVER.MOMENTUM)}[name]()
    ts.set_lr(opt, a, b)

    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    kw = dict(base_lr_tree=base, wd_tree=wd, trainable_tree=tr, lr_a=jnp.float32(a),
              lr_b=jnp.float32(b))
    state = (js.adam_init(jparams) if name != "SGD"
             else jax.tree.map(jnp.zeros_like, jparams))
    for g in grads:
        for k in ("w", "bias"):
            tparams[k].grad = torch.from_numpy(g[k])
        opt.step()
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        if name == "SGD":
            jparams, state = js.sgd_update(jg, state, jparams, momentum=cfg.SOLVER.MOMENTUM, **kw)
        else:
            jparams, state = js.adam_update(jg, state, jparams, decoupled_wd=name == "AdamW",
                                            **kw)
    for k in shapes:
        # the same update algebra in fp32; torch divides by sqrt(v)/sqrt(bc2),
        # the JAX package by sqrt(v/bc2): a few fp32 ulps of the step
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=1e-7, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("path", CONFIGS)
def test_schedules_match_jax(path):
    tcfg, jcfg = tcfg_mod.load_config(path), jcfg_mod.load_config(path)
    for epoch in range(0, tcfg.SOLVER.MAX_EPOCHS + 2):
        assert ts.schedule_coeffs(tcfg, epoch) == js.schedule_coeffs(jcfg, epoch), epoch
        assert ts.current_lr(tcfg, epoch) == js.current_lr(jcfg, epoch)
    for epoch in (0, 7, 49):
        assert ts._lr_noise(epoch) == js._lr_noise(epoch)
        assert abs(ts._lr_noise(epoch)) < 0.67


def test_unknown_optimizer_raises():
    cfg = tcfg_mod.load_config("configs/RGBNT201/Signal.yml", ["SOLVER.OPTIMIZER_NAME", "Lion"])
    model = tsm.Signal(tsm.ModelSpec(num_classes=3, camera_num=2, width=32, layers=1,
                                     num_heads=2, feat_dim=16, h=4, w=4, topk=3))
    with pytest.raises(ValueError, match="Adam, AdamW or SGD"):
        ts.make_optimizer(model, cfg)
