"""Shared set-up of the PyTorch port's parity tests: one tiny Signal spec
built in both packages, with the JAX weights carried into the port by
``state_dict_from_jax``. Inputs come from numpy generators and cross
between the frameworks as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

# 2-layer CLIP tower of width 128 (4 heads of 32) on a 64×32 image
# (a 4×2 patch grid, 9 tokens), SIM with TOPK 3
TINY = dict(num_classes=5, camera_num=3, width=128, layers=2, num_heads=4,
            feat_dim=64, h=4, w=2, topk=3)
IMG_HW = (64, 32)

# the train slice's tiny spec: DAS needs at least a 4×4 grid, so a 64×64
# image (16 patch tokens); SIM TOPK 3, GAM + LAM on
TRAIN_TINY = dict(TINY, h=4, w=4, use_a=True, use_b=True, stage="together_CLS_Patch")
TRAIN_IMG_HW = (64, 64)


def tiny_pair(compute_dtype: str = "float32", use_flash: bool = True, seed: int = 0,
              base: dict = TINY, remat: bool = False, **kw):
    """→ (jax_spec, jax_params, jax_bn_state, port Signal loaded strictly
    with the same weights, in eval mode). ``base``: TINY (eval tests) or
    TRAIN_TINY."""
    from signal_tpu.models import signal_model as jsm
    from signal_tpu_torch.models import signal_model as tsm
    from signal_tpu_torch.models.convert import state_dict_from_jax

    fields = {**base, **kw, "compute_dtype": compute_dtype, "use_flash": use_flash,
              "remat": remat}
    jspec = jsm.ModelSpec(**fields)
    tspec = tsm.ModelSpec(**fields)
    params, bn = jsm.init_signal_params(jax.random.PRNGKey(seed), jspec)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, bn), tspec)
    model = tsm.Signal(tspec)
    model.load_state_dict(sd, strict=True)
    return jspec, params, bn, model.eval()


def images(rng: np.random.Generator, batch: int, hw=IMG_HW) -> np.ndarray:
    """Normalized packed images [B, 3 modal, 3 ch, H, W] in [-1, 1]."""
    u8 = rng.integers(0, 256, (batch, 3, 3, *hw))
    return (u8 / 127.5 - 1.0).astype(np.float32)


def tiny_train_cfg(mod, tmp_path=None, *opts):
    """The synthetic config at the train tiny size, in the config module
    ``mod`` of either package: 64×64 images, batches of 8 (4 ids × 2),
    one thread, Adam; ``opts`` are more KEY VALUE overrides."""
    base = ["INPUT.SIZE_TRAIN", "[64, 64]", "INPUT.SIZE_TEST", "[64, 64]",
            "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.NUM_INSTANCE", "2",
            "TEST.IMS_PER_BATCH", "8", "DATALOADER.NUM_WORKERS", "1", "MODEL.TOPK", "3"]
    if tmp_path is not None:
        base += ["OUTPUT_DIR", str(tmp_path)]
    return mod.load_config("configs/synthetic/smoke.yml", base + list(opts))


def to_np(x) -> np.ndarray:
    """JAX array or torch tensor → float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# one fp32 train step of any backbone in both packages (PR 2's tolerances)

# a gradient this small (L2 over the tensor) is rounding noise of an
# analytically zero one; true gradients here are 1e-5 and up
ZERO_GRAD = 1e-6


def pair_from_config(ttype: str, shrink: dict, *opts, seed: int = 0):
    """The train tiny config with MODEL.TRANSFORMER_TYPE ``ttype`` (weight
    decay 0, fp32, DROP_PATH 0: JAX's step without an rng drops nothing)
    in both packages, their specs from ``from_config`` with
    ``shrink`` replaced in, the JAX weights carried into the port. →
    (jcfg, tcfg, jspec, params, bn, model)."""
    import dataclasses

    from signal_tpu import config as jcfg_mod
    from signal_tpu.models import signal_model as jsm
    from signal_tpu_torch import config as tcfg_mod
    from signal_tpu_torch.models import signal_model as tsm
    from signal_tpu_torch.models.convert import state_dict_from_jax

    opts = ("MODEL.TRANSFORMER_TYPE", ttype, "MODEL.COMPUTE_DTYPE", "float32",
            "SOLVER.WEIGHT_DECAY", "0.0", "SOLVER.WEIGHT_DECAY_BIAS", "0.0",
            "MODEL.DROP_PATH", "0.0", *opts)
    jcfg, tcfg = tiny_train_cfg(jcfg_mod, None, *opts), tiny_train_cfg(tcfg_mod, None, *opts)
    jspec = dataclasses.replace(jsm.ModelSpec.from_config(jcfg, 5, 3), **shrink)
    tspec = dataclasses.replace(tsm.ModelSpec.from_config(tcfg, 5, 3), **shrink)
    params, bn = jsm.init_signal_params(jax.random.PRNGKey(seed), jspec)
    model = tsm.Signal(tspec)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                              jax.tree.map(np.asarray, bn), tspec), strict=True)
    return jcfg, tcfg, jspec, params, bn, model


def train_batch(seed: int, num_classes: int = 5, cams: int = 3, hw=TRAIN_IMG_HW):
    """8 packed images, P×K labels (4 ids × 2) and cameras."""
    rng = np.random.default_rng(seed)
    x = images(rng, 8, hw)
    pids = np.repeat(rng.permutation(num_classes)[:4], 2)
    return x, pids, rng.integers(0, cams, 8)


def one_train_step(jcfg, tcfg, jspec, params, bn, model, seed: int = 0) -> dict:
    """One train step of each package on the same batch (JAX's jitted
    ``make_train_step`` without an rng, the port's ``make_train_step``),
    as port-keyed numpy: the losses, JAX's gradients (read back from its
    first Adam moment, 0.1·g with weight decay 0), the port's, and the
    parameters and statistics after the step."""
    from signal_tpu import solver as js
    from signal_tpu.engine.train import make_train_step as jax_make_train_step
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.models.convert import state_dict_from_jax
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    C = jspec.num_classes
    p0, bn0 = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bn)
    x, pids, camids = train_batch(seed, C, jspec.camera_num)
    jstep = jax_make_train_step(jspec, jcfg, C)
    groups = jax.tree.map(jnp.asarray, js.build_param_groups(params, jcfg))
    lr_a, lr_b = js.schedule_coeffs(jcfg, 1)
    batch = {"imgs": jnp.asarray(x), "pids": jnp.asarray(pids), "camids": jnp.asarray(camids)}
    jparams, jbn, opt_state, jloss, _, _ = jstep(
        params, bn, js.adam_init(params), batch, jnp.float32(lr_a), jnp.float32(lr_b), groups)
    optimizer = make_optimizer(model, tcfg)
    set_lr(optimizer, *schedule_coeffs(tcfg, 1))
    tloss, _ = make_train_step(model, tcfg, C, optimizer)(
        torch.from_numpy(x), torch.from_numpy(pids), torch.from_numpy(camids))
    return {
        "jloss": float(jloss), "tloss": float(tloss),
        "p0": state_dict_from_jax(p0, bn0, jspec),
        "jgrads": state_dict_from_jax(jax.tree.map(lambda m: np.asarray(m) / 0.1, opt_state.mu),
                                      bn0, jspec),
        "jstate": state_dict_from_jax(jax.tree.map(np.asarray, jparams),
                                      jax.tree.map(np.asarray, jbn), jspec),
        "tgrads": {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
                   for n, p in model.named_parameters() if p.requires_grad},
        "tstate": {k: v.clone() for k, v in model.state_dict().items()},
    }


def assert_gradients_match(tg: dict, jg: dict) -> None:
    """Each gradient to relative L2 < 1e-4 (PR 2's tolerance); one that is
    analytically zero (SIM's W_q/W_k, a bias in front of a BatchNorm) holds
    rounding noise on both sides and is held by its norm."""
    assert tg
    for name, g in tg.items():
        a, b = to_np(g), to_np(jg[name])
        if np.linalg.norm(b) < ZERO_GRAD:
            assert np.linalg.norm(a) < ZERO_GRAD, name
            continue
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < 1e-4, (name, rel)


def assert_updates_match(step: dict) -> int:
    """The parameters and running statistics after the step to atol 1e-6 +
    rtol 1e-6 (PR 2's tolerance). Adam's first step moves an element by
    lr·g/(|g| + 1e-8), about lr·sign(g): where g is rounding noise — of an
    analytically zero gradient (|g| < 1e-7), or of a sum that cancels to
    within fp32 rounding of the tensor's largest gradient (|g| < 1e-6 ·
    max |g|) — that ratio is noise too, and the two sides may differ by
    up to 2·lr; they are held within 3.5e-4. → how many tensors moved."""
    ts, jp, jg, p0 = step["tstate"], step["jstate"], step["jgrads"], step["p0"]
    moved = 0
    for name, v in ts.items():
        a, b = to_np(v), to_np(jp[name])
        noise = np.zeros(a.shape, bool)
        if name in jg:
            g = np.abs(to_np(jg[name]))
            noise = g < max(1e-7, 1e-6 * g.max(initial=0.0))
        np.testing.assert_allclose(a[~noise], b[~noise], atol=1e-6, rtol=1e-6, err_msg=name)
        assert np.abs(a[noise] - b[noise]).max(initial=0.0) <= 3.5e-4, name
        moved += int(not np.array_equal(a, to_np(p0[name])))
    return moved


def assert_groups_equal_jax(tcfg, jcfg, shrink: dict) -> dict:
    """Every port parameter's (lr, wd, trainable) equals the JAX leaf's
    that ``state_dict_from_jax`` maps it from (each JAX group tree carried
    through the same mapping as the weights), on the configs' specs with
    ``shrink`` replaced in; the optimizer groups hold exactly the
    trainable ones. → {name: rule}."""
    import dataclasses

    from signal_tpu import solver as js
    from signal_tpu.models import signal_model as jsm
    from signal_tpu_torch import solver as ts
    from signal_tpu_torch.models import signal_model as tsm
    from signal_tpu_torch.models.convert import state_dict_from_jax

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
    rules = {}
    for name in names:
        want = tuple(np.unique(m[name].numpy()) for m in mapped)
        assert all(len(w) == 1 for w in want), name       # one value per leaf
        rules[name] = ts.param_rule(name, tcfg)
        lr, wd, trainable = rules[name]
        assert (np.float32(lr), np.float32(wd), float(trainable)) == \
            (want[0][0], want[1][0], want[2][0]), name
    groups = ts.build_param_groups(model, tcfg)
    in_groups = {id(p) for g in groups for p in g["params"]}
    for name, p in model.named_parameters():
        assert (id(p) in in_groups) == rules[name][2] == p.requires_grad, name
    return rules
