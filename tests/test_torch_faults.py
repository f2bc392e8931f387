"""The port's repaired faults, each against the JAX package where it has a
counterpart:

* MODEL.DIST_TRAIN: both entry points refuse it (the port has no
  multi-process run yet) instead of training single-process in every
  process;
* more than 160 tokens: the bf16 backward now takes every length JAX
  trains (MODEL.STRIDE_SIZE 12 gives 211 tokens at 256×128, a 384×128
  input 193). On the CPU the kernel's plain version is held against the
  Pallas backward at those lengths, and a stride-12 tower's gradients
  against JAX's; the kernel itself is held against the plain version on
  the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
* PARALLEL.SEQUENCE with MODEL_AXIS 1 warns as JAX does and runs; MODEL_AXIS
  or PIPE_AXIS > 1 still raise;
* the solver pinned the adapters to the CLIP backbone's 5e-6; its groups
  now equal JAX's ``build_param_groups`` for MODEL.ADAPTER, MODEL.PROMPT
  and MODEL.FROZEN, as do the MoE composition rules' refusals.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import config as jcfg_mod
from signal_tpu import solver as js
from signal_tpu.models import signal_model as jsm
from signal_tpu.models import vit as jvit
from signal_tpu.ops.flash_attention import _fused_attention_bwd_impl
from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch import solver as ts
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.models import vit as tvit
from signal_tpu_torch.models.convert import state_dict_from_jax
from signal_tpu_torch.ops.flash_attention import flash_attention_bwd_reference

from _torch_parity import to_np

FLAGSHIP = "configs/RGBNT201/Signal.yml"


@pytest.mark.parametrize("entry", ["train_main", "test_main"])
def test_dist_train_raises_in_both_entry_points(entry, tmp_path):
    from signal_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="MODEL.DIST_TRAIN.*scale-out"):
        getattr(cli, entry)(["--config_file", "configs/synthetic/smoke.yml",
                             "MODEL.DEVICE", "cpu", "MODEL.DIST_TRAIN", "True",
                             "OUTPUT_DIR", str(tmp_path)])
    assert not any(tmp_path.iterdir())          # refused before it wrote anything


@pytest.mark.parametrize("L", [193, 211])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_version_matches_jax_kernel_past_160_tokens(L, dtype):
    """The lengths the bf16 kernel's long route takes, one head of 64:
    the plain version against the Pallas backward (interpret mode), at the
    tolerances of ``tests/test_torch_attention_grad.py``."""
    rng = np.random.default_rng(L)
    q, k, v, g = (rng.standard_normal((1, L, 64)).astype(np.float32) for _ in range(4))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = _fused_attention_bwd_impl(*(jnp.asarray(a, jd) for a in (q, k, v, g)), 1)
    got = flash_attention_bwd_reference(*(torch.from_numpy(a).to(td) for a in (q, k, v, g)), 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(to_np(a), to_np(b), atol=2e-5, rtol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(to_np(a), to_np(b), atol=8e-3, rtol=1e-2, err_msg=name)


def test_stride_12_tower_trains_at_211_tokens_like_jax():
    """MODEL.STRIDE_SIZE 12 at 256×128: both specs give the 21×10 grid,
    and a tiny tower of that grid (211 tokens, the fused attention on its
    plain version) has JAX's outputs and gradients in fp32."""
    cfg_opts = ["MODEL.STRIDE_SIZE", "[12, 12]"]
    ours = tsm.ModelSpec.from_config(tcfg_mod.load_config(FLAGSHIP, cfg_opts), 10, 2)
    theirs = jsm.ModelSpec.from_config(jcfg_mod.load_config(FLAGSHIP, cfg_opts), 10, 2)
    assert (ours.h, ours.w, ours.stride_size) == (theirs.h, theirs.w, 12) == (21, 10, 12)
    fields = dict(h=21, w=10, stride_size=12, width=32, layers=1, num_heads=2, feat_dim=16,
                  num_classes=4, camera_num=2, compute_dtype="float32", use_flash=True)
    jspec = dataclasses.replace(theirs, **fields)
    params, bn = jsm.init_signal_params(jax.random.PRNGKey(0), jspec)
    model = tsm.Signal(dataclasses.replace(ours, **fields))
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                              jax.tree.map(np.asarray, bn), model.spec))
    x = np.random.default_rng(1).standard_normal((1, 3, 256, 128)).astype(np.float32)
    kw = dict(num_heads=2, use_flash=True, stride=12)

    def jloss(base):
        p, c = jvit.vit_forward(base, jnp.asarray(x), compute_dtype=jnp.float32, **kw)
        return jnp.sum(p ** 2) + jnp.sum(c ** 2), p

    (jl, jp), jg = jax.value_and_grad(jloss, has_aux=True)(params["base"])
    tower = model.clip_vision_encoder.base
    tp, tc = tvit.vit_forward(tower, torch.from_numpy(x), compute_dtype=torch.float32,
                              remat=True, **kw)
    assert tp.shape == (1, 210, 16)
    loss = (tp ** 2).sum() + (tc ** 2).sum()
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    want = jg["blocks"]["attn"]["qkv_kernel"][0].T
    got = tower.transformer.resblocks[0].attn.in_proj_weight.grad
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=1e-3)


def test_sequence_parallel_without_tensor_parallel_warns_and_runs(caplog):
    # the CLI's logger setup stops the package's records at its own logger,
    # so caplog's handler listens on the model's logger itself (a record
    # that also reaches the root logger is the same record, counted once)
    logger = logging.getLogger("signal_tpu_torch.model")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="signal_tpu_torch.model"):
            spec = tsm.ModelSpec.from_config(
                tcfg_mod.load_config(FLAGSHIP, ["PARALLEL.SEQUENCE", "True"]), 10, 2)
    finally:
        logger.removeHandler(caplog.handler)
    assert spec.width == 768
    warned = list({id(r): r for r in caplog.records
                   if r.name == "signal_tpu_torch.model"}.values())
    assert len(warned) == 1 and warned[0].levelno == logging.WARNING
    assert "PARALLEL.SEQUENCE=True has no effect with MODEL_AXIS=1" in warned[0].getMessage()


@pytest.mark.parametrize("opts", [["PARALLEL.MODEL_AXIS", "2"], ["PARALLEL.PIPE_AXIS", "2"],
                                  ["PARALLEL.MODEL_AXIS", "2", "PARALLEL.SEQUENCE", "True"]])
def test_tensor_and_pipeline_parallelism_still_raise(opts):
    with pytest.raises(NotImplementedError, match="scale-out"):
        tsm.ModelSpec.from_config(tcfg_mod.load_config(FLAGSHIP, opts), 10, 2)


@pytest.mark.parametrize("opts", [["MODEL.FROZEN", "True"], ["MODEL.PROMPT", "True"],
                                  ["PARALLEL.PIPE_AXIS", "2"]], ids=["frozen", "prompt", "pipe"])
def test_moe_composition_rules_raise_like_jax(opts):
    """MoE with FROZEN, PROMPT or PIPE_AXIS > 1 raises JAX's ValueError,
    message for message."""
    opts = ["MODEL.MOE_EXPERTS", "4", *opts]
    with pytest.raises(ValueError) as theirs:
        jsm.ModelSpec.from_config(jcfg_mod.load_config(FLAGSHIP, opts), 10, 2)
    with pytest.raises(ValueError) as ours:
        tsm.ModelSpec.from_config(tcfg_mod.load_config(FLAGSHIP, opts), 10, 2)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("opts", [["MODEL.ADAPTER", "True"], ["MODEL.PROMPT", "True"],
                                  ["MODEL.FROZEN", "True"],
                                  ["MODEL.FROZEN", "True", "MODEL.ADAPTER", "True"],
                                  ["MODEL.MOE_EXPERTS", "4"]],
                         ids=["adapter", "prompt", "frozen", "frozen-adapter", "moe"])
def test_param_groups_of_the_variants_equal_jax(opts):
    """(lr, wd, trainable) of every port parameter equals the JAX leaf's
    that ``state_dict_from_jax`` maps to it: the adapters and prompts at
    BASE_LR (the port pinned them to the backbone's 5e-6), and under
    FROZEN a frozen backbone with its LoRA factors at BASE_LR."""
    tcfg, jcfg = tcfg_mod.load_config(FLAGSHIP, opts), jcfg_mod.load_config(FLAGSHIP, opts)
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
    assert set(names) <= set(mapped[0])
    for name in names:
        want = tuple(np.unique(m[name].numpy()) for m in mapped)
        assert all(len(w) == 1 for w in want), name
        lr, wd, trainable = ts.param_rule(name, tcfg)
        assert (np.float32(lr), np.float32(wd), float(trainable)) == \
            (want[0][0], want[1][0], want[2][0]), name
    variant = [n for n in names if "adapter" in n or ".lora_" in n]
    # the experts and routers are backbone parameters, as in JAX
    assert bool(variant) != ("MODEL.MOE_EXPERTS" in opts)
    groups = ts.build_param_groups(model, tcfg)
    for name, p in model.named_parameters():
        if name in variant:
            assert ts.param_rule(name, tcfg)[0] != 0.000005 and p.requires_grad, name
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    base = [n for n in names if n.startswith("clip_vision_encoder.base")
            and n not in variant]
    assert all(n in frozen for n in base) == ("MODEL.FROZEN" in opts)
    assert sum(len(g["params"]) for g in groups) == len(names) - len(frozen)
