"""Port parity: the CLIP tower's variants (MODEL.ADAPTER, MODEL.PROMPT,
MODEL.FROZEN with LoRA, MODEL.MOE_EXPERTS) against the JAX package, after
`tests/test_text_and_variants.py:263,294` and `tests/test_lora_frozen.py`.

Every case builds one tiny spec in both packages, carries the JAX weights
into the port with ``state_dict_from_jax`` (prompt tokens and LoRA B
factors, zero at init, are first set to seeded values so that they count)
and runs the same numpy inputs through both, in fp32, at the tolerances
of PERF.md §2: the prompted block and tower, the adapter block, the LoRA
merge, each variant's ``forward_eval`` and one train step (loss, every
gradient, the updated parameters), the CLIP import, the train CLI and the
serving export.
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
from signal_tpu.models import lora as jlora
from signal_tpu.models import signal_model as jsm
from signal_tpu.models import vit as jvit
from signal_tpu.models import vit_prompt as jvp
from signal_tpu.models.clip_loader import load_clip_into_params
from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch import serving
from signal_tpu_torch.engine.train import make_train_step
from signal_tpu_torch.models import lora as tlora
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.models import vit as tvit
from signal_tpu_torch.models import vit_prompt as tvp
from signal_tpu_torch.models.clip_loader import load_clip_into_model
from signal_tpu_torch.models.convert import state_dict_from_jax
from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

from _torch_parity import TRAIN_IMG_HW, TRAIN_TINY, images, tiny_pair, tiny_train_cfg, to_np

FP32 = dict(atol=2e-5, rtol=1e-5)      # summation order only (PERF.md §2)
# the variants at the train slice's tiny size; each entry: (spec fields,
# the config overrides that name the same variant)
VARIANTS = {
    "adapter": (dict(adapter=True), ("MODEL.ADAPTER", "True")),
    "prompt": (dict(prompt=True), ("MODEL.PROMPT", "True")),
    "prompt-adapter": (dict(prompt=True, adapter=True),
                       ("MODEL.PROMPT", "True", "MODEL.ADAPTER", "True")),
    "frozen": (dict(frozen=True), ("MODEL.FROZEN", "True")),
    "moe-k1": (dict(moe_experts=4, moe_topk=1), ("MODEL.MOE_EXPERTS", "4")),
    "moe-k2": (dict(moe_experts=4, moe_topk=2),
               ("MODEL.MOE_EXPERTS", "4", "MODEL.MOE_TOPK", "2")),
}


def _variant_pair(name: str, seed: int = 0):
    """→ (JAX spec, JAX params, JAX bn, port model) of the variant, the
    prompt tokens and LoRA B factors set to seeded values in both."""
    kw, _ = VARIANTS[name]
    jspec, params, bn, model = tiny_pair("float32", use_flash=True, base=TRAIN_TINY,
                                         seed=seed, **kw)
    rng = np.random.default_rng(100 + seed)
    params = jax.tree.map(np.asarray, params)
    if "prompt" in params:
        for m in ("rgb", "nir", "tir"):
            p = params["prompt"][f"prompt_{m}"]
            params["prompt"][f"prompt_{m}"] = (0.1 * rng.standard_normal(p.shape)).astype(
                np.float32)
    for sub in params.get("lora", {}).get("blocks", {}).values():
        for leaf in sub.values():
            leaf["lora_B"] = (0.05 * rng.standard_normal(leaf["lora_B"].shape)).astype(
                np.float32)
    model.load_state_dict(state_dict_from_jax(params, jax.tree.map(np.asarray, bn),
                                              model.spec), strict=True)
    return jspec, jax.tree.map(jnp.asarray, params), bn, model


def _tokens(rng, B, L, D):
    return rng.standard_normal((B, L, D)).astype(np.float32)


@pytest.mark.parametrize("modality", ["rgb", "nir", "tir"])
def test_prompt_block_matches_jax(modality):
    """Two prompted blocks: the stripped tokens and the block's prompt,
    with the learned prompt alone (block 0) and then with block 0's prompt
    through the transfer MLP (block 1)."""
    jspec, params, _, model = _variant_pair("prompt")
    x = _tokens(np.random.default_rng(1), 2, 17, jspec.width)
    kw = dict(num_heads=jspec.num_heads, use_flash=True)
    jx, jlast, tx, tlast = jnp.asarray(x), None, torch.from_numpy(x), None
    for i, blk in enumerate(model.clip_vision_encoder.base.transformer.resblocks):
        jx, jlast = jvp.prompt_block(params["base"], params["prompt"], i, jx, jlast, modality,
                                     compute_dtype=jnp.float32, **kw)
        with torch.no_grad():
            tx, tlast = tvp.prompt_block(blk, tx, tlast, modality,
                                         compute_dtype=torch.float32, **kw)
        np.testing.assert_allclose(to_np(tx), to_np(jx), **FP32)
        np.testing.assert_allclose(to_np(tlast), to_np(jlast), **FP32)


@pytest.mark.parametrize("name", ["prompt", "prompt-adapter"])
def test_vit_forward_prompt_matches_jax(name):
    """The prompted tower per modality (with MODEL.ADAPTER also on, the
    reference's ``forward_with_prompt_adapter``), SIE on the CLS token."""
    jspec, params, _, model = _variant_pair(name)
    rng = np.random.default_rng(2)
    x = images(rng, 2, TRAIN_IMG_HW)
    cv = rng.standard_normal((2, jspec.width)).astype(np.float32)
    for m, modality in enumerate(jvp.MODALITY_ORDER):
        want = jvp.vit_forward_prompt(params["base"], params["prompt"], jnp.asarray(x[:, m]),
                                      jnp.asarray(cv), modality, num_heads=jspec.num_heads,
                                      compute_dtype=jnp.float32, use_flash=True)
        with torch.no_grad():
            got = tvp.vit_forward_prompt(model.clip_vision_encoder.base,
                                         torch.from_numpy(x[:, m]), torch.from_numpy(cv),
                                         modality, num_heads=jspec.num_heads,
                                         compute_dtype=torch.float32, use_flash=True)
        for a, b in zip(got, want):
            np.testing.assert_allclose(to_np(a), to_np(b), **FP32)


@pytest.mark.parametrize("policy", [None, "attn", "attn_mlp"])
def test_adapter_block_matches_jax(policy):
    """x + mlp(ln_2 x) + adapter(x) in one block, plainly and as the remat
    segments of 'attn' and 'attn_mlp' (the adapter on the pre-ln_2
    stream), with its gradient into the block's input."""
    jspec, params, _, model = _variant_pair("adapter")
    x = _tokens(np.random.default_rng(3), 2, 17, jspec.width)
    layer = jax.tree.map(lambda a: a[1], params["base"]["blocks"])
    kw = dict(num_heads=jspec.num_heads, use_flash=True)

    def jout(xx):
        return jvit._block(layer, xx, compute_dtype=jnp.float32, **kw)

    want, jvjp = jax.vjp(jout, jnp.asarray(x))
    blk = model.clip_vision_encoder.base.transformer.resblocks[1]
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tvit._block(blk, tx, compute_dtype=torch.float32, policy=policy, **kw)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(got, tx, torch.from_numpy(cot))
    np.testing.assert_allclose(to_np(gx), to_np(jvjp(jnp.asarray(cot))[0]), atol=1e-5,
                               rtol=1e-4)


def test_lora_factors_and_merge_match_jax():
    """The factors sit on the same four kernels per block as JAX's
    ``init_lora_factors`` (A kaiming-uniform, B zero, scale α/r = 2), the
    merge is the identity at init, and with B set the merged weights equal
    JAX's ``apply_lora`` (torch's [dout, din] layout against JAX's
    [din, dout])."""
    spec = tsm.ModelSpec(**TRAIN_TINY, frozen=True, lora_rank=4)
    model = tsm.init_signal(spec, seed=1)
    tower = model.clip_vision_encoder.base
    loras = list(tlora.lora_modules(tower))
    assert len(loras) == 4 * spec.layers
    for (module, weight), lora in zip(tlora.lora_targets(tower), loras):
        din = getattr(module, weight).shape[1]
        assert lora.lora_A.shape == (din, 4) and not torch.any(lora.lora_B)
        assert 0 < lora.lora_A.abs().max() <= din ** -0.5
        assert lora.lora_scale.item() == 2.0 and "lora_scale" not in dict(
            lora.named_parameters())
        assert torch.equal(getattr(module, weight),
                           module.parametrizations[weight].original)

    jspec, params, _, model = _variant_pair("frozen")
    merged = jlora.apply_lora(params["base"], params["lora"])
    for i, blk in enumerate(model.clip_vision_encoder.base.transformer.resblocks):
        for (path, weight), (sub, leaf) in zip(tlora.TARGETS, (
                ("attn", "qkv_kernel"), ("attn", "out_kernel"), ("mlp", "fc_kernel"),
                ("mlp", "proj_kernel"))):
            got = getattr(blk.get_submodule(path), weight)
            want = merged["blocks"][sub][leaf][i].T
            np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6, rtol=1e-6)
            assert not np.allclose(to_np(got), to_np(params["base"]["blocks"][sub][leaf][i].T))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_forward_eval_matches_jax(name):
    jspec, params, bn, model = _variant_pair(name)
    rng = np.random.default_rng(5)
    x = images(rng, 2, TRAIN_IMG_HW)
    cams = rng.integers(0, TRAIN_TINY["camera_num"], 2)
    want = jsm.forward_eval(params, bn, jnp.asarray(x), jnp.asarray(cams), jspec)
    with torch.no_grad():
        got = tsm.forward_eval(model, torch.from_numpy(x), torch.from_numpy(cams))
    assert got.shape == (2, jspec.eval_feat_dim)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32)


# weight decay 0: the first Adam moment is then 0.1·g exactly, so JAX's
# gradients are read back from its optimizer state (as test_torch_train.py)
NO_DECAY = ("SOLVER.WEIGHT_DECAY", "0.0", "SOLVER.WEIGHT_DECAY_BIAS", "0.0")


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = images(rng, 8, TRAIN_IMG_HW)
    pids = np.repeat(rng.permutation(TRAIN_TINY["num_classes"])[:4], 2)
    return x, pids, rng.integers(0, TRAIN_TINY["camera_num"], 8)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_train_step_matches_jax(name):
    """One fp32 train step of each variant (remat on, Adam, the config's
    MoE_Loss_weight): the loss, every gradient and every updated parameter
    against JAX's ``make_train_step``; under FROZEN only the LoRA factors,
    the SIE table and the heads move."""
    jspec, params, bn, model = _variant_pair(name)
    jspec = dataclasses.replace(jspec, remat=True)
    model.spec = dataclasses.replace(model.spec, remat=True)
    opts = (*NO_DECAY, *VARIANTS[name][1])
    jcfg, tcfg = tiny_train_cfg(jcfg_mod, None, *opts), tiny_train_cfg(tcfg_mod, None, *opts)
    C = jspec.num_classes
    p0 = model.state_dict()
    p0 = {k: v.clone() for k, v in p0.items()}

    groups = jax.tree.map(jnp.asarray, js.build_param_groups(params, jcfg))
    lr_a, lr_b = js.schedule_coeffs(jcfg, 1)
    x, pids, cams = _batch(9)
    batch = {"imgs": jnp.asarray(x), "pids": jnp.asarray(pids), "camids": jnp.asarray(cams)}
    jparams, jbn, opt_state, jloss, _, _ = jax_make_train_step(jspec, jcfg, C)(
        params, bn, js.adam_init(params), batch, jnp.float32(lr_a), jnp.float32(lr_b), groups)

    optimizer = make_optimizer(model, tcfg)
    set_lr(optimizer, *schedule_coeffs(tcfg, 1))
    tloss, _ = make_train_step(model, tcfg, C, optimizer)(
        torch.from_numpy(x), torch.from_numpy(pids), torch.from_numpy(cams))
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)

    np_bn = jax.tree.map(np.asarray, jbn)
    jgrads = state_dict_from_jax(jax.tree.map(lambda m: np.asarray(m) / 0.1, opt_state.mu),
                                 np_bn, jspec)
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    for n, p in model.named_parameters():
        if n not in trained:
            continue
        a = np.zeros(p.shape, np.float32) if p.grad is None else to_np(p.grad)
        b = to_np(jgrads[n])
        if np.linalg.norm(b) < 1e-6:   # analytically zero: rounding noise
            assert np.linalg.norm(a) < 1e-6, n
            continue
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-4, n
    jstate = state_dict_from_jax(jax.tree.map(np.asarray, jparams), np_bn, jspec)
    max_lr = max(g["lr"] for g in optimizer.param_groups)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = to_np(v), to_np(jstate[k])
        # Adam's first step moves an element by ≈ lr·g/|g|: where g is at
        # the gradient's own fp32 summation noise (below 1e-5 of the
        # tensor's largest, or 1e-7) that ratio is noise too, and the two
        # sides may differ by up to 2·lr
        g = np.abs(to_np(jgrads[k])) if k in jgrads else np.zeros(a.shape, np.float32)
        noise = (g < max(1e-7, 1e-5 * g.max(initial=0.0))) & (k in jgrads)
        np.testing.assert_allclose(a[~noise], b[~noise], atol=1e-6, rtol=1e-6, err_msg=k)
        assert np.abs(a[noise] - b[noise]).max(initial=0.0) <= 2 * max_lr, k
    if name == "frozen":
        moved = {k for k, v in model.state_dict().items() if not torch.equal(v, p0[k])}
        assert moved and all(".lora_" in k or not k.startswith("clip_vision_encoder.base")
                             for k in moved), sorted(moved)
        assert any(k.endswith("lora_B") for k in moved)
        assert any(k.startswith("classifier") for k in moved)


def _clip_archive(path, layers, width, feat_dim):
    """A seeded dense CLIP-shaped archive (plain state dict, fp32)."""
    gen = torch.Generator().manual_seed(7)
    visual = tvit.VisionTransformer(h_resolution=3, w_resolution=3, width=width,
                                    layers=layers, output_dim=feat_dim)
    visual.reset_parameters(gen)
    torch.save({f"visual.{k}": v for k, v in visual.state_dict().items()}, path)


@pytest.mark.parametrize("name", ["prompt-adapter", "frozen", "moe-k1"])
def test_clip_import_of_a_variant_matches_jax(name, tmp_path):
    """The CLIP import keeps the fresh adapters, prompts and LoRA factors,
    puts CLIP's kernels under the LoRA parametrizations, and upcycles the
    dense MLP into every expert with the router kept: the same weights as
    JAX's ``load_clip_into_params``."""
    jspec, params, bn, model = _variant_pair(name)
    path = tmp_path / "clip.pt"
    _clip_archive(path, jspec.layers, jspec.width, jspec.feat_dim)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jparams = load_clip_into_params(params, str(path), jspec)
    load_clip_into_model(model, str(path))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, bn),
                               jspec)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(to_np(v), to_np(want[k]), atol=1e-6, rtol=0, err_msg=k)
    fresh = [k for k in got if "adapter" in k or ".lora_" in k or k.endswith("moe.router")]
    assert fresh and all(torch.equal(got[k], before[k]) for k in fresh)


@pytest.mark.parametrize("name,nodes", [("prompt", 3), ("frozen", 1), ("moe-k2", 1)])
def test_variant_serving_export_keeps_the_operator(name, nodes, tmp_path):
    """A variant's ``forward_eval`` exported through the serving module
    with the attention operator (as ``export_eval`` does on the card; on
    the CPU the operator runs its plain version): one node per block and
    stream, 3 × layers for the prompted tower; the loaded artifact equals
    eager ``forward_eval``."""
    _, _, _, model = _variant_pair(name)
    spec = model.spec
    module = serving.ServingModule(model, spec).eval()
    example = ({m: torch.zeros(2, 3, *TRAIN_IMG_HW) for m in serving.MODALITIES},
               torch.zeros(2, dtype=torch.int64))
    with torch.no_grad():
        ep = torch.export.export(module, example, strict=False)
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count("signal_tpu_torch.attention_fwd.default") == nodes * spec.layers
    call, _ = serving.load_exported(serving.save_exported(ep, str(tmp_path / name)))
    rng = np.random.default_rng(10)
    x = images(rng, 2, TRAIN_IMG_HW)
    cams = torch.from_numpy(rng.integers(0, TRAIN_TINY["camera_num"], 2))
    imgs = dict(zip(serving.MODALITIES, torch.from_numpy(x).unbind(1)))
    with torch.inference_mode():
        want = tsm.forward_eval(model, imgs, cams)
    torch.testing.assert_close(call(imgs, cams), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("opts", [("MODEL.FROZEN", "True"),
                                  ("MODEL.PROMPT", "True", "MODEL.ADAPTER", "True"),
                                  ("MODEL.MOE_EXPERTS", "4", "MODEL.MOE_TOPK", "2")],
                         ids=["frozen", "prompt-adapter", "moe"])
def test_train_main_builds_the_variant_from_its_config(opts, tmp_path):
    """``train_main`` builds each variant from the config alone and trains
    a step and an eval on the CPU."""
    from signal_tpu_torch.cli import train_main

    shrink = ",".join(f"{k}={v}" for k, v in TRAIN_TINY.items()
                      if k not in ("num_classes", "camera_num"))
    state = train_main(["--config_file", "configs/synthetic/smoke.yml", "--shrink", shrink,
                        "--max_steps_per_epoch", "1", "MODEL.DEVICE", "cpu",
                        "INPUT.SIZE_TRAIN", "[64, 64]", "INPUT.SIZE_TEST", "[64, 64]",
                        "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.NUM_INSTANCE", "2",
                        "TEST.IMS_PER_BATCH", "8", "DATALOADER.NUM_WORKERS", "1",
                        "SOLVER.MAX_EPOCHS", "1", "SOLVER.EVAL_PERIOD", "1",
                        "SOLVER.CHECKPOINT_PERIOD", "1", "OUTPUT_DIR", str(tmp_path), *opts])
    assert state.epoch == 1 and np.isfinite(state.loss) and 0.0 <= state.mAP <= 1.0
    spec = state.model.spec
    assert (spec.frozen, spec.prompt, spec.adapter, spec.moe_experts) == (
        "MODEL.FROZEN" in opts, "MODEL.PROMPT" in opts, "MODEL.ADAPTER" in opts,
        4 if "MODEL.MOE_EXPERTS" in opts else 0)
