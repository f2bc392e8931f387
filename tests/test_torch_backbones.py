"""Port parity: the ImageNet ViT family and T2T (``signal_tpu_torch/models/
vit_imagenet.py``, ``t2t.py``) and what serves every backbone (the spec,
solver groups, FLOP counts, the zoo loader, the CLIP-path refusal),
against ``signal_tpu`` on the same seeded weights and inputs.

Tolerances: fp32 features atol 2e-5 + rtol 1e-5 (true fp32 on both sides,
summation order only, as ``tests/test_torch_model.py``); the train step
at PR 2's (loss rtol 1e-5, per-tensor gradient relative L2 < 1e-4,
parameters and statistics atol 1e-6 + rtol 1e-6); FLOP counts, specs and
solver groups exactly. The tiny towers: 2 layers of width 128 (4 heads)
on 64×32 or 64×64 images."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import config as jcfg_mod
from signal_tpu.models import signal_model as jsm
from signal_tpu.models import t2t as jt2t
from signal_tpu.models import vit_imagenet as jvi
from signal_tpu.ops import attention as jatt
from signal_tpu.utils import flops as jflops
from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch.losses import make_loss, total_train_loss
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.models import t2t as tt2t
from signal_tpu_torch.models import vit_imagenet as tvi
from signal_tpu_torch.models.convert import state_dict_from_jax
from signal_tpu_torch.models.lora import lora_modules
from signal_tpu_torch.ops import attention as tatt
from signal_tpu_torch.utils import flops

from _torch_parity import (
    assert_gradients_match,
    assert_groups_equal_jax,
    assert_updates_match,
    images,
    one_train_step,
    pair_from_config,
    tiny_pair,
    to_np,
    train_batch,
)

FP32 = dict(atol=2e-5, rtol=1e-5)
VIT = dict(num_classes=5, camera_num=3, width=128, layers=2, num_heads=4, feat_dim=128, topk=3,
           backbone="imagenet", h=4, w=2, img_h=64, img_w=32, use_a=False, use_b=False)
T2T = dict(VIT, backbone="t2t", mlp_ratio=3.0)
# the Signal-level slices: SIM, GAM + LAM (DAS needs a 4×4 grid: 64×64)
VIT_FULL = dict(VIT, h=4, w=4, img_h=64, img_w=64, use_a=True, use_b=True,
                stage="together_CLS_Patch", view_num=2, sie_view=True)
T2T_FULL = dict(VIT_FULL, backbone="t2t", mlp_ratio=3.0)
TYPES = ["vit_base_patch16_224", "deit_base_patch16_224", "vit_small_patch16_224",
         "deit_small_patch16_224", "t2t_vit_t_14", "t2t_vit_t_24", "resnet50", "resnet101",
         "resnet152", "osnet_x1_0", "osnet_x0_75", "osnet_x0_5", "osnet_x0_25", "ViT-B-16"]
CONFIG = "configs/RGBNT201/Signal.yml"


def _cfgs(*opts):
    return tcfg_mod.load_config(CONFIG, list(opts)), jcfg_mod.load_config(CONFIG, list(opts))


def jax_masks(rng, n_layers: int, rate: float, rows: int):
    """The keep masks JAX's ``_drop_path`` draws (`vit_imagenet.py:192-200`):
    bernoulli(fold_in(fold_in(rng, i), salt), 1 − rate_i), salt 0 for the
    attention branch and 1 for the MLP branch, as the port's [2, rows]."""
    out = []
    for i, r in enumerate(tvi.drop_path_rates(n_layers, rate)):
        if r == 0.0:
            out.append(None)
            continue
        key_i = jax.random.fold_in(rng, i)
        out.append(torch.from_numpy(np.stack([
            np.asarray(jax.random.bernoulli(jax.random.fold_in(key_i, salt), 1.0 - r,
                                            (rows, 1, 1))).reshape(rows)
            for salt in (0, 1)])))
    return out


def test_attention_scale_takes_the_eager_core(monkeypatch):
    """With a qk-scale override ``mha`` runs the eager core even under
    ``use_flash`` (JAX `ops/attention.py:131-138`), and equals JAX's."""
    _, params, _, model = tiny_pair(base=VIT, qk_scale=0.05)
    x = np.random.default_rng(0).standard_normal((3, 9, 128)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["base"]["blocks"])["attn"]
    want = jatt.mha(jp, jnp.asarray(x), num_heads=4, compute_dtype=jnp.float32,
                    use_flash=True, scale=0.05)
    import signal_tpu_torch.ops.flash_attention as fa

    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: pytest.fail("kernel taken"))
    a = model.base.blocks[0].attn
    got = tatt.attention(a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias,
                         torch.from_numpy(x), num_heads=4, compute_dtype=torch.float32,
                         use_flash=True, scale=0.05)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32)


# (name, spec fields, cams, views, qk_scale, drop-path rate)
TOWER_CASES = [
    ("stride16-cam", dict(camera_num=3), [0, 2], None, None, 0.0),
    ("stride12-cam-view", dict(stride_size=12, h=5, w=2, view_num=2, sie_view=True),
     [0, 2], [1, 0], None, 0.0),
    ("view-only", dict(sie_camera=False, view_num=3, sie_view=True), None, [2, 1], None, 0.0),
    ("qk-scale", dict(qk_scale=128 ** -0.5, mlp_ratio=3.0), [1, 1], None, 128 ** -0.5, 0.0),
    ("drop-path", dict(layers=3), [0, 1], None, None, 0.4),
]


@pytest.mark.parametrize("name,fields,cams,views,qk_scale,rate", TOWER_CASES,
                         ids=[c[0] for c in TOWER_CASES])
def test_imagenet_vit_forward_matches_jax(name, fields, cams, views, qk_scale, rate):
    """``imagenet_vit_forward`` against JAX's: stride 16 and an
    overlapping 12, each SIE index rule, a qk-scale override, and
    stochastic depth with JAX's masks injected; there, also the gradients
    through checkpointed blocks (the masks are inputs of each segment)."""
    jspec, params, _, model = tiny_pair(base=VIT, **fields)
    B = 2
    x = images(np.random.default_rng(1), B)[:, 0]
    c = None if cams is None else np.array(cams)
    v = None if views is None else np.array(views)
    rng = jax.random.PRNGKey(7) if rate else None
    kw = dict(camera_num=jspec.camera_num if jspec.sie_camera else 0, view_num=jspec.view_num,
              sie_xishu=1.5, num_heads=4, stride_size=jspec.stride_size,
              drop_path_rate=rate, qk_scale=qk_scale)

    def jax_fwd(base):
        return jvi.imagenet_vit_forward(
            base, jnp.asarray(x), None if c is None else jnp.asarray(c),
            None if v is None else jnp.asarray(v), rng=rng, compute_dtype=jnp.float32,
            use_flash=True, remat=bool(rate), **kw)

    # a fixed readout of both outputs (they end in a LayerNorm, so a sum of
    # squares would be constant)
    wr = np.random.default_rng(8)
    wp = wr.uniform(-1, 1, (B, jspec.h * jspec.w, 128)).astype(np.float32)
    wc = wr.uniform(-1, 1, (B, 128)).astype(np.float32)

    def loss_of(p, cls):
        if isinstance(p, torch.Tensor):
            return (p * torch.from_numpy(wp)).sum() + (cls * torch.from_numpy(wc)).sum()
        return (p * wp).sum() + (cls * wc).sum()

    jp, jc = jax_fwd(params["base"])
    masks = jax_masks(rng, jspec.layers, rate, B) if rate else None
    tp, tc = tvi.imagenet_vit_forward(
        model.base, torch.from_numpy(x), None if c is None else torch.from_numpy(c),
        None if v is None else torch.from_numpy(v), drop_masks=masks,
        compute_dtype=torch.float32, use_flash=True, remat=bool(rate), **kw)
    assert tp.shape == (B, jspec.h * jspec.w, 128)
    np.testing.assert_allclose(to_np(tp), to_np(jp), **FP32)
    np.testing.assert_allclose(to_np(tc), to_np(jc), **FP32)
    if not rate:
        return
    assert any(m is not None and not bool(m.all()) for m in masks)   # something dropped
    jg = jax.jit(jax.grad(lambda b: loss_of(*jax_fwd(b))))(params["base"])
    loss_of(tp, tc).backward()
    jg = state_dict_from_jax({"base": jax.tree.map(np.asarray, jg)}, {}, model.spec)
    assert_gradients_match({f"base.{n}": p.grad for n, p in model.base.named_parameters()
                            if p.grad is not None}, jg)


def test_drop_path_masks_are_drawn_once_per_layer():
    """The port draws each layer's masks from the generator before the
    blocks: none at rate 0, keep rate 1 − i/(L−1)·rate, and a seeded
    generator gives the same masks again."""
    masks = tvi.drop_path_masks(torch.Generator().manual_seed(3), 4, 0.3, 4096, "cpu")
    again = tvi.drop_path_masks(torch.Generator().manual_seed(3), 4, 0.3, 4096, "cpu")
    assert masks[0] is None and all(m.shape == (2, 4096) for m in masks[1:])
    assert all(torch.equal(a, b) for a, b in zip(masks[1:], again[1:]))
    for i, m in enumerate(masks[1:], start=1):
        assert abs(m.float().mean().item() - (1 - 0.1 * i)) < 0.03


def test_t2t_pieces_match_jax():
    """``unfold`` (``F.unfold``), the token transformer (one head, the
    input-dim scale, the v-skip) and ``t2t_forward`` with SIE."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 12, 8)).astype(np.float32)
    for k, s, p in ((7, 4, 2), (3, 2, 1)):
        np.testing.assert_array_equal(to_np(tt2t.unfold(torch.from_numpy(x), k, s, p)),
                                      to_np(jt2t._unfold(jnp.asarray(x), k, s, p)))
    jspec, params, _, model = tiny_pair(base=T2T)
    jtt = params["base"]["t2t"]["attn1"]
    tokens = rng.standard_normal((2, 16, 147)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tt2t.token_transformer(model.base.tokens_to_token.attention1,
                                     torch.from_numpy(tokens))),
        to_np(jt2t.token_transformer(jtt, jnp.asarray(tokens), 147, 64)), **FP32)
    imgs = images(rng, 2)[:, 0]
    cams = np.array([2, 0])
    want = jt2t.t2t_forward(params["base"], jnp.asarray(imgs), jnp.asarray(cams), sie_xishu=1.5,
                            num_heads=4, compute_dtype=jnp.float32)
    got = tt2t.t2t_forward(model.base, torch.from_numpy(imgs), torch.from_numpy(cams),
                           sie_xishu=1.5, num_heads=4, compute_dtype=torch.float32)
    assert got[0].shape == (2, 8, 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), **FP32)


@pytest.mark.parametrize("base", [VIT_FULL, T2T_FULL], ids=["imagenet", "t2t"])
def test_signal_forwards_match_jax(base):
    """``forward_eval`` and ``forward_train`` of the whole Signal (SIM, GAM +
    LAM, the BNNecks) on each ViT backbone, with cam×view SIE (the ImageNet
    tower's; T2T's is camera-only); the train forward moves the BNNecks'
    statistics as JAX's does."""
    jspec, params, bn, model = tiny_pair(base=base)
    rng = np.random.default_rng(3)
    x, cams, views = images(rng, 4, (64, 64)), np.array([0, 2, 1, 2]), np.array([1, 0, 0, 1])
    jx, jc, jv = jnp.asarray(x), jnp.asarray(cams), jnp.asarray(views)
    tx, tc, tv = torch.from_numpy(x), torch.from_numpy(cams), torch.from_numpy(views)
    want = jsm.forward_eval(params, bn, jx, jc, jspec, view_label=jv)
    with torch.inference_mode():
        got = tsm.forward_eval(model, tx, tc, view_label=tv)
    assert got.shape == (4, 6 * 128)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32)
    jout, jbn = jsm.forward_train(params, bn, jx, jc, jspec, view_label=jv)
    tout = tsm.forward_train(model, tx, tc, view_label=tv)
    for key in ("scores", "feats"):
        for g, w in zip(tout[key], jout[key], strict=True):
            np.testing.assert_allclose(to_np(g), to_np(w), atol=2e-5, rtol=1e-4)
    for key in ("gam", "lam"):
        assert tout[key].item() == pytest.approx(float(jout[key]), rel=1e-5)
    want_bn = state_dict_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, jbn), jspec)
    for k in ("bottleneck.running_var", "bottleneck_var.running_mean"):
        np.testing.assert_allclose(to_np(model.state_dict()[k]), to_np(want_bn[k]), atol=1e-6,
                                   rtol=1e-5)


# the ViT families of tests/test_backbone_grads.py's VARIANTS, shrunk to
# two layers of 16-wide heads (each keeps its head count, mlp ratio and
# scale; deit_small is vit_base's tower at other widths, held by the spec
# and forward tests).
# The tiny T2T at its init std (σ 0.02 kernels) maps every input to nearly
# one CLS feature (pairwise d² from 0.015 against |f|² = 288), so the
# BNNecks and the triplet after it work on differences that fp32 rounds at
# 1e-3 (JAX's own jitted and eager steps differ by 1.3e-5 in the loss and
# 5e-4 in a gradient). Its step is held on kernels at 5× that std (d² from
# 79), a tower that tells its inputs apart as the ImageNet ViT does at its
# init (d² from 38). The numbers: scripts/parity_conditioning.py.
STEP_VARIANTS = [
    ("vit_base_patch16_224", dict(layers=2, width=192, feat_dim=192), 1.0),
    ("vit_small_patch16_224", dict(layers=2, width=128, feat_dim=128), 1.0),
    ("t2t_vit_t_14", dict(layers=2, width=96, feat_dim=96), 5.0),
]


@pytest.fixture(scope="module", params=STEP_VARIANTS, ids=[v[0] for v in STEP_VARIANTS])
def vit_step(request):
    ttype, shrink, kernel_scale = request.param
    jcfg, tcfg, jspec, params, bn, model = pair_from_config(ttype, dict(shrink, topk=3,
                                                                         remat=True))
    if kernel_scale != 1.0:
        params = dict(params, base=jax.tree_util.tree_map_with_path(
            lambda path, a: a * kernel_scale if "kernel" in jax.tree_util.keystr(path) else a,
            params["base"]))
        model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                                  jax.tree.map(np.asarray, bn), model.spec))
    return one_train_step(jcfg, tcfg, jspec, params, bn, model)


def test_vit_train_step_loss_matches_jax(vit_step):
    assert vit_step["tloss"] == pytest.approx(vit_step["jloss"], rel=1e-5)


def test_vit_train_step_gradients_match_jax(vit_step):
    assert len(vit_step["tgrads"]) > 30
    assert_gradients_match(vit_step["tgrads"], vit_step["jgrads"])


def test_vit_train_step_updates_match_jax(vit_step):
    assert assert_updates_match(vit_step) > 30


@pytest.mark.parametrize("base", [VIT, T2T], ids=["imagenet", "t2t"])
def test_frozen_lora_matches_jax(base):
    """MODEL.FROZEN: LoRA on JAX's targets (paths ending in qkv_kernel,
    out_kernel, fc_kernel, proj_kernel: for T2T also the token
    transformers' qkv, not their proj or the projection), the merged
    forward and the factors' gradients."""
    jspec, params, bn, model = tiny_pair(base=base, frozen=True)
    # B starts at zero; give it values so that the merge shows
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.01 * jax.random.normal(jax.random.PRNGKey(len(str(p))), a.shape)
        if str(p[-1]) == "['lora_B']" else a, params)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                              jax.tree.map(np.asarray, bn), model.spec))
    # JAX stacks the blocks' factors: one leaf triple per kernel name
    n_jax = len(jax.tree.leaves(params["lora"])) // 3
    assert n_jax == 4 + 2 * (base is T2T)
    n_port = len(list(lora_modules(model.base)))
    assert n_port == 4 * jspec.layers + 2 * (base is T2T)
    x, cams = images(np.random.default_rng(4), 2), np.array([1, 2])
    got = tsm.forward_eval(model, torch.from_numpy(x), torch.from_numpy(cams))
    # a fixed random readout: the features end in LayerNorms, so a sum of
    # their squares would be constant and its gradient zero
    w = np.random.default_rng(5).uniform(-1, 1, tuple(got.shape)).astype(np.float32)

    def readout(lora):
        f = jsm.forward_eval({**params, "lora": lora}, bn, jnp.asarray(x), jnp.asarray(cams),
                             jspec)
        return jnp.sum(f * w), f

    (_, want), jg = jax.jit(jax.value_and_grad(readout, has_aux=True))(params["lora"])
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32)
    (got * torch.from_numpy(w)).sum().backward()
    jg = state_dict_from_jax({**jax.tree.map(np.asarray, params),
                              "lora": jax.tree.map(np.asarray, jg)},
                             jax.tree.map(np.asarray, bn), model.spec)
    tg = {n: p.grad for n, p in model.named_parameters() if "lora_" in n}
    assert len(tg) == 2 * n_port
    assert_gradients_match(tg, jg)


@pytest.mark.parametrize("ttype", TYPES)
def test_spec_and_flops_equal_jax(ttype):
    """``ModelSpec.from_config`` field for field, ``image_size``, and the
    analytic FLOPs (eval, train, hardware) at the full spec, exactly; at
    STRIDE_SIZE 12 too for the ViTs."""
    strides = ["[16, 16]", "[12, 12]"] if "resnet" not in ttype and "osnet" not in ttype \
        else ["[16, 16]"]
    for stride in strides:
        tcfg, jcfg = _cfgs("MODEL.TRANSFORMER_TYPE", ttype, "MODEL.STRIDE_SIZE", stride)
        ours, theirs = tsm.ModelSpec.from_config(tcfg, 171, 4), jsm.ModelSpec.from_config(jcfg, 171, 4)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (ttype, f.name)
        assert ours.image_size == theirs.image_size == (256, 128)
        for B in (1, 64, 128):
            for kw in (dict(), dict(train=True), dict(train=True, hardware=True)):
                assert flops.signal_analytic_flops(ours, B, **kw) == \
                    jflops.signal_analytic_flops(theirs, B, **kw), (ttype, B, kw)
                assert flops.flash_attention_flops(ours, B, **kw) == \
                    jflops.flash_attention_flops(theirs, B, **kw)
    assert ours.attention_kernel == (ttype in ("ViT-B-16", "vit_base_patch16_224",
                                               "deit_base_patch16_224", "deit_small_patch16_224"))


def test_image_size_is_ambiguous_where_jax_says_so():
    for mod in (tsm, jsm):
        spec = mod.ModelSpec(num_classes=2, camera_num=2, stride_size=12, h=5, w=2)
        with pytest.raises(ValueError, match="ambiguous"):
            spec.image_size
        assert dataclasses.replace(spec, stride_size=16).image_size == (80, 32)


@pytest.mark.parametrize("ttype,frozen", [("vit_base_patch16_224", "False"),
                                          ("t2t_vit_t_14", "False"), ("t2t_vit_t_14", "True"),
                                          ("vit_small_patch16_224", "True")])
def test_param_groups_equal_jax_leaf_for_leaf(ttype, frozen):
    """(lr, wd, trainable) of every port parameter equals the JAX leaf's
    that ``state_dict_from_jax`` maps to it: the backbone at 0.8·BASE_LR
    (5e-6 for CLIP only), T2T's sinusoid table frozen, FROZEN's base
    frozen with its LoRA factors at BASE_LR (the CNNs' cases are in
    ``tests/test_torch_cnn.py``)."""
    tcfg, jcfg = _cfgs("MODEL.TRANSFORMER_TYPE", ttype, "MODEL.FROZEN", frozen)
    shrink = dict(layers=1, width=64, num_heads=2, feat_dim=64, h=4, w=4, topk=3)
    rules = assert_groups_equal_jax(tcfg, jcfg, shrink)
    if ttype.startswith("t2t"):
        assert not rules["base.pos_embed"][2]
    if frozen == "False":
        assert rules["base.blocks.0.mlp.fc1.weight"] == \
            (0.8 * tcfg.SOLVER.BASE_LR, tcfg.SOLVER.WEIGHT_DECAY, True)
    else:
        assert not any(r[2] for n, r in rules.items()
                       if n.startswith("base.") and "lora_" not in n)


def test_clip_archive_with_another_backbone_raises(tmp_path):
    """JAX loads MODEL.PRETRAIN_PATH_CLIP into whatever backbone the config
    names (a CLIP-shaped tree under another spec); the port refuses."""
    from signal_tpu_torch.cli import train_main

    for ttype in ("vit_base_patch16_224", "resnet50"):
        with pytest.raises(ValueError, match="not the CLIP tower"):
            train_main(["--config_file", "configs/synthetic/smoke.yml", "MODEL.DEVICE", "cpu",
                        "MODEL.TRANSFORMER_TYPE", ttype, "MODEL.PRETRAIN_PATH_CLIP",
                        str(tmp_path / "ViT-B-16.pt"), "OUTPUT_DIR", str(tmp_path)])


def test_timm_importer_matches_jax(tmp_path):
    """``load_timm_vit_params`` on a timm-named state dict the test writes
    (under ``model``, a DeiT distillation token, a 4×4 pretrained grid
    resized to 4×2) equals JAX's importer."""
    jspec, params, bn, model = tiny_pair(base=VIT)
    rng = np.random.default_rng(5)
    sd = {}
    for k, v in model.base.state_dict().items():
        if k == "sie_embed":
            continue
        shape = (1, 18, 128) if k == "pos_embed" else tuple(v.shape)
        sd[k] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    sd["head.weight"] = torch.zeros(10, 128)
    path = str(tmp_path / "deit_base_distilled_patch16_224.pth")
    torch.save({"model": sd}, path)
    jbase = jvi.load_timm_vit_params(path, params["base"], 4, 2)
    tvi.load_timm_vit_params(path, model.base, 4, 2)
    want = state_dict_from_jax(jax.tree.map(np.asarray, {**params, "base": jbase}),
                               jax.tree.map(np.asarray, bn), model.spec)
    got = model.state_dict()
    assert torch.equal(got["base.cls_token"], sd["cls_token"])
    for k, v in got.items():
        np.testing.assert_allclose(to_np(v), to_np(want[k]), atol=1e-6, rtol=1e-6, err_msg=k)


def test_zoo_loader_builds_the_torch_module(tmp_path, monkeypatch):
    """``build_zoo_backbone`` imports a zoo file (here one the test
    writes), builds the net in eval or train mode, loads a state dict with
    a ``module.`` prefix, and refuses one that matches nothing; the
    registry equals JAX's."""
    from signal_tpu.models import zoo as jzoo
    from signal_tpu_torch.models import zoo

    assert {k: dataclasses.asdict(v) for k, v in zoo.ZOO.items()} == \
        {k: dataclasses.asdict(v) for k, v in jzoo.ZOO.items()}
    (tmp_path / "mlfn.py").write_text(
        "import torch\n"
        "class MLFN(torch.nn.Module):\n"
        "    def __init__(self, num_classes, loss):\n"
        "        super().__init__()\n"
        "        self.conv = torch.nn.Conv2d(3, 8, 3)\n"
        "        self.bn = torch.nn.BatchNorm2d(8)\n"
        "        self.fc = torch.nn.Linear(8, num_classes)\n"
        "        self.loss = loss\n"
        "    def forward(self, x):\n"
        "        return self.bn(self.conv(x)).mean((2, 3))\n"
        "def mlfn(num_classes, loss='softmax', pretrained=False, **kw):\n"
        "    assert not pretrained\n"
        "    return MLFN(num_classes, loss)\n")
    monkeypatch.setenv("SIGNAL_ZOO_DIR", str(tmp_path))
    src = zoo.build_zoo_backbone("mlfn", num_classes=7, train_mode=True)
    assert src.training and src.fc.out_features == 7 and src.loss == "softmax"
    sd = {f"module.{k}": v + 1.0 for k, v in src.state_dict().items()}
    net = zoo.build_zoo_backbone("mlfn", num_classes=7, state_dict=sd)
    assert not net.training
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[f"module.{k}"]), k
    assert jzoo.load_zoo_module(str(tmp_path), "mlfn.py").mlfn is not None
    with pytest.raises(ValueError, match="matched 0"):
        zoo.build_zoo_backbone("mlfn", state_dict={"x.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="unknown zoo backbone"):
        zoo.build_zoo_backbone("nope")


def test_model_flops_counts_the_kernel_where_it_runs():
    """``model_flops`` adds the attention kernel's analytic count only on a
    path that runs it: the ImageNet tower with the kernel, not vit_small's
    scaled attention (the counter sees that eager core)."""
    _, _, _, model = tiny_pair(base=VIT)
    spec, B = model.spec, 2
    x = torch.from_numpy(images(np.random.default_rng(6), B))
    cams = torch.tensor([0, 1])
    with torch.inference_mode():
        counted = flops.cost_analysis(tsm.forward_eval, model, x, cams)["flops"]
    assert spec.attention_kernel
    assert flops.model_flops(model, B) == counted + flops.flash_attention_flops(spec, B)
    model.spec = dataclasses.replace(spec, qk_scale=0.1)
    with torch.inference_mode():
        eager = flops.cost_analysis(tsm.forward_eval, model, x, cams)["flops"]
    assert eager - counted == pytest.approx(flops.flash_attention_flops(spec, B), rel=1e-9)
    assert flops.model_flops(model, B) == eager


def test_train_step_draws_drop_path_from_the_generator():
    """At MODEL.DROP_PATH > 0 the ImageNet tower's step needs a generator
    and draws its masks from it: two seeded steps give the same loss, and
    a step at rate 0 another."""
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.solver import make_optimizer

    _, tcfg, _, _, _, model = pair_from_config(
        "vit_base_patch16_224", dict(layers=2, width=64, feat_dim=64, num_heads=4, topk=3,
                                     drop_path=0.5, remat=True))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    x, pids, cams = (torch.from_numpy(a) for a in train_batch(0))
    loss_fn = make_loss(tcfg, 5)
    with pytest.raises(ValueError, match="DROP_PATH need a torch.Generator"):
        make_train_step(model, tcfg, 5, make_optimizer(model, tcfg))
    losses = []
    for seed, rate in ((1, 0.5), (1, 0.5), (1, 0.0)):
        model.load_state_dict(state)
        model.spec = dataclasses.replace(model.spec, drop_path=rate)
        out = tsm.forward_train(model, x, cams, gen=torch.Generator().manual_seed(seed))
        losses.append(total_train_loss(out, pids, loss_fn, gram_weight=0.2,
                                       pat_weight=0.2).item())
    assert losses[0] == losses[1] != losses[2]
