"""Port parity: the Signal eval forward end to end, and weight carrying.

JAX weights from ``init_signal_params`` go through ``state_dict_from_jax``
into the port's ``Signal`` with ``load_state_dict(strict=True)``; the same
packed images and cameras then go through both ``forward_eval``s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu.config import load_config as jax_load_config
from signal_tpu.models import signal_model as jsm
from signal_tpu.models.clip_loader import export_reference_signal_state_dict
from signal_tpu_torch.config import load_config
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.models.convert import load_reference_checkpoint, state_dict_from_jax

from _torch_parity import TINY, images, tiny_pair, to_np


@pytest.mark.parametrize("dtype,miss", [("float32", "nothing"), ("bfloat16", "nothing"),
                                        ("float32", "rt")])
def test_forward_eval_matches_jax(dtype, miss):
    jspec, params, bn, model = tiny_pair(dtype, use_flash=True, miss=miss)
    rng = np.random.default_rng(0)
    x = images(rng, 4)
    cams = np.array([0, 2, 1, 2])
    want = jsm.forward_eval(params, bn, jnp.asarray(x), jnp.asarray(cams), jspec)
    with torch.inference_mode():
        got = tsm.forward_eval(model, torch.from_numpy(x), torch.from_numpy(cams))
    assert got.shape == (4, 6 * TINY["feat_dim"]) and got.dtype == torch.float32
    got, want = to_np(got), to_np(want)
    if dtype == "float32":
        # true fp32 throughout, summation order only (measured 1.2e-6)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
        return
    # bf16: the CLS features round at the same points (measured 8e-3,
    # |f| < 3). SIM's top-k then runs on patches that differ by bf16 ulps,
    # so a boundary token can flip and move that sample's fused half as a
    # whole (measured per-row cosine >= 0.9997): held by cosine instead.
    D3 = 3 * TINY["feat_dim"]
    np.testing.assert_allclose(got[:, :D3], want[:, :D3], atol=5e-2, rtol=2e-2)
    a, b = got[:, D3:], want[:, D3:]
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert cos.min() > 0.995, cos


def test_sie_is_repeated_per_sample_not_tiled():
    """Rows are sample-major: each sample's camera embedding goes to its own
    three modality rows, so permuting the samples permutes the features."""
    _, _, _, model = tiny_pair(use_flash=False)
    x = torch.from_numpy(images(np.random.default_rng(1), 3))
    cams = torch.tensor([0, 1, 2])
    with torch.inference_mode():
        f = tsm.forward_eval(model, x, cams)
        g = tsm.forward_eval(model, x.flip(0), cams.flip(0))
    np.testing.assert_allclose(to_np(g), to_np(f.flip(0)), atol=1e-5, rtol=1e-5)


def test_forward_eval_takes_a_modality_dict_like_the_packed_batch():
    _, _, _, model = tiny_pair(use_flash=False)
    x = torch.from_numpy(images(np.random.default_rng(2), 2))
    cams = torch.tensor([1, 0])
    with torch.inference_mode():
        packed = tsm.forward_eval(model, x, cams)
        split = tsm.forward_eval(model, dict(zip(tsm.MODALITIES, x.unbind(1))), cams)
    assert torch.equal(packed, split)


def test_state_dict_from_jax_equals_reference_export():
    jspec, params, bn, model = tiny_pair()
    ref = export_reference_signal_state_dict(params, bn, jspec)
    ours = state_dict_from_jax(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, bn), model.spec)
    assert set(ours) == set(ref) == set(model.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_reference_pth_loads_into_the_port(tmp_path):
    """A reference-named .pth (with a DataParallel prefix and BatchNorm
    counters) loads strictly and reproduces the source weights."""
    _, _, _, src = tiny_pair()
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.bottleneck.num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "Signal.pth"
    torch.save(sd, path)
    dst = tsm.init_signal(src.spec, seed=1)
    load_reference_checkpoint(dst, str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_init_signal_is_seeded():
    spec = tsm.ModelSpec(**TINY)
    a, b, c = tsm.init_signal(spec, 3), tsm.init_signal(spec, 3), tsm.init_signal(spec, 4)
    w = "clip_vision_encoder.base.transformer.resblocks.0.attn.in_proj_weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    # the JAX init's scale: xavier-uniform bound over the packed in_proj
    assert a.state_dict()[w].abs().max() <= (6.0 / (4 * TINY["width"])) ** 0.5


@pytest.mark.parametrize("config", ["configs/RGBNT201/Signal.yml", "configs/RGBNT100/Signal.yml",
                                    "configs/MSVR310/Signal.yml"])
def test_model_spec_from_config_matches_jax(config):
    cfg, jcfg = load_config(config), jax_load_config(config)
    ours = tsm.ModelSpec.from_config(cfg, 171, 4)
    theirs = jsm.ModelSpec.from_config(jcfg, 171, 4)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


def test_unported_backbones_raise_not_implemented():
    """The other backbones still raise; the CLIP tower's variants, which
    raised here until they were ported, build the JAX package's spec."""
    for ttype in ("resnet50", "vit_base_patch16_224"):
        cfg = load_config("configs/RGBNT201/Signal.yml", ["MODEL.TRANSFORMER_TYPE", ttype])
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
            tsm.ModelSpec.from_config(cfg, 10, 2)
    for opts in (["MODEL.ADAPTER", "True"], ["MODEL.PROMPT", "True"], ["MODEL.FROZEN", "True"],
                 ["MODEL.MOE_EXPERTS", "4", "MODEL.MOE_TOPK", "2"]):
        ours = tsm.ModelSpec.from_config(load_config("configs/RGBNT201/Signal.yml", opts), 10, 2)
        theirs = jsm.ModelSpec.from_config(
            jax_load_config("configs/RGBNT201/Signal.yml", opts), 10, 2)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (opts, f.name)
