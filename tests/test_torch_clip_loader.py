"""Port parity: the CLIP ``ViT-B-16.pt`` importer
(`signal_tpu_torch.models.clip_loader`) against the JAX package's
``load_clip_into_params`` on the same fabricated archives.

An archive holds a tiny CLIP visual tower (width 128, 2 layers, a 3×3
pretrained grid) and one text-side tensor, saved as OpenAI ships it
(TorchScript, fp16 weights) and as plain or nested ``torch.save`` state
dicts, in fp16 and fp32. Both importers read the same file; the resulting
weights must be equal under the reference names, and so must the imported
model's eval features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from signal_tpu.models import signal_model as jsm
from signal_tpu.models.clip_loader import (export_reference_signal_state_dict,
                                           load_clip_into_params)
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.models.clip_loader import load_clip_into_model
from signal_tpu_torch.models.vit import VisionTransformer, resize_pos_embed

from _torch_parity import TINY, images, tiny_pair, to_np

KINDS = ["torchscript-fp16", "torchscript-fp32", "state_dict-fp16", "state_dict-fp32",
         "nested-fp32"]


class _Clip(nn.Module):
    """The parameter layout of OpenAI's CLIP archive: ``visual.*`` and the
    text side (one tensor of it here)."""

    def __init__(self):
        super().__init__()
        self.visual = VisionTransformer(h_resolution=3, w_resolution=3, width=TINY["width"],
                                        layers=TINY["layers"], output_dim=TINY["feat_dim"])
        self.logit_scale = nn.Parameter(torch.ones([]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.logit_scale


def _write_archive(path, kind: str):
    gen = torch.Generator().manual_seed(5)
    clip = _Clip()
    clip.visual.reset_parameters(gen)
    with torch.no_grad():
        for name, p in clip.visual.named_parameters():
            if "ln" in name:  # LayerNorms off their identity init
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    if kind.endswith("fp16"):
        clip = clip.half()
    if kind.startswith("torchscript"):
        torch.jit.script(clip).save(str(path))
    elif kind.startswith("nested"):
        torch.save({"state_dict": clip.state_dict(), "epoch": 3}, path)
    else:
        torch.save(clip.state_dict(), path)
    return clip


_IMPORTED = {}


def _import(kind: str, tmp_path_factory):
    """→ (archive module, JAX spec, JAX (params, bn) after import, the port
    model after import), once per kind."""
    if kind not in _IMPORTED:
        path = tmp_path_factory.mktemp("clip") / f"{kind}.pt"
        clip = _write_archive(path, kind)
        jspec, params, bn, model = tiny_pair("float32", use_flash=True)
        jparams = load_clip_into_params(params, str(path), jspec)
        load_clip_into_model(model, str(path))
        _IMPORTED[kind] = clip, jspec, (jparams, bn), model
    return _IMPORTED[kind]


@pytest.fixture(params=KINDS)
def imported(request, tmp_path_factory):
    return _import(request.param, tmp_path_factory)


def test_imported_weights_equal_jax(imported):
    _, jspec, (jparams, bn), model = imported
    want = export_reference_signal_state_dict(jax.tree.map(np.asarray, jparams),
                                              jax.tree.map(np.asarray, bn), jspec)
    got = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(to_np(v), want[k], atol=1e-6, rtol=0, err_msg=k)


def test_imported_tower_is_the_archive_in_fp32(imported):
    """Every tower tensor is the archive's, widened to fp32; the pos embed
    is the archive's resized from 3×3 to the h×w grid, token 0 kept."""
    clip, _, _, model = imported
    tower, src = model.clip_vision_encoder.base, clip.visual.state_dict()
    for k, v in tower.state_dict().items():
        assert v.dtype == torch.float32, k
        if k != "positional_embedding":
            assert torch.equal(v, src[k].float()), k
    pos = resize_pos_embed(src["positional_embedding"].float(), TINY["h"], TINY["w"])
    assert torch.equal(tower.positional_embedding, pos)
    assert tower.positional_embedding.shape == (1 + TINY["h"] * TINY["w"], TINY["width"])


@pytest.mark.parametrize("kind", ["torchscript-fp16", "state_dict-fp32"])
def test_imported_model_features_equal_jax(kind, tmp_path_factory):
    _, jspec, (jparams, bn), model = _import(kind, tmp_path_factory)
    rng = np.random.default_rng(3)
    x, cams = images(rng, 3), np.array([0, 2, 1])
    want = jsm.forward_eval(jparams, bn, jnp.asarray(x), jnp.asarray(cams), jspec)
    with torch.inference_mode():
        got = tsm.forward_eval(model, torch.from_numpy(x), torch.from_numpy(cams))
    # test_torch_model.py's fp32 tolerance: summation order only
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-5, rtol=1e-5)


def test_a_missing_archive_raises(tmp_path):
    model = tsm.init_signal(tsm.ModelSpec(**TINY))
    with pytest.raises(FileNotFoundError, match="PRETRAIN_PATH_CLIP"):
        load_clip_into_model(model, str(tmp_path / "ViT-B-16.pt"))


def test_an_archive_of_another_width_raises(tmp_path):
    path = tmp_path / "wide.pt"
    _write_archive(path, "state_dict-fp32")
    model = tsm.init_signal(tsm.ModelSpec(**dict(TINY, width=64)))
    with pytest.raises(ValueError, match="archive shape"):
        load_clip_into_model(model, str(path))
