"""Port parity: the serving export (``signal_tpu_torch/serving.py``, a
``torch.export`` program) against ``signal_tpu/serving.py``'s
``jax.export`` artifact, and the attention kernel as a registered
operator inside an exported graph. CPU, toy sizes (``_torch_parity.TINY``:
a 2-layer tower of width 128 on 64×32 images)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import serving as jserving
from signal_tpu_torch import serving
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

from _torch_parity import IMG_HW, TINY, tiny_pair, to_np

OP = "signal_tpu_torch.attention_fwd.default"


def _imgs(rng, B, dtype=np.float32):
    if dtype == np.uint8:
        return {m: rng.integers(0, 256, (B, 3, *IMG_HW)).astype(np.uint8) for m in serving.MODALITIES}
    return {m: rng.standard_normal((B, 3, *IMG_HW)).astype(np.float32) for m in serving.MODALITIES}


def _torch(imgs):
    return {m: torch.from_numpy(v) for m, v in imgs.items()}


def _eager(model, spec, imgs, cams):
    """The port's forward_eval with the eager attention core."""
    model.spec = dataclasses.replace(spec, use_flash=False)
    with torch.inference_mode():
        return tsm.forward_eval(model, imgs, cams)


def _ops(ep):
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


def test_symbolic_batch_export_round_trip(tmp_path):
    """One artifact serves several batch sizes, 1 included (the export
    traces at 2, since a dimension of size 1 would be specialised)."""
    _, _, _, model = tiny_pair("float32", use_flash=True)
    spec = model.spec
    ep = serving.export_eval(model, spec, image_size=IMG_HW, device="cpu")
    path = serving.save_exported(ep, str(tmp_path / "artifact"), extra_manifest={"feat_dim": 384})
    call, manifest = serving.load_exported(path)
    assert manifest["feat_dim"] == 384 and manifest["bytes"] > 0
    assert manifest["device"] == "cpu" and manifest["format"] == "torch.export.ExportedProgram"
    assert manifest["in_avals"][0] == f"float32[b,3,{IMG_HW[0]},{IMG_HW[1]}]"
    assert manifest["out_avals"] == ["float32[b,384]"]
    for B in (1, 2, 5):
        rng = np.random.default_rng(B)
        imgs, cams = _torch(_imgs(rng, B)), torch.from_numpy(rng.integers(0, 3, B))
        got = call(imgs, cams)
        assert got.shape == (B, 6 * TINY["feat_dim"])
        # the same ops on the same values as the eager path
        torch.testing.assert_close(got, _eager(model, spec, imgs, cams), atol=1e-6, rtol=1e-6)


def test_uint8_fixed_batch_export(tmp_path):
    """normalize=(mean, std) bakes uint8 → Normalize into the graph."""
    _, _, _, model = tiny_pair("float32", use_flash=True)
    spec = model.spec
    norm = ((0.5, 0.4, 0.3), (0.5, 0.2, 0.1))
    ep = serving.export_eval(model, spec, image_size=IMG_HW, batch=3, normalize=norm,
                             device="cpu")
    call, manifest = serving.load_exported(serving.save_exported(ep, str(tmp_path / "u8")))
    assert manifest["in_avals"][0] == f"uint8[3,3,{IMG_HW[0]},{IMG_HW[1]}]"
    rng = np.random.default_rng(0)
    u8 = _imgs(rng, 3, np.uint8)
    cams = torch.tensor([0, 2, 1])
    out = call(_torch(u8), cams)
    assert out.shape == (3, 384) and torch.isfinite(out).all()
    mean, std = (np.asarray(v, np.float32)[None, :, None, None] for v in norm)
    f = {m: torch.from_numpy(((v / np.float32(255.0)) - mean) / std) for m, v in u8.items()}
    # Normalize as one multiply-add on the device against the division
    # here: float32 rounding only
    torch.testing.assert_close(out, _eager(model, spec, f, cams), atol=1e-5, rtol=1e-5)
    with pytest.raises(Exception):
        call(_torch(_imgs(rng, 2, np.uint8)), cams[:2])   # a fixed batch serves 3 only


def test_cpu_export_drops_the_kernel_and_one_device_only():
    """Exported on the CPU, a flash-enabled spec at a fixed batch takes the
    eager core (the kernel's operator would run its plain version there);
    an artifact serves one device."""
    _, _, _, model = tiny_pair("float32", use_flash=True)
    assert model.spec.use_flash
    ep = serving.export_eval(model, model.spec, image_size=IMG_HW, batch=2, device="cpu")
    assert OP not in _ops(ep)
    with pytest.raises(ValueError, match="one device"):
        serving.export_eval(model, model.spec, image_size=IMG_HW, batch=2,
                            device=["cpu", "cuda"])


def test_export_rejects_wrong_rank(tmp_path):
    _, _, _, model = tiny_pair("float32", use_flash=False)
    ep = serving.export_eval(model, model.spec, image_size=IMG_HW, batch=2, device="cpu")
    call, _ = serving.load_exported(serving.save_exported(ep, str(tmp_path / "a")))
    bad = {m: torch.zeros(2, 3, IMG_HW[0] // 2, IMG_HW[1]) for m in serving.MODALITIES}
    with pytest.raises(Exception):
        call(bad, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(Exception):
        call({m: torch.zeros(2, IMG_HW[0], IMG_HW[1]) for m in serving.MODALITIES},
             torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_operator_is_kept_in_an_exported_graph(tmp_path, dtype):
    """A module that calls ``flash_attention`` exports with the kernel's
    operator as one node (its fake implementation gives the shape), and
    the loaded program runs the operator's CPU implementation."""

    class Attend(torch.nn.Module):
        def forward(self, q, k, v):
            return flash_attention(q, k, v, num_heads=2, compute_dtype=dtype)

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, L, 16)).astype(np.float32))
               for L in (5, 7, 7))
    with torch.no_grad():
        ep = torch.export.export(Attend(), (q, k, v), strict=False)
    assert _ops(ep).count(OP) == 1
    torch.export.save(ep, str(tmp_path / "attend.pt2"))
    got = torch.export.load(str(tmp_path / "attend.pt2")).module()(q, k, v)
    want = flash_attention_reference(q.to(dtype), k.to(dtype), v.to(dtype), 2)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_symbolic_batch_graph_keeps_the_operator(tmp_path):
    """The whole serving module with the kernel's operator, traced at a
    symbolic batch (as ``export_eval`` does on the card, here on the CPU
    where it runs the operator's plain version): one node per block,
    saved and loaded, equal to eager ``forward_eval`` with the same
    operator at B = 1, 2 and 5."""
    _, _, _, model = tiny_pair("float32", use_flash=True)
    spec = model.spec
    module = serving.ServingModule(model, spec).eval()
    example = ({m: torch.zeros(2, 3, *IMG_HW) for m in serving.MODALITIES},
               torch.zeros(2, dtype=torch.int64))
    b = torch.export.Dim("b", min=1)
    with torch.no_grad():
        ep = torch.export.export(module, example, strict=False,
                                 dynamic_shapes=({m: {0: b} for m in serving.MODALITIES}, {0: b}))
    assert _ops(ep).count(OP) == TINY["layers"]
    call, manifest = serving.load_exported(serving.save_exported(ep, str(tmp_path / "sym")))
    assert manifest["in_avals"][0] == f"float32[b,3,{IMG_HW[0]},{IMG_HW[1]}]"
    for B in (1, 2, 5):
        rng = np.random.default_rng(20 + B)
        imgs, cams = _torch(_imgs(rng, B)), torch.from_numpy(rng.integers(0, 3, B))
        model.spec = spec
        with torch.inference_mode():
            want = tsm.forward_eval(model, imgs, cams)
        torch.testing.assert_close(call(imgs, cams), want, atol=1e-6, rtol=1e-6)


def test_artifact_features_equal_the_jax_artifact(tmp_path):
    """The same weights (carried by ``state_dict_from_jax``) exported by
    both packages at a symbolic batch, fp32: equal features."""
    jspec, params, bn, model = tiny_pair("float32", use_flash=True)
    jex = jserving.export_eval(params, bn, jspec, image_size=IMG_HW)
    jcall, _ = jserving.load_exported(jserving.save_exported(jex, str(tmp_path / "jax")))
    ep = serving.export_eval(model, model.spec, image_size=IMG_HW, device="cpu")
    tcall, _ = serving.load_exported(serving.save_exported(ep, str(tmp_path / "torch")))
    for B in (2, 3):
        rng = np.random.default_rng(10 + B)
        imgs, cams = _imgs(rng, B), rng.integers(0, 3, B)
        want = jcall({m: jnp.asarray(v) for m, v in imgs.items()}, jnp.asarray(cams, jnp.int32))
        got = tcall(_torch(imgs), torch.from_numpy(cams))
        # true fp32 on both sides: summation order only (as test_torch_model)
        np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-5, rtol=1e-5)


def test_export_script_needs_camera_num_with_sie(tmp_path):
    """Skipping the dataset scan (--num_classes) while MODEL.SIE_CAMERA is
    on fails before any model is built."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("export_serving_torch",
                                                  "scripts/export_serving_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(ValueError, match="camera_num"):
        mod.main(["--config_file", "configs/RGBNT201/Signal.yml", "-o", str(tmp_path / "a"),
                  "--num_classes", "171", "MODEL.DEVICE", "cpu"])
