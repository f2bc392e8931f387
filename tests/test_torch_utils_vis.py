"""Port parity: the cost, profiling and visualization utilities
(``signal_tpu_torch/utils/{flops,profiler,tracer}.py``, ``vis.py``)
against ``signal_tpu``'s on the same seeded inputs and weights."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import vis as jvis
from signal_tpu.config import load_config as jload_config
from signal_tpu.models import signal_model as jsm
from signal_tpu.utils import flops as jflops
from signal_tpu_torch import vis
from signal_tpu_torch.config import load_config
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.utils import flops, profiler, tracer

from _torch_parity import IMG_HW, TINY, TRAIN_TINY, images, tiny_pair, to_np

CONFIGS = ["configs/RGBNT201/Signal.yml", "configs/RGBNT100/Signal.yml",
           "configs/MSVR310/Signal.yml"]


@pytest.mark.parametrize("hardware", [False, True])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("config", CONFIGS)
def test_analytic_flops_equal_jax(config, train, hardware):
    """The same arithmetic on specs built from the same config by each
    package: equal to the last bit, model (MFU) and hardware (HFU) counts,
    for the attention kernels alone and for the whole model."""
    jspec = jsm.ModelSpec.from_config(jload_config(config), num_classes=171, camera_num=4)
    tspec = tsm.ModelSpec.from_config(load_config(config), num_classes=171, camera_num=4)
    for B in (1, 64, 128):
        kw = dict(train=train, hardware=hardware)
        assert flops.signal_analytic_flops(tspec, B, **kw) == \
            jflops.signal_analytic_flops(jspec, B, **kw)
        assert flops.flash_attention_flops(tspec, B, **kw) == \
            jflops.flash_attention_flops(jspec, B, **kw)
    for policy in ("half", "dots"):
        kw = dict(train=True, hardware=True)
        assert flops.signal_analytic_flops(dataclasses.replace(tspec, remat_policy=policy), 8,
                                           **kw) == \
            jflops.signal_analytic_flops(dataclasses.replace(jspec, remat_policy=policy), 8, **kw)


def test_analytic_flops_of_the_flagship():
    """The counts PERF.md's MFU lines use: the flagship eval batch of 128
    and train step of 64 (about 8.85 and 13.3 TFLOP)."""
    spec = tsm.ModelSpec.from_config(load_config(CONFIGS[0]), num_classes=171, camera_num=4)
    assert 8.7e12 < flops.signal_analytic_flops(spec, 128) < 9.0e12
    assert 13.1e12 < flops.signal_analytic_flops(spec, 64, train=True) < 13.5e12
    # the other backbones count as JAX's do (every one is held in
    # tests/test_torch_backbones.py)
    jspec = jsm.ModelSpec.from_config(jload_config(CONFIGS[0]), num_classes=171, camera_num=4)
    for fields in (dict(backbone="resnet", layers=50, feat_dim=2048, h=16, w=8),
                   dict(backbone="imagenet", feat_dim=768)):
        assert flops.signal_analytic_flops(dataclasses.replace(spec, **fields), 1) == \
            jflops.signal_analytic_flops(dataclasses.replace(jspec, **fields), 1)


def test_flop_counter_matches_the_analytic_count_less_the_kernel():
    """FlopCounterMode on the tiny eval forward counts every product but
    the kernel's operator, which it cannot see: the count equals the
    analytic one less the attention kernels' share, to 2 % (measured 0.9 %
    below it: the analytic count of SIM's selection and MHCA products is
    the JAX package's estimate, not the code's exact products)."""
    _, _, _, model = tiny_pair("float32", use_flash=True)
    spec, B = model.spec, 4
    x = torch.from_numpy(images(np.random.default_rng(0), B))
    cams = torch.tensor([0, 2, 1, 2])
    with torch.inference_mode():
        counted = flops.cost_analysis(tsm.forward_eval, model, x, cams)
    want = flops.signal_analytic_flops(spec, B) - flops.flash_attention_flops(spec, B)
    assert counted["flops"] == pytest.approx(want, rel=0.02)
    assert flops.model_flops(model, B) == pytest.approx(
        counted["flops"] + flops.flash_attention_flops(spec, B), rel=1e-12)
    # the eager core is seen: the kernel's share comes back
    model.spec = dataclasses.replace(spec, use_flash=False)
    with torch.inference_mode():
        eager = flops.cost_analysis(tsm.forward_eval, model, x, cams)["flops"]
    assert eager - counted["flops"] == pytest.approx(flops.flash_attention_flops(spec, B), rel=1e-9)


def test_cost_analysis_and_param_count():
    a = torch.ones(32, 32)
    assert flops.cost_analysis(lambda x: x @ x, a)["flops"] == 2 * 32 ** 3
    _, params, bn, model = tiny_pair()
    assert flops.param_count(model) == jflops.param_count(params)


def test_peaks_table():
    bw, bf16, fp32, tf32 = flops.peaks_for("NVIDIA H100 80GB HBM3")
    assert (bw, bf16, fp32, tf32) == (3.35e12, 989e12, 67e12, 495e12)
    assert flops.peaks_for("NVIDIA H100 PCIe")[1] == 756e12
    assert flops.peak_flops_per_chip("NVIDIA H200") == 989e12
    with pytest.raises(ValueError, match="no published peaks"):
        flops.peaks_for("TPU v5 lite")


def test_tracer_writes_log(tmp_path):
    out = str(tmp_path / "trace_log.txt")

    def g(n):
        return sum(range(n))

    assert tracer.trace_callable(g, 5, mode="lines", out_path=out) == 10
    assert os.path.getsize(out) > 0
    with pytest.raises(ValueError, match="mode"):
        tracer.ExecutionTracer(mode="everything")


def test_profiler_trace_writes_the_timeline_and_the_spans(tmp_path):
    with profiler.trace(str(tmp_path / "tr")) as prof:
        with profiler.span("train.step", request=2):
            with profiler.span("model.tower"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == ["train.step", "model.tower"]
    assert [e["args"]["parent"] for e in mine] == [None, 0]
    assert [e["args"]["request"] for e in mine] == [2, 2]
    mm = next(e for e in events if e.get("name") == "aten::mm")
    assert mine[1]["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= mine[1]["ts"] + mine[1]["dur"]
    assert mine[0]["args"]["self_us"] == pytest.approx(mine[0]["dur"] - mine[1]["dur"], abs=1e-3)
    assert profiler._recorder is None


def test_masks_overlay_and_ranked_list_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    masks = {m: (rng.random((2, 8)) > 0.5).astype(np.float32) for m in ("RGB", "NI", "TI")}
    got, want = vis.masks_to_grids(masks, 4, 2), jvis.masks_to_grids(masks, 4, 2)
    assert all(np.array_equal(got[k], want[k]) for k in masks)
    img = rng.random((3, 64, 30)).astype(np.float32)       # a grid that does not divide it
    assert np.array_equal(vis.overlay_mask(img, got["RGB"][0]),
                          jvis.overlay_mask(img, want["RGB"][0]))
    dist = rng.random((3, 5))
    q, g = [f"q{i}" for i in range(3)], [f"g{i}" for i in range(5)]
    rows = vis.save_ranked_list(dist, q, g, str(tmp_path / "t"), topk=3)
    assert rows == jvis.save_ranked_list(dist, q, g, str(tmp_path / "j"), topk=3)
    assert (tmp_path / "t" / "ranked_lists.txt").read_text() == \
        (tmp_path / "j" / "ranked_lists.txt").read_text()


def test_das_offset_field_equals_jax():
    """Through the weights ``state_dict_from_jax`` carries: the port's
    field is the JAX one (true fp32 convs on both sides)."""
    _, params, _, model = tiny_pair("float32", base=TRAIN_TINY)
    grid = np.random.default_rng(1).standard_normal((2, TINY["feat_dim"], 8, 4)).astype(np.float32)
    got = vis.das_offset_field(model.AlignM.DAS_n, grid)
    want = jvis.das_offset_field(params["AlignM"]["DAS_n"], grid)
    assert got.shape == want.shape == (2, 2, 1, 2)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_input_saliency_equals_jax_grad():
    """|d Σ‖f‖ / d pixel| through the tiny eval forward (fp32, eager
    attention): ``torch.autograd`` against ``jax.grad`` on the same
    weights and images."""
    jspec, params, bn, model = tiny_pair("float32", use_flash=False)
    rng = np.random.default_rng(2)
    x = images(rng, 2)
    cams = np.array([1, 0])
    imgs = {m: x[:, i] for i, m in enumerate(tsm.MODALITIES)}
    got = vis.input_saliency(lambda d: tsm.forward_eval(model, d, torch.from_numpy(cams)), imgs)
    want = jvis.input_saliency(
        lambda d: jsm.forward_eval(params, bn, d, jnp.asarray(cams), jspec),
        {m: jnp.asarray(v) for m, v in imgs.items()})
    for m in tsm.MODALITIES:
        assert got[m].shape == (2, *IMG_HW)
        np.testing.assert_allclose(got[m], want[m], atol=1e-5)


def test_token_grad_cam_equals_jax():
    B, L, D = 2, 8, 16
    base = np.random.default_rng(0).standard_normal((B, L, D)).astype(np.float32)
    scale = np.ones(L, np.float32)
    scale[3] = 10.0
    got = vis.token_grad_cam(lambda d: {"RGB": d["RGB"] * torch.from_numpy(scale)[None, :, None]},
                             {"RGB": torch.from_numpy(base)})
    want = jvis.token_grad_cam(lambda d: {"RGB": d["RGB"] * jnp.asarray(scale)[None, :, None]},
                               {"RGB": jnp.asarray(base)})
    np.testing.assert_allclose(got["RGB"], want["RGB"], atol=1e-6)
    assert (got["RGB"].argmax(axis=1) == 3).all()


def test_similarity_kde_overlap_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    qf, pids = rng.standard_normal((12, 8)), rng.integers(0, 3, 12)
    assert vis.save_similarity_kde(qf, pids, str(tmp_path / "t.png")) == \
        jvis.save_similarity_kde(qf, pids, str(tmp_path / "j.png"))


def test_matplotlib_renders(tmp_path):
    """The figure writers (matplotlib is optional; the card's host has
    none): the fusion KDE, the ranked-list grid with the scene filter,
    and the t-SNE scatter."""
    pytest.importorskip("matplotlib")
    from signal_tpu_torch.data.datasets import synthetic_dataset

    rng = np.random.default_rng(0)
    pre_s, pre_t = rng.standard_normal((2, 8, 16)), rng.standard_normal((2, 8, 16))
    path = vis.render_fusion_similarity_kde(pre_s, pre_t, pre_s, pre_s + 0.1 * pre_t, "r2t",
                                            str(tmp_path / "kde.png"))
    assert os.path.getsize(path) > 0
    ds = synthetic_dataset()
    query = [(ds.query[0][0], ds.query[0][1], ds.query[0][2], 7)]
    gallery = [(r[0], r[1], r[2], 7 if i == 0 else i) for i, r in enumerate(ds.gallery[:4])]
    paths = vis.render_ranked_list_grids(np.asarray([[0.0, 0.1, 0.2, 0.3]]), query, gallery,
                                         str(tmp_path), topk=2, num_queries=1, scene_filter=True)
    assert len(paths) == 1 and os.path.getsize(paths[0]) > 0
    pytest.importorskip("sklearn")
    tsne = vis.save_tsne_plot(rng.standard_normal((40, 8)), np.repeat(np.arange(4), 10),
                              str(tmp_path / "tsne.png"))
    assert os.path.getsize(tsne) > 0
