"""Port parity: config, device normalize, distances, retrieval metrics, the
eval engine and the test CLI (`signal_tpu_torch` against `signal_tpu`)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signal_tpu import config as jcfg_mod
from signal_tpu import metrics as jmetrics
from signal_tpu.data.augment import normalize_images as jax_normalize
from signal_tpu.ops.distmat import euclidean_sqdist as jax_sqdist
from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch import metrics as tmetrics
from signal_tpu_torch.data.augment import normalize_images
from signal_tpu_torch.ops.distmat import euclidean_sqdist

from _torch_parity import TINY, tiny_pair, to_np

CONFIGS = ["configs/RGBNT201/Signal.yml", "configs/RGBNT100/Signal.yml",
           "configs/MSVR310/Signal.yml", "configs/synthetic/smoke.yml"]


@pytest.mark.parametrize("path", CONFIGS)
def test_configs_load_to_equal_values_in_both_packages(path):
    ours = dataclasses.asdict(tcfg_mod.load_config(path, ["TEST.MISS", "rn"]))
    theirs = dataclasses.asdict(jcfg_mod.load_config(path, ["TEST.MISS", "rn"]))
    # the one intended difference: the port's device default
    assert ours["MODEL"].pop("DEVICE") == "cuda"
    assert theirs["MODEL"].pop("DEVICE") == "tpu"
    assert ours == theirs


def test_normalize_images_matches_jax():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 3, 3, 8, 4)).astype(np.uint8)
    mean, std = (0.48, 0.45, 0.40), (0.26, 0.26, 0.27)
    np.testing.assert_allclose(to_np(normalize_images(torch.from_numpy(u8), mean, std)),
                               to_np(jax_normalize(jnp.asarray(u8), mean, std)),
                               atol=1e-6, rtol=1e-6)
    d = {"RGB": u8[:, 0], "NI": u8[:, 1]}
    ours = normalize_images({k: torch.from_numpy(v) for k, v in d.items()}, mean, std)
    theirs = jax_normalize({k: jnp.asarray(v) for k, v in d.items()}, mean, std)
    for k in d:
        np.testing.assert_allclose(to_np(ours[k]), to_np(theirs[k]), atol=1e-6, rtol=1e-6)
    f = torch.zeros(1, 3, 3, 2, 2)
    assert normalize_images(f, mean, std) is f  # float input passes through


def test_euclidean_sqdist_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 48)).astype(np.float32)
    y = rng.standard_normal((11, 48)).astype(np.float32)
    # true fp32 on both sides: summation order only
    np.testing.assert_allclose(to_np(euclidean_sqdist(torch.from_numpy(x), torch.from_numpy(y))),
                               to_np(jax_sqdist(jnp.asarray(x), jnp.asarray(y))),
                               atol=1e-4, rtol=1e-5)


def _protocol_inputs(seed, tied):
    rng = np.random.default_rng(seed)
    nq, ng = 12, 40
    dist = (rng.integers(0, 5, (nq, ng)) if tied else rng.random((nq, ng))).astype(np.float32)
    q_pids, g_pids = rng.integers(0, 6, nq), rng.integers(0, 6, ng)
    q_cams, g_cams = rng.integers(0, 3, nq), rng.integers(0, 3, ng)
    return dist, q_pids, g_pids, q_cams, g_cams


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied-distances"])
def test_eval_func_matches_jax(tied):
    args = _protocol_inputs(2, tied)
    cmc_t, map_t = tmetrics.eval_func(*args, max_rank=10)
    cmc_j, map_j = jmetrics.eval_func(*args, max_rank=10)
    # same stable ranking; fp32 sums in another order
    np.testing.assert_allclose(cmc_t, cmc_j, atol=1e-6)
    assert map_t == pytest.approx(map_j, abs=1e-6)


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied-distances"])
def test_eval_func_msvr_matches_jax(tied):
    dist, q_pids, g_pids, q_cams, g_cams = _protocol_inputs(3, tied)
    rng = np.random.default_rng(4)
    q_sc, g_sc = rng.integers(0, 4, len(q_pids)), rng.integers(0, 4, len(g_pids))
    args = (dist, q_pids, g_pids, q_cams, g_cams, q_sc, g_sc)
    cmc_t, map_t = tmetrics.eval_func_msvr(*args, max_rank=10)
    cmc_j, map_j = jmetrics.eval_func_msvr(*args, max_rank=10)
    np.testing.assert_allclose(cmc_t, cmc_j, atol=1e-6)
    assert map_t == pytest.approx(map_j, abs=1e-6)


@pytest.mark.parametrize("scene_aware", [False, True], ids=["market", "msvr"])
def test_r1map_evaluator_matches_jax(scene_aware, tmp_path):
    rng = np.random.default_rng(5)
    n_q, n = 6, 30
    feats = rng.standard_normal((n, 32)).astype(np.float32)
    pids, cams, scenes = rng.integers(0, 4, n), rng.integers(0, 3, n), rng.integers(0, 3, n)
    outs = []
    for mod, to in ((tmetrics, torch.from_numpy), (jmetrics, jnp.asarray)):
        path = tmp_path / f"{mod.__name__}.txt"
        ev = mod.R1mAPEvaluator(n_q, max_rank=10, scene_aware=scene_aware,
                                rank_dump_path=str(path) if scene_aware else None)
        for lo in range(0, n, 8):  # fed batch by batch, as the engine does
            sl = slice(lo, lo + 8)
            ev.update(to(feats[sl]), pids[sl], cams[sl],
                      sceneid=scenes[sl] if scene_aware else None)
        cmc, mAP, distmat, *_ = ev.compute()
        outs.append((cmc, mAP, to_np(distmat), path.read_text() if scene_aware else ""))
    (cmc_t, map_t, d_t, dump_t), (cmc_j, map_j, d_j, dump_j) = outs
    np.testing.assert_allclose(d_t, d_j, atol=1e-5)
    np.testing.assert_allclose(cmc_t, cmc_j, atol=1e-6)
    assert map_t == pytest.approx(map_j, abs=1e-6)
    assert dump_t == dump_j


def test_reranking_raises_until_ported():
    """Ported now: the evaluator takes reranking=True and ranks by the
    re-ranked distances (tests/test_torch_reranking.py holds them to
    JAX's)."""
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((12, 8)).astype(np.float32)
    ev = tmetrics.R1mAPEvaluator(4, max_rank=5, reranking=True)
    ev.update(torch.from_numpy(feats), np.arange(12) % 4, np.repeat([0, 1, 2], 4))
    cmc, mAP, distmat, *_ = ev.compute()
    assert distmat.shape == (4, 8) and 0.0 <= mAP <= 1.0 and len(cmc) == 5


def _tiny_cfg(mod, tmp_path):
    return mod.load_config("configs/synthetic/smoke.yml", [
        "INPUT.SIZE_TEST", "[64, 32]", "INPUT.SIZE_TRAIN", "[64, 32]",
        "TEST.IMS_PER_BATCH", "8", "DATALOADER.NUM_WORKERS", "1",
        "MODEL.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", str(tmp_path)])


def test_do_inference_matches_jax_on_synthetic(tmp_path):
    """The slice as a whole: the same weights and the same synthetic val
    split through both engines give the same features, mAP and CMC."""
    from signal_tpu.data import make_dataloader as jax_loader
    from signal_tpu.engine.eval import do_inference as jax_inference
    from signal_tpu_torch.data import make_dataloader
    from signal_tpu_torch.engine.eval import do_inference

    jspec, params, bn, model = tiny_pair("float32", camera_num=4)
    jcfg, tcfg = _tiny_cfg(jcfg_mod, tmp_path), _tiny_cfg(tcfg_mod, tmp_path)
    _, _, jval, jnq, *_ = jax_loader(jcfg)
    _, _, tval, tnq, *_ = make_dataloader(tcfg)
    assert jnq == tnq == 8
    cmc_j, map_j = jax_inference(jcfg, jspec, params, bn, jval, jnq)
    cmc_t, map_t = do_inference(tcfg, model, tval, tnq, device=torch.device("cpu"))
    np.testing.assert_allclose(cmc_t, cmc_j, atol=1e-6)
    assert map_t == pytest.approx(map_j, abs=1e-6)


def test_test_main_runs_on_cpu(tmp_path):
    from signal_tpu_torch.cli import test_main

    cmc, mAP = test_main([
        "--config_file", "configs/synthetic/smoke.yml",
        "--shrink", ",".join(f"{k}={v}" for k, v in TINY.items()
                             if k not in ("num_classes", "camera_num")),
        "MODEL.DEVICE", "cpu", "INPUT.SIZE_TEST", "[64, 32]", "INPUT.SIZE_TRAIN", "[64, 32]",
        "TEST.IMS_PER_BATCH", "8", "DATALOADER.NUM_WORKERS", "1", "OUTPUT_DIR", str(tmp_path)])
    assert np.isfinite(mAP) and 0.0 < mAP <= 1.0
    assert cmc.shape == (50,) and np.all(np.diff(cmc) >= 0)
    assert (tmp_path / "synthetic_test" / "test_log.txt").read_text().count("mAP:") == 1


def test_cuda_device_without_a_card_raises():
    """Asking for the card where there is none never falls back to the CPU."""
    from signal_tpu_torch.cli import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_prefetch_yields_in_order_and_reraises():
    """The port's prefetch yields ``put``'s results in order, ``depth``
    ahead in its thread, and re-raises the worker's error at the
    consumer."""
    from signal_tpu_torch.data.prefetch import prefetch

    host = np.arange(12, dtype=np.uint8).reshape(3, 4)
    out = list(prefetch(range(5), lambda i: torch.from_numpy(host + i), depth=2))
    assert [int(t[0, 0]) for t in out] == [0, 1, 2, 3, 4]

    def bad(x):
        if x == 3:
            raise ValueError("boom")
        return x

    with pytest.raises(ValueError, match="boom"):
        list(prefetch(range(6), bad))
