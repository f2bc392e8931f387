"""The port's spans (``signal_tpu_torch/utils/profiler.py``): off costs a
flag check, on they nest by thread with parents, self times and request
ids, prefetch's two ends and the step that follows share a batch's id, the
train and eval steps record the layers' tree, the spans land on a
``torch.profiler`` trace's clock, and the export does not see them
(``profiler.trace`` writing them out: ``test_torch_utils_vis.py``)."""

import dataclasses
import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from signal_tpu_torch import config as tcfg_mod
from signal_tpu_torch import serving
from signal_tpu_torch.data.prefetch import prefetch
from signal_tpu_torch.engine.eval import make_eval_step
from signal_tpu_torch.engine.train import make_train_step
from signal_tpu_torch.models import signal_model as tsm
from signal_tpu_torch.solver import make_optimizer
from signal_tpu_torch.utils import profiler
from signal_tpu_torch.utils.profiler import recording, span

from _torch_parity import TRAIN_IMG_HW, TRAIN_TINY, tiny_train_cfg


def _tree(spans):
    return [(s.name, s.parent.name if s.parent else None) for s in spans]


def test_an_off_span_records_nothing_allocates_nothing_and_returns_the_value():
    def body():
        with span("model.sim", request=3):
            return 7

    assert span("a") is span("b", request=1)      # one shared no-op context
    assert body() == 7
    tracemalloc.start()
    try:
        for _ in range(1000):
            body()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = snap.filter_traces([tracemalloc.Filter(True, profiler.__file__)])
    assert sum(s.size for s in here.statistics("filename")) == 0
    with recording() as spans:
        pass
    assert spans == [] and profiler._recorder is None


def test_spans_nest_by_thread_with_parents_self_times_and_requests():
    def other():
        with span("other.root"):
            with span("other.child"):
                time.sleep(0.001)

    with recording() as spans:
        with span("root", request=5):
            time.sleep(0.001)
            with span("a"):
                time.sleep(0.002)
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            with span("b", request=6):
                time.sleep(0.001)
        with span("next"):      # a root: the thread's current request
            pass
    assert not t.is_alive()
    by = {s.name: s for s in spans}
    assert _tree(spans[:3]) == [("root", None), ("a", "root"), ("other.root", None)]
    assert by["other.child"].parent is by["other.root"]
    assert by["other.root"].tid != by["root"].tid == threading.get_native_id()
    assert [by[n].request for n in ("root", "a", "other.root", "b", "next")] == \
        [5, 5, None, 6, 6]
    own = dict(zip((s.name for s in spans), profiler.self_ns(spans)))
    dur = {n: s.end_ns - s.start_ns for n, s in by.items()}
    assert own["root"] == dur["root"] - dur["a"] - dur["b"] > 0
    assert own["other.root"] == dur["other.root"] - dur["other.child"]
    assert own["a"] == dur["a"] >= 2_000_000
    # a span still open reads None
    with recording() as spans:
        outer = span("open")
        outer.__enter__()
        with span("inner"):
            pass
        assert profiler.self_ns(spans)[0] is None
        outer.__exit__(None, None, None)
    with pytest.raises(RuntimeError, match="already"):
        with recording(), recording():
            pass


def test_prefetch_numbers_each_batch_from_its_put_to_the_step_that_takes_it():
    with recording() as spans:
        for i, x in enumerate(prefetch(range(4), lambda v: v * 10, depth=2)):
            with span("train.step"):
                assert x == 10 * i
    puts = {s.request: s for s in spans if s.name == "data.prefetch.put"}
    waits = {s.request: s for s in spans if s.name == "data.prefetch.wait"}
    steps = [s for s in spans if s.name == "train.step"]
    assert sorted(puts) == [0, 1, 2, 3] and [s.request for s in steps] == [0, 1, 2, 3]
    assert sorted(waits) == [0, 1, 2, 3, 4]         # the last wait takes the end
    for k in range(4):
        assert puts[k].tid != waits[k].tid == steps[k].tid
        assert puts[k].end_ns <= waits[k].end_ns <= steps[k].start_ns


def _toy_model_and_cfg(*opts):
    cfg = tiny_train_cfg(tcfg_mod, None, *opts)
    shrink = {k: TRAIN_TINY[k] for k in ("width", "layers", "num_heads", "feat_dim", "h", "w",
                                         "topk")}
    spec = dataclasses.replace(tsm.ModelSpec.from_config(cfg, 5, 3), **shrink,
                               compute_dtype="float32", use_flash=False)
    return tsm.init_signal(spec, seed=0), cfg


FORWARD = [("train.forward", "train.step"), ("model.tower", "train.forward"),
           ("model.sim", "train.forward"), ("model.align", "train.forward"),
           ("model.heads", "train.forward"), ("train.loss", "train.forward"),
           ("train.backward", "train.step")]


@pytest.mark.parametrize("accum", [1, 2])
def test_train_and_eval_steps_record_the_layers_tree(accum):
    model, cfg = _toy_model_and_cfg("SOLVER.ACCUM_ITER", str(accum))
    model.train()
    step = make_train_step(model, cfg, 5, make_optimizer(model, cfg))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (8, 3, 3, 64, 64)).astype(np.uint8))
    pids = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3])
    cams = torch.from_numpy(rng.integers(0, 3, 8))
    with recording() as spans:
        loss, _ = step(imgs, pids, cams)
    assert torch.isfinite(loss)
    want = [("train.step", None)] + \
        ([("train.prepare", "train.step")] + FORWARD) * accum + [("train.update", "train.step")]
    assert _tree(spans) == want
    assert all(s.end_ns is not None and s.request is None for s in spans)
    assert profiler.self_ns(spans)[0] >= 0

    eval_step = make_eval_step((cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD))
    model.eval()
    with recording() as spans:
        with span("data.prefetch.wait", request=9):
            pass
        feats = eval_step(model, imgs, cams)
    assert feats.shape == (8, 6 * model.spec.feat_dim)
    assert _tree(spans) == [("data.prefetch.wait", None), ("eval.step", None),
                            ("model.tower", "eval.step"), ("model.sim", "eval.step")]
    assert [s.request for s in spans] == [9, 9, 9, 9]


def test_spans_land_on_the_profilers_clock(tmp_path):
    """A span around a ``record_function`` block, mapped with the trace's
    ``baseTimeNanoseconds``, contains the block's exported event."""
    path = str(tmp_path / "t.json")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            recording() as spans:
        with span("outer"):
            with torch.profiler.record_function("inner_block"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    block = next(e for e in doc["traceEvents"] if e.get("name") == "inner_block")
    (outer,) = profiler.chrome_events(spans, doc["baseTimeNanoseconds"])
    assert outer["tid"] == block["tid"] and outer["cat"] == "program_span"
    assert outer["ts"] <= block["ts"]
    assert block["ts"] + block["dur"] <= outer["ts"] + outer["dur"]


def test_export_with_spans_on_traces_and_runs_as_before():
    model, _ = _toy_model_and_cfg()
    ops = lambda ep: [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]  # noqa
    off = serving.export_eval(model, model.spec, image_size=TRAIN_IMG_HW, batch=2, device="cpu")
    with recording() as spans:
        on = serving.export_eval(model, model.spec, image_size=TRAIN_IMG_HW, batch=2, device="cpu")
    assert {"model.tower", "model.sim"} <= {s.name for s in spans}
    assert ops(on) == ops(off)
    rng = np.random.default_rng(1)
    imgs = {m: torch.from_numpy(rng.standard_normal((2, 3, *TRAIN_IMG_HW)).astype(np.float32))
            for m in serving.MODALITIES}
    cams = torch.tensor([0, 2])
    with recording():
        got = on.module()(imgs, cams)
    torch.testing.assert_close(got, off.module()(imgs, cams), atol=0, rtol=0)
