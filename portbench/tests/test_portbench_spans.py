"""The span arithmetic (``spans.py``) on hand-made spans and timelines, the
program's span events read back, and the fourth sub-window's helpers
(``spanwindow.py``) on the CPU."""

import pytest

from portbench import spans, spanwindow
from portbench.spans import Launch, Readings, Span
from portbench.trace import DeviceOp, HostOp, Trace


def _timeline(busy, tid=1):
    """Device operations busy over ``busy`` ([start, end) µs), the first
    CUDA call at 0 on thread ``tid``."""
    ops = [DeviceOp("k", s, e - s, "kernel") for s, e in busy]
    return Trace(ops, [], tid, {}, [HostOp("cudaLaunchKernel", 0, 1, tid)])


def _train():
    """One step (request 0) on thread 1 after its wait; its batch's put on
    thread 2. Idle gaps (µs): (2, 5) in the wait, (7, 9) in prepare, (20,
    24) in the tower under forward, (60, 66) in backward, (90, 93) in
    update, (97, 99) in the step between stages, (100, 110) under no span."""
    s = [Span("data.prefetch.wait", 0, 5, 1, 0, None, 0),
         Span("train.step", 5, 100, 1, 1, None, 0),
         Span("train.prepare", 5, 10, 1, 2, 1, 0),
         Span("train.forward", 10, 50, 1, 3, 1, 0),
         Span("model.tower", 12, 30, 1, 4, 3, 0),
         Span("model.sim", 30, 35, 1, 5, 3, 0),
         Span("model.align", 35, 40, 1, 6, 3, 0),
         Span("model.heads", 40, 45, 1, 7, 3, 0),
         Span("train.loss", 45, 48, 1, 8, 3, 0),
         Span("train.backward", 50, 80, 1, 9, 1, 0),
         Span("train.update", 80, 95, 1, 10, 1, 0),
         Span("data.prefetch.put", 0, 3, 2, 11, None, 0)]
    busy = [(0, 2), (5, 7), (9, 20), (24, 60), (66, 90), (93, 97), (99, 100), (110, 112)]
    return Readings(spans=s, timeline=_timeline(busy))


def test_train_metrics_on_a_hand_made_step():
    r = _train()
    got = {k: read(r) for k, read in spans.METRICS.items() if k.endswith(".train")}
    want = {"step_host_ms.train": 95e-3, "tower_host_ms.train": 18e-3,
            "sim_host_ms.train": 5e-3, "align_host_ms.train": 5e-3,
            "loss_host_ms.train": 8e-3, "backward_host_ms.train": 30e-3,
            "update_host_ms.train": 15e-3, "prefetch_wait_ms.train": 5e-3,
            "forward_idle_ms.train": 6e-3, "backward_idle_ms.train": 6e-3,
            "update_idle_ms.train": 3e-3}
    assert got == pytest.approx(want)
    summary = spans.summary(r, spans.TRAIN)
    assert summary["units"] == 1
    assert summary["self_ms_by_name"]["train.forward"] == pytest.approx(4e-3)
    assert summary["tree_self_ms"] == pytest.approx(summary["root_ms"]) == pytest.approx(95e-3)
    # the gaps in the wait, between stages and after the step count in no stage
    assert summary["idle_by_stage_ms"] == pytest.approx(
        {"forward": 6e-3, "backward": 6e-3, "update": 3e-3, "none": 15e-3})
    assert summary["idle_outside_spans_share"] == pytest.approx(10 / 30)
    assert all(read(r) is None for k, read in spans.METRICS.items() if k.endswith(".gallery"))


def test_gallery_metrics_on_three_hand_made_batches():
    s = [Span("data.prefetch.wait", 0, 4, 1, 0, None, 0),
         Span("eval.step", 4, 50, 1, 1, None, 0),
         Span("model.tower", 5, 30, 1, 2, 1, 0),
         Span("model.sim", 30, 45, 1, 3, 1, 0),
         Span("data.prefetch.wait", 50, 52, 1, 4, None, 1),
         Span("eval.step", 52, 90, 1, 5, None, 1),
         Span("model.tower", 53, 70, 1, 6, 5, 1),
         Span("model.sim", 70, 85, 1, 7, 5, 1),
         Span("data.prefetch.put", 0, 2, 2, 8, None, 0),
         Span("data.prefetch.put", 2, 20, 2, 9, None, 1),
         Span("data.prefetch.put", 20, 95, 2, 10, None, 2),   # never taken
         Span("data.prefetch.wait", 90, 94, 1, 11, None, 2),
         Span("eval.step", 94, 99, 1, 12, None, 2)]
    launches = [Launch(31, 1, 10), Launch(71, 1, 6), Launch(10, 1, 100),
                Launch(31, 2, 50)]                             # another thread's
    r = Readings(spans=s, timeline=_timeline([(0, 100)]), launches=launches)
    got = {k: read(r) for k, read in spans.METRICS.items() if k.endswith(".gallery")}
    assert got == pytest.approx({"step_host_ms.gallery": 89e-3 / 3, "tower_host_ms.gallery": 14e-3,
                                 "sim_host_ms.gallery": 10e-3, "sim_ms.gallery": 16e-3 / 3,
                                 # batches 0 and 1 sat 2 and 32 µs in the queue; 2,
                                 # put last, 0: the consumer was waiting
                                 "prefetch_queue_ms.gallery": 2e-3})
    assert all(read(r) is None for k, read in spans.METRICS.items() if k.endswith(".train"))
    # a CUDA-only profile may name the main thread by the profiler's own id
    named = Readings(spans=s, timeline=_timeline([(0, 100)], tid=99),
                     launches=[Launch(d.ts, {1: 99, 2: 98}[d.tid], d.dur) for d in launches])
    assert spans.METRICS["sim_ms.gallery"](named) == pytest.approx(16e-3 / 3)


def test_without_spans_or_a_timeline_nothing_is_read():
    for r in (Readings(spans=[]), Readings(spans=_train().spans)):
        got = {k: read(r) for k, read in spans.METRICS.items()}
        idle = {k for k in got if "idle" in k}
        assert all(got[k] is None for k in idle)
        if not r.spans:
            assert all(v is None for v in got.values())


def test_the_programs_span_events_and_launches_read_back():
    from signal_tpu_torch.utils.profiler import chrome_events, recording, span

    with recording() as recs:
        with span("eval.step", request=4):
            with span("model.sim"):
                pass
    base = recs[0].start_ns - 1000
    got = spans.parse_spans(chrome_events(recs, base) + [{"ph": "X", "cat": "kernel"}])
    assert [(s.name, s.id, s.parent, s.request) for s in got] == \
        [("eval.step", 0, None, 4), ("model.sim", 1, 0, 4)]
    assert got[0].ts == pytest.approx(1.0) and got[0].tid == recs[0].tid
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
               "tid": 7, "args": {"correlation": 3}},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 9, "dur": 4,
               "args": {"correlation": 3}},
              {"ph": "X", "cat": "kernel", "name": "orphan", "ts": 9, "dur": 4, "args": {}}]
    assert spans.launches(events) == [Launch(5.0, 7, 4.0)]


def test_the_fourth_sub_window_maps_spans_onto_the_trace_on_the_cpu():
    """On the CPU the profile can record the host's operators only: the
    product's operator lies inside the span that ran it."""
    import torch

    from signal_tpu_torch.utils.profiler import span

    def body():
        with span("eval.step"):
            with span("model.sim"):
                return torch.ones(8, 8) @ torch.ones(8, 8)

    out, r = spanwindow.profiled_spans(body, host_ops=True)
    assert out.shape == (8, 8) and [s.name for s in r.spans] == ["eval.step", "model.sim"]
    mm = next(h for h in r.timeline.host_ops if h.name == "aten::mm")
    sim = r.spans[1]
    assert sim.tid == mm.tid and sim.ts <= mm.ts and mm.end <= sim.end
    assert spans.METRICS["sim_host_ms.gallery"](r) > 0
    cost = spanwindow.span_ns(10, 10)
    assert cost["on_span_ns"] > 0 and cost["off_span_ns"] > 0


def test_span_cost_takes_turns():
    class FakeRun:
        def sync(self):
            pass

    from signal_tpu_torch.utils import profiler

    def steps(n, out):
        for _ in range(n):
            with profiler.span("train.step"):
                with profiler.span("train.backward"):
                    pass
        out.extend([0.002 if profiler._recorder is not None else 0.001] * n)

    cost = spanwindow.span_cost(FakeRun(), steps, rounds=1, n=2)
    assert cost["step_host_ms_off"] == pytest.approx(1.0)
    assert cost["step_host_ms_on"] == pytest.approx(2.0)
    assert cost["rise_pct"] == pytest.approx(100.0)
    assert len(cost["turns_off_ms"]) == len(cost["turns_on_ms"]) == 2
    assert cost["spans_a_step"] == 2
    assert set(cost["host_metrics_on"]) == {"step_host_ms.train", "backward_host_ms.train"}
