#!/usr/bin/env python3
"""A cell's traced run with the program's spans read: ``run.py --trace 1``
and a fourth sub-window after its three.

    python3 portbench/spanwindow.py --workload rgbnt201-train --seed 7 --seconds 30

The fourth sub-window runs the traffic's ``profiled_steps`` (train) or
``profiled_batches`` (gallery) again with the port's spans on
(``utils/profiler.recording``), profiled with CUDA activity alone, and
reads ``spans.METRICS`` from the spans on that timeline. A train cell also
times the spans' cost, before the traced window's first profile and
after the fourth: rounds of steps with spans off and on in turns (off,
on, on, off, twice), each step call's host time, and the host metrics
read from the on turns' spans, with no profiler on; and every cell the
cost of one span, off and on, on this host.

Prints ``run.py``'s result line with the span metrics added to
``metrics``, a ``spans`` key (``spans.summary`` and the costs) and
``checks`` last. The kinds' modules are not edited: this process wraps
their ``traced_window``.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def span_ns(n: int = 100, rounds: int = 2000) -> dict:
    """ns of a loop turn of ``with span(...): pass`` with spans off, of one
    with spans on (two clock reads, a record; a recording of ``n`` spans at
    a time, as a step holds a dozen), and of an empty loop turn, each over
    ``n`` × ``rounds`` turns."""
    from signal_tpu_torch.utils.profiler import recording, span

    def turns():
        t = time.perf_counter_ns()
        for _ in range(n):
            with span("model.sim"):
                pass
        return time.perf_counter_ns() - t

    off = sum(turns() for _ in range(rounds))
    on = 0
    for _ in range(rounds):
        with recording():
            on += turns()
    t = time.perf_counter_ns()
    for _ in range(n * rounds):
        pass
    empty = time.perf_counter_ns() - t
    return {"off_span_ns": off / n / rounds, "on_span_ns": on / n / rounds,
            "empty_turn_ns": empty / n / rounds}


def span_cost(run, steps, rounds: int = 2, n: int = 8) -> dict:
    """Mean host ms of a train step call with spans off and on, in turns
    (off, on, on, off) ``rounds`` times, ``n`` steps a turn, the device
    drained between turns; the spans a step; and the host metrics of
    ``spans.METRICS`` read from the on turns' spans (no profiler on).
    ``steps(n, out)`` steps ``n`` times, appending each call's host seconds
    to ``out``."""
    from portbench import spans
    from signal_tpu_torch.utils.profiler import chrome_events, recording

    times = {False: [], True: []}
    host = []
    for on in [False, True, True, False] * rounds:
        out = []
        with recording() if on else contextlib.nullcontext() as recs:
            steps(n, out)
        run.sync()
        times[on].append(1e3 * statistics.fmean(out))
        if on:
            host.append(spans.Readings(spans=spans.parse_spans(chrome_events(recs, 0))))
    off, on = statistics.fmean(times[False]), statistics.fmean(times[True])
    read = {k: [f(r) for r in host] for k, f in spans.METRICS.items()
            if k.endswith(".train") and "idle" not in k}
    return {"step_host_ms_off": off, "step_host_ms_on": on, "rise_pct": 100 * (on / off - 1),
            "turns_off_ms": times[False], "turns_on_ms": times[True],
            "spans_a_step": len(host[0].spans) / n,
            "host_metrics_on": {k: statistics.fmean(v) for k, v in read.items()
                                if None not in v}}


class SpanTimeline:
    """``trace.Profiled`` that keeps, besides the parsed trace, its
    ``baseTimeNanoseconds`` and each device operation's launch."""

    def __init__(self, host_ops: bool):
        from portbench import trace

        self.profiled = trace.Profiled(host_ops)

    def __enter__(self):
        self.profiled.__enter__()
        return self

    def __exit__(self, *exc):
        from portbench import spans, trace

        self.profiled.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.profiled.prof.export_chrome_trace(path)
            self.trace = trace.parse(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        self.base_ns = int(doc["baseTimeNanoseconds"])
        self.launches = spans.launches(doc["traceEvents"])
        return False


def profiled_spans(body, host_ops: bool = False):
    """Run ``body()`` with spans on, profiled with CUDA activity alone
    (``host_ops``: the host's operators too; all a CPU build records) →
    (body's result, ``spans.Readings``)."""
    from portbench import spans
    from signal_tpu_torch.utils.profiler import chrome_events, recording

    with SpanTimeline(host_ops) as prof:
        with recording() as recs:
            out = body()
    return out, spans.Readings(spans=spans.parse_spans(chrome_events(recs, prof.base_ns)),
                               timeline=prof.trace, launches=prof.launches)


def wrap(kind, train: bool, found: dict):
    """The kind's module ``kind`` with the fourth sub-window after
    its ``traced_window``; ``train``: a train kind's."""
    orig = kind.traced_window

    if train:
        def traced_window(run, pool, drive, step, put, prefetch, depth, arch, B):
            def steps(k, out):
                drive(pool.take(k), enqueue=out)

            found["cost_before_profiling"] = span_cost(run, steps)
            losses, ctx = orig(run, pool, drive, step, put, prefetch, depth, arch, B)
            n = run.cell.traffic["trace"]["profiled_steps"]

            def body():
                out = drive(pool.take(n))
                run.sync()
                return out

            timed, found["readings"] = profiled_spans(body)
            found["cost_after_profiling"] = span_cost(run, steps)
            return losses + timed, ctx
    else:
        def traced_window(run, pool, engine_eval, extract, Evaluator, arch, B):
            ev, ctx = orig(run, pool, engine_eval, extract, Evaluator, arch, B)
            n = run.cell.traffic["trace"]["profiled_batches"]
            _, found["readings"] = profiled_spans(
                lambda: (extract(pool.take(n), Evaluator()), run.sync()))
            return ev, ctx

    kind.traced_window = traced_window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import importlib

    import torch

    from portbench import harness, spans, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print(f"portbench: {args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    found = {}
    train = cell.kind == "train"
    wrap(importlib.import_module(f"portbench.kinds.{cell.kind}"), train, found)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=True,
                      device=torch.device("cuda", 0), t_start=T_START)
    res = harness.drive(run)
    r = found["readings"]
    suffix = ".train" if train else ".gallery"
    for name, read in spans.METRICS.items():
        value = read(r) if name.endswith(suffix) else None
        if value is not None:
            res["metrics"][name] = {"value": value, "unit": "ms"}
    root = spans.TRAIN if train else spans.GALLERY
    checks = res.pop("checks")
    res["spans"] = {**spans.summary(r, root), **span_ns(),
                    **{k: v for k, v in found.items() if k.startswith("cost")}}
    res["checks"] = checks
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port runs without JAX", file=sys.stderr)
        return 3
    harness.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
