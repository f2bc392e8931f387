"""The closed-loop gallery stream: the pool's packed uint8 batches of
TEST.IMS_PER_BATCH through the port's ``engine/eval.extract_features``
(its prefetch, depth 2, and non-blocking copy, then ``make_eval_step``'s
normalise and ``forward_eval``) into an ``R1mAPEvaluator``, as
``do_inference`` feeds it, up to the ranking, which is not in the window.

A batch's latency runs from the host time its host→device copy is issued
to the host time its features are complete on the device (an event
recorded as the evaluator takes them, waited for by a thread of its
own). The window issues batches for ``--seconds``, then issues nothing
more and waits for all it issued: the rate is every issued batch over
the time from the window's start to the end of that wait, and the tail
is taken over every issued batch. The plain reference recomputes a sample of the window's batches,
drawn from the seed, once the window has closed and the port is freed.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import correct, harness, readers, spec, yardstick
from portbench.harness import Completion, Pool, Run
from portbench.inputs import make_pool, make_weights
from portbench.reference.recipe import gallery_features


def run(run: Run) -> dict:
    import signal_tpu_torch.engine.eval as engine_eval
    from signal_tpu_torch.metrics import R1mAPEvaluator

    cell, dev, traffic = run.cell, run.device, run.cell.traffic
    arch = spec.reference_arch(cell.config, train=False)
    hp = spec.recipe(cell.config)
    B = hp["batch_test"]
    pool = Pool(make_pool(arch, B, traffic["pool_batches"], run.seed, dev))
    cfg, model = harness.build_port(run, make_weights(arch, run.seed, dev))
    normalize = (cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)

    class Evaluator(R1mAPEvaluator):
        """The port's evaluator, noting when each batch's features are
        complete."""

        def __init__(self, completion=None):
            super().__init__(num_query=B, feat_norm=cfg.TEST.FEAT_NORM == "yes")
            self.completion = completion

        def update(self, feat, *args, **kw):
            if self.completion is not None:
                self.completion.mark()
            super().update(feat, *args, **kw)

    def extract(batches, evaluator):
        engine_eval.extract_features(model, batches, evaluator, device=dev, normalize=normalize)

    extract(pool.take(traffic["warmup_batches"]), Evaluator())
    run.sync()
    setup_peak = harness.peak_bytes(run)
    setup_s = time.perf_counter() - run.t_start

    start = pool.cursor
    ctx = values = None
    if not run.trace:
        issued, completion = [], Completion(run.cuda)
        ev = Evaluator(completion)
        t0 = time.perf_counter()
        until = t0 + run.seconds
        extract(pool.take(until=until, issued=issued), ev)
        done = completion.close()
        run.sync()
        elapsed = time.perf_counter() - t0
        latency = [t - issued[k] for k, t in enumerate(done)]
        values = {"gallery_samples_per_s": len(done) * B / elapsed,
                  "gallery_batch_ms_p95": 1e3 * harness.nearest_rank(
                      latency, traffic["latency_percentile"]) if latency else float("nan"),
                  "setup_s": setup_s}
        attempted, failed = len(issued), len(issued) - len(done)
    else:
        ev, ctx = traced_window(run, pool, engine_eval, extract, Evaluator, arch, B)
        attempted, failed = len(ev.feats), 0
    device = harness.device_info(run, max(setup_peak, harness.peak_bytes(run)))

    # a sample of the batches the window issued (each has completed: one
    # that came late is late, not wrong), drawn from the seed
    pick = random.Random(spec.subseed(run.seed, "check"))
    by_pool = {}
    for k in range(len(ev.feats)):
        by_pool.setdefault((start + k) % len(pool.batches), k)
    chosen = sorted(pick.sample(sorted(by_pool), min(traffic["checked_batches"], len(by_pool))))
    prog = {i: ev.feats[by_pool[i]].clone() for i in chosen}
    del ev, model
    harness.free_device()
    weights = make_weights(arch, run.seed, dev)
    gaps = []
    for i in chosen:
        b = pool.batches[i]
        ref = gallery_features(weights, arch, hp, torch.from_numpy(b["packed"]).to(dev),
                               torch.from_numpy(b["camids"]).to(dev))
        gaps.append(correct.feature_gap(prog[i], ref))
    numbers = {"feature_gap": max(gaps) if gaps else float("inf")}
    ok, checks = correct.verdict(numbers, spec.limits(cell.config, "gallery"))
    return harness.result(run, ok=ok, attempted=attempted, failed=failed, device=device,
                          checks=checks, values=values, ctx=ctx)


def traced_window(run: Run, pool: Pool, engine_eval, extract, Evaluator, arch: dict, B: int):
    """The ``--trace 1`` window: half of ``--seconds`` on the host clock
    (MFU; each eval step call's enqueue time, timed around the port's
    ``make_eval_step`` step), a few batches profiled with CUDA activity
    alone (the timeline), then a few with the host's operators too."""
    bw, flops = yardstick.peaks(torch.cuda.get_device_name(run.device))
    ctx = readers.Readings(bw=bw, flops=flops,
                           unit_flops=yardstick.signal_flops(arch, B, train=False))
    make_eval_step = engine_eval.make_eval_step

    def timed(normalize):
        inner = make_eval_step(normalize)

        def eval_step(model, imgs, camids):
            t = time.perf_counter()
            out = inner(model, imgs, camids)
            ctx.enqueue_s.append(time.perf_counter() - t)
            return out

        return eval_step

    ev = Evaluator()
    engine_eval.make_eval_step = timed
    try:
        t0 = time.perf_counter()
        extract(pool.take(until=t0 + run.seconds / 2), ev)
        run.sync()
        ctx.host_seconds = time.perf_counter() - t0
    finally:
        engine_eval.make_eval_step = make_eval_step
    ctx.host_units = len(ev.feats)

    from portbench.trace import Profiled

    n = run.cell.traffic["trace"]["profiled_batches"]
    with Profiled(host_ops=False) as prof:
        extract(pool.take(n), Evaluator())
        run.sync()
    ctx.timeline = prof.trace
    with Profiled(host_ops=True) as prof:
        with torch.profiler.record_function(readers.WINDOW_MARK):
            extract(pool.take(n), Evaluator())
            run.sync()
    ctx.trace, ctx.traced_units = prof.trace, n
    return ev, ctx
