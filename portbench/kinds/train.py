"""The closed-loop train mix: the pool's packed uint8 batches with their
P×K labels, through the port's ``data/prefetch.prefetch`` and a
non-blocking copy into its ``engine/train.make_train_step`` step (device
augment on, Adam at each group's post-warm-up learning rate), as
``cli.train_main`` feeds it.

Set-up builds the one train step the window drives, steps it from the
seed through the checked steps (each on another batch) and a few more,
then the window steps it until ``--seconds`` have passed on the host
clock and synchronises. The plain reference follows the checked steps
once the window has closed and the port's state is freed.
"""

from __future__ import annotations

import time

import torch

from portbench import correct, harness, readers, spec, yardstick
from portbench.harness import Pool, Run
from portbench.inputs import make_pool, make_weights
from portbench.reference.recipe import BETAS, leaf_norms, train_steps


def run(run: Run) -> dict:
    from signal_tpu_torch.data.prefetch import prefetch
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.solver import make_optimizer, set_lr

    cell, dev, traffic = run.cell, run.device, run.cell.traffic
    arch = spec.reference_arch(cell.config, train=True)
    hp = spec.recipe(cell.config)
    B = hp["batch_train"]
    pool = Pool(make_pool(arch, B, traffic["pool_batches"], run.seed, dev,
                          num_instance=hp["num_instance"]))
    weights = make_weights(arch, run.seed, dev)
    cfg, model = harness.build_port(run, weights)
    optimizer = make_optimizer(model, cfg)
    set_lr(optimizer, 0.0, 1.0)          # each group at its base lr: the post-warm-up value
    aug_seed = spec.subseed(run.seed, "augment")
    gen = torch.Generator(device=dev).manual_seed(aug_seed)
    step = make_train_step(model, cfg, arch["num_classes"], optimizer, device_augment=True,
                           gen=gen)
    depth = traffic["prefetch_depth"]

    def put(batch):
        imgs = torch.from_numpy(batch["packed"]).to(dev, non_blocking=True)
        pids = torch.from_numpy(batch["pids"]).to(dev, non_blocking=True)
        camids = torch.from_numpy(batch["camids"]).to(dev, non_blocking=True)
        return imgs, pids, camids

    def drive(batches, after_step=None, enqueue=None):
        losses = []
        for imgs, pids, camids in prefetch(batches, put, depth):
            t = time.perf_counter()
            loss, _ = step(imgs, pids, camids)
            if enqueue is not None:
                enqueue.append(time.perf_counter() - t)
            losses.append(loss)
            if after_step is not None:
                after_step(len(losses))
        return losses

    # the checked steps: the first from the seed, through the window's own call
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    prog = {}

    def after_step(i):
        if i == 1:   # Adam's first moment after one step is (1 − β1)·g
            by_param = {id(p): n for n, p in trained.items()}
            prog["grad"] = leaf_norms({by_param[id(p)]: s["exp_avg"] / (1 - BETAS[0])
                                       for p, s in optimizer.state.items()})

    checked = traffic["checked_steps"]
    prog["losses"] = [float(x) for x in drive(pool.take(checked), after_step)]
    with torch.no_grad():
        prog["change"] = leaf_norms({n: p - weights[n] for n, p in trained.items()})
    del weights
    drive(pool.take(traffic["warmup_steps"]))
    run.sync()
    setup_peak = harness.peak_bytes(run)
    setup_s = time.perf_counter() - run.t_start
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    ctx = values = None
    if not run.trace:
        t0 = time.perf_counter()
        losses = drive(pool.take(until=t0 + run.seconds))
        run.sync()
        elapsed = time.perf_counter() - t0
        window_peak = harness.peak_bytes(run)
        values = {"train_samples_per_s": len(losses) * B / elapsed,
                  "train_peak_gib": window_peak / 2 ** 30, "setup_s": setup_s}
    else:
        losses, ctx = traced_window(run, pool, drive, step, put, prefetch, depth, arch, B)
        window_peak = harness.peak_bytes(run)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    attempted = len(losses)
    device = harness.device_info(run, max(setup_peak, window_peak))
    del step, optimizer, model, gen, trained, losses
    harness.free_device()

    # the reference, on the checked steps' batches, from the same seed
    batches = [tuple(torch.from_numpy(b[k]).to(dev) for k in ("packed", "pids", "camids"))
               for b in pool.batches[:checked]]
    ref = train_steps(make_weights(arch, run.seed, dev), arch, hp, batches, aug_seed)
    numbers = correct.train_numbers(prog, ref)
    ok, checks = correct.verdict(numbers, spec.limits(cell.config, "train"))
    return harness.result(run, ok=ok, attempted=attempted, failed=failed, device=device,
                          checks=checks, values=values, ctx=ctx)


def traced_window(run: Run, pool: Pool, drive, step, put, prefetch, depth: int, arch: dict,
                  B: int):
    """The ``--trace 1`` window: half of ``--seconds`` on the host clock
    (MFU, each step call's enqueue time), a few steps with CUDA events
    between the step's own stages, a few steps profiled with CUDA activity
    alone (the timeline), then a few with the host's operators too."""
    cfg_t = run.cell.traffic["trace"]
    bw, flops = yardstick.peaks(torch.cuda.get_device_name(run.device))
    ctx = readers.Readings(unit_flops=yardstick.signal_flops(arch, B, train=True),
                           bw=bw, flops=flops)
    t0 = time.perf_counter()
    losses = drive(pool.take(until=t0 + run.seconds / 2), enqueue=ctx.enqueue_s)
    run.sync()
    ctx.host_seconds, ctx.host_units = time.perf_counter() - t0, len(losses)

    prepare, forward, backward, update = step.stages
    marks = []
    for imgs, pids, camids in prefetch(pool.take(cfg_t["stage_steps"]), put, depth):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        x = prepare(imgs)
        ev[0].record()
        out, loss = forward(x, pids, camids)
        ev[1].record()
        backward(loss)
        ev[2].record()
        update(out, loss, pids)
        ev[3].record()
        marks.append(ev)
        losses.append(loss.detach())
    run.sync()
    n = len(marks)
    for name, a, b in (("forward_loss", 0, 1), ("backward", 1, 2), ("optimizer", 2, 3)):
        ctx.stage_ms[name] = sum(ev[a].elapsed_time(ev[b]) for ev in marks) / n

    from portbench.trace import Profiled

    with Profiled(host_ops=False) as prof:
        timed = drive(pool.take(cfg_t["profiled_steps"]))
        run.sync()
    ctx.timeline = prof.trace
    with Profiled(host_ops=True) as prof:
        with torch.profiler.record_function(readers.WINDOW_MARK):
            traced = drive(pool.take(cfg_t["profiled_steps"]))
            run.sync()
    ctx.trace, ctx.traced_units = prof.trace, len(traced)
    return losses + timed + traced, ctx
