#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size, many seeds in one process:

* the port: a short run of the cell (its set-up, checked steps or
  batches, a window of ``--seconds``, the comparison) on each seed;
* the control: the plain reference in float8 (E4M3 products, E5M2
  gradients) put in the port's place, against the float32 reference, on
  the same seed's weights and batches;
* planted faults (train cells): a step that leaves the state unchanged
  reads 1 by construction; half of each batch left out, the mean taken
  over the rest, is run through the port.

    python3 portbench/calibrate.py --workload rgbnt201-train --seeds 12 --control 3 --faults 3

Prints one JSON line a reading and a summary last (the largest of the
port's, the smallest of the control's and of the faults', per number).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(run) -> dict:
    """The control's numbers: the float8 reference against the float32
    one on the run's weights and its checked batches."""
    import torch

    from portbench import correct, spec
    from portbench.inputs import make_pool, make_weights
    from portbench.reference.recipe import gallery_features, train_steps

    cell, dev = run.cell, run.device
    hp = spec.recipe(cell.config)
    if cell.kind == "train":
        arch = spec.reference_arch(cell.config, train=True)
        pool = make_pool(arch, hp["batch_train"], cell.traffic["checked_steps"], run.seed, dev,
                         num_instance=hp["num_instance"])
        batches = [tuple(torch.from_numpy(b[k]).to(dev) for k in ("packed", "pids", "camids"))
                   for b in pool]
        weights = make_weights(arch, run.seed, dev)
        aug = spec.subseed(run.seed, "augment")
        ref = train_steps(weights, arch, hp, batches, aug)
        low = train_steps(weights, arch, hp, batches, aug, precision="fp8")
        return correct.train_numbers(low, ref)
    arch = spec.reference_arch(cell.config, train=False)
    pool = make_pool(arch, hp["batch_test"], cell.traffic["checked_batches"], run.seed, dev)
    weights = make_weights(arch, run.seed, dev)
    gaps = []
    for b in pool:
        imgs, cams = (torch.from_numpy(b[k]).to(dev) for k in ("packed", "camids"))
        ref = gallery_features(weights, arch, hp, imgs, cams)
        low = gallery_features(weights, arch, hp, imgs, cams, precision="fp8")
        gaps.append(correct.feature_gap(low, ref))
    return {"feature_gap": max(gaps)}


def half_batch_step():
    """Plant the fault: the port's train step on the first half of each
    batch (the loss its mean over those rows)."""
    import signal_tpu_torch.engine.train as engine_train

    make = engine_train.make_train_step

    def broken(*args, **kw):
        step = make(*args, **kw)

        def half(imgs, pids, camids):
            n = imgs.shape[0] // 2
            return step(imgs[:n], pids[:n], camids[:n])

        half.stages = step.stages
        return half

    engine_train.make_train_step = broken
    return lambda: setattr(engine_train, "make_train_step", make)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12, help="seeds of the port's runs")
    ap.add_argument("--control", type=int, default=3, help="seeds of the control")
    ap.add_argument("--faults", type=int, default=0, help="seeds of each planted fault")
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    readings = {"port": [], "control": [], "half_batch": []}

    def one(what, seed, numbers):
        line = {"what": what, "workload": args.workload, "seed": seed, **numbers}
        readings[what].append(numbers)
        print(json.dumps(line), flush=True)

    def new_run(seed):
        return harness.Run(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                           device=torch.device("cuda", 0), t_start=time.perf_counter())

    for i in range(args.seeds):
        seed = args.first_seed + i
        res = harness.drive(new_run(seed))
        one("port", seed, {k: c["value"] for k, c in res["checks"].items()})
        harness.free_device()
    for i in range(args.control):
        seed = args.first_seed + i
        one("control", seed, control_numbers(new_run(seed)))
        harness.free_device()
    if cell.kind == "train":
        for i in range(args.faults):
            seed = args.first_seed + i
            restore = half_batch_step()
            try:
                res = harness.drive(new_run(seed))
            finally:
                restore()
            one("half_batch", seed, {k: c["value"] for k, c in res["checks"].items()})
            harness.free_device()
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0)}
    for what, rows in readings.items():
        if rows:
            pick = max if what == "port" else min
            summary[what] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
