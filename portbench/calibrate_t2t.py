#!/usr/bin/env python3
"""The readings the T2T gallery cell's ``feature_gap`` limit is set from,
on the card at the cell's own size, many seeds in one process (what
``calibrate.py`` does for the ViT-B/16 cells):

* the port: a short run of the cell (set-up, a window of ``--seconds``,
  the comparison) on each seed;
* the control: the plain reference with its compute-dtype products in
  float8 (E4M3) against the float32 reference (``feature_gap``), and its
  token map with TF32 products against float32's (``t2t_gap``: the
  precision below the float32 the token transformers run in), on the
  seed's weights and the pool's first checked batches;
* planted faults, each run through the port: ``half_batch`` (each batch's
  second half of rows repeats the first's features), ``head_scale`` (the
  token attention scaled by the head's 64^-1/2 where T2T-ViT takes the
  input dim's, 147^-1/2 and 576^-1/2: the slip a kernel put behind
  ``token_attention`` could make), ``tf32`` and ``bf16`` (the token
  attention's products in TF32, or all of it in bf16: a kernel of a lower
  precision put behind the operator).

    python3 portbench/calibrate_t2t.py --seeds 8 --control 3 --faults 2

Prints one JSON line a reading and a summary last (the largest of the
port's, the smallest of the control's and of each fault's).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORKLOAD = "rgbnt201-t2t-gallery"
FAULTS = ("half_batch", "head_scale", "tf32", "bf16")


def control_numbers(run) -> dict:
    import torch

    from portbench import correct, spec
    from portbench.inputs import make_pool
    from portbench.kinds.t2t_gallery import make_weights
    from portbench.reference import t2t

    arch = t2t.reference_arch(run.cell.config, train=False)
    hp = spec.recipe(run.cell.config)
    pool = make_pool(arch, hp["batch_test"], run.cell.traffic["checked_batches"], run.seed,
                     run.device)
    weights = make_weights(arch, run.seed, run.device)
    gaps, map_gaps = [], []
    for b in pool:
        imgs, cams = (torch.from_numpy(b[k]).to(run.device) for k in ("packed", "camids"))
        ref = t2t.gallery_features(weights, arch, hp, imgs, cams)
        low = t2t.gallery_features(weights, arch, hp, imgs, cams, precision="fp8")
        gaps.append(correct.feature_gap(low, ref))
        map_gaps.append(correct.feature_gap(
            t2t.gallery_token_maps(weights, arch, hp, imgs, tf32=True),
            t2t.gallery_token_maps(weights, arch, hp, imgs)))
    return {"feature_gap": max(gaps), "t2t_gap": max(map_gaps)}


def plant(fault: str):
    """Plant ``fault`` in the port; → a function that takes it out."""
    import torch

    if fault == "half_batch":
        import signal_tpu_torch.engine.eval as engine_eval

        fwd = engine_eval.forward_eval

        def half(model, imgs, cams):
            n = imgs.shape[0] // 2
            out = fwd(model, imgs[:n], cams[:n])
            return torch.cat([out, out])[:imgs.shape[0]]

        engine_eval.forward_eval = half
        return lambda: setattr(engine_eval, "forward_eval", fwd)
    import signal_tpu_torch.models.t2t as port_t2t

    attend = port_t2t.token_attention

    def head_scale(q, k, v, scale):
        return attend(q, k, v, q.shape[-1] ** -0.5)

    def tf32(q, k, v, scale):
        mm = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1) @ v
        finally:
            torch.backends.cuda.matmul.allow_tf32 = mm

    def bf16(q, k, v, scale):
        return attend(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale).float()

    port_t2t.token_attention = {"head_scale": head_scale, "tf32": tf32, "bf16": bf16}[fault]
    return lambda: setattr(port_t2t, "token_attention", attend)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8, help="seeds of the port's runs")
    ap.add_argument("--control", type=int, default=3, help="seeds of the control")
    ap.add_argument("--faults", type=int, default=2, help="seeds of each planted fault")
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        print("calibrate_t2t: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, WORKLOAD)
    readings = {what: [] for what in ("port", "control") + FAULTS}

    def one(what, seed, numbers):
        readings[what].append(numbers)
        print(json.dumps({"what": what, "workload": WORKLOAD, "seed": seed, **numbers}),
              flush=True)

    def new_run(seed):
        return harness.Run(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                           device=torch.device("cuda", 0), t_start=time.perf_counter())

    def drive(seed):
        res = harness.drive(new_run(seed))
        harness.free_device()
        return {k: c["value"] for k, c in res["checks"].items()}

    for i in range(args.seeds):
        one("port", args.first_seed + i, drive(args.first_seed + i))
    for i in range(args.control):
        one("control", args.first_seed + i, control_numbers(new_run(args.first_seed + i)))
        harness.free_device()
    for fault in FAULTS:
        for i in range(args.faults):
            restore = plant(fault)
            try:
                one(fault, args.first_seed + i, drive(args.first_seed + i))
            finally:
                restore()
    summary = {"workload": WORKLOAD, "device": torch.cuda.get_device_name(0)}
    for what, rows in readings.items():
        if rows:
            pick = max if what == "port" else min
            summary[what] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
