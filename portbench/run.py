#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``signal_tpu_torch``) on NVIDIA
cards: one cell of ``BENCHMARK.json`` a run.

    python3 portbench/run.py --workload rgbnt201-train --seed 7 --seconds 20 --trace 0

Builds the cell's configuration with weights and inputs made from
``--seed``, warms up the cell's own shapes (set-up), drives its traffic
mix for ``--seconds`` on the card, checks what the timed path produced
against the plain reference, and prints one JSON line last: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics (and the
device's busy time and a breakdown) with ``--trace 1``. Each number
compared beside its limit is the result's last key and the last lines of
standard error.

Exits non-zero and prints no result without a CUDA card (there is no
fallback to the CPU), and if JAX or the JAX package is loaded once the
window has closed. The port's kernels build into the checkout's
``build/kernels/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="weights and inputs come from it")
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: per-layer metrics from a traced window")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import spec

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench import harness

    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START)
    res = harness.drive(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port runs without JAX", file=sys.stderr)
        return 3
    harness.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
