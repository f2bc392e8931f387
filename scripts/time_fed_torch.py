#!/usr/bin/env python
"""Time the port's fed paths on the card through the engines' own loops:
the val loader through ``engine.eval.extract_features`` (the test CLI's
loop) and the train loader through ``engine.train.do_train`` (the train
CLI's loop), each with its own ``put`` (the host→device copy) and
prefetch, on a seeded RGBNT201-shaped JPEG tree at the flagship config
(``configs/RGBNT201/Signal.yml``, bf16, random weights from SOLVER.SEED).

``--root`` names the checkout whose ``signal_tpu_torch`` is timed, so
that two versions compare in one call on one card, in turns:

  git archive HEAD | tar -x -C build/parent
  for r in build/parent . . build/parent; do
    python scripts/time_fed_torch.py --root $r --data build/fed_data; done

The tree is written once under ``--data`` (the first run) by
``chip_smoke.write_rgbnt201`` of this checkout. Samples/s are counted from
the first batch's result to the last (the loader's start-up and the first
decode, build and warm-up are apart), by the host clock around
synchronised points. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def write_tree(data: Path) -> dict:
    if (data / "RGBNT201").is_dir():
        return {"reused": True}
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.write_rgbnt201(data, ids=128, per_id=8, seed=15)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(REPO), help="checkout whose signal_tpu_torch to time")
    ap.add_argument("--data", default=str(REPO / "build" / "fed_data"))
    ap.add_argument("opts", nargs="*", default=[],
                    help="KEY VALUE config overrides (MODEL.DEVICE cpu for a dry run)")
    args = ap.parse_args(argv)
    root, data = Path(args.root).resolve(), Path(args.data).resolve()
    tree = write_tree(data)
    sys.path.insert(0, str(root))

    import torch

    import signal_tpu_torch
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data import make_dataloader
    from signal_tpu_torch.engine.eval import extract_features
    from signal_tpu_torch.engine.train import do_train
    from signal_tpu_torch.metrics import R1mAPEvaluator
    from signal_tpu_torch.models import signal_model as sm

    out_dir = root / "build" / "time_fed_out"
    cfg = load_config(str(root / "configs/RGBNT201/Signal.yml"), [
        "DATASETS.ROOT_DIR", str(data), "MODEL.DEVICE", "cuda", "SOLVER.MAX_EPOCHS", "1",
        "SOLVER.EVAL_PERIOD", "1000", "SOLVER.CHECKPOINT_PERIOD", "1000",
        "OUTPUT_DIR", str(out_dir), *args.opts])
    device = torch.device(cfg.MODEL.DEVICE)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    else:
        smi = "cpu dry run: no device number"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    train, _, val, num_query, classes, cams, _ = make_dataloader(cfg)
    spec = sm.ModelSpec.from_config(cfg, num_classes=classes, camera_num=cams)
    result = {"root": str(root), "package": signal_tpu_torch.__file__, "nvidia_smi": smi,
              "tree": tree, "threads": cfg.DATALOADER.NUM_WORKERS}

    # eval: the clock starts at the first batch's features
    model = sm.init_signal(spec, seed=cfg.SOLVER.SEED).to(device)
    passes = []
    for _ in range(2):   # two passes: the host is shared
        ev = R1mAPEvaluator(num_query)
        stamps = []
        update = ev.update

        def timed_update(feats, *a, **kw):
            sync()
            stamps.append((time.perf_counter(), feats.shape[0]))
            return update(feats, *a, **kw)

        ev.update = timed_update
        extract_features(model, val, ev, device=device,
                         normalize=(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD))
        n = sum(b for _, b in stamps[1:])
        passes.append(n / (stamps[-1][0] - stamps[0][0]))
    result["fed_eval_samples_per_s"] = passes
    result["eval_decoder"] = getattr(val, "decoder", "pil")
    del model

    # train: the clock starts after the first step and stops when the
    # loop returns (its epoch end is a few host operations)
    model = sm.init_signal(spec, seed=cfg.SOLVER.SEED).to(device)
    stamps = []

    def step_callback(epoch, n_iter):
        if n_iter == 0:
            sync()
            stamps.append(time.perf_counter())
        stamps.append(n_iter)

    state = do_train(cfg, model, train, None, num_query, classes, device=device,
                     step_callback=step_callback)
    sync()
    steps = stamps[-1] + 1
    if steps < 2:
        raise SystemExit(f"the train loader gave {steps} step(s); timing needs two or more")
    result["fed_train_samples_per_s"] = (steps - 1) * cfg.SOLVER.IMS_PER_BATCH / (
        time.perf_counter() - stamps[0])
    result["train_steps"] = steps
    result["train_loss"] = float(state.loss)
    result["train_decoder"] = getattr(train, "decoder", "pil")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
