#!/usr/bin/env python3
"""Where the time of the PyTorch port's flagship train step goes, on one
NVIDIA GPU.

    python3 scripts/profile_torch_train.py [--batch 64] [--iters 5]

Builds the flagship RGBNT201 model of the port (CLIP ViT-B/16, width 768,
12 heads, 256x128, SIE, SIM TOPK 80, GAM + LAM, remat; bf16; random
weights from seed 0) with Adam at the config's param groups, feeds it B
random packed uint8 images with P×K labels and random cameras, and
reports:

* ms per step and samples/s: host clock around synchronised
  ``engine.train.make_train_step`` steps (device augment on, as
  configured);
* device time per stage (CUDA events between the step's own
  ``train_step.stages``): normalize + augment, forward (``forward_train`` +
  ``total_train_loss``), backward (with the remat recompute), optimizer
  step and accuracy;
* a ``torch.profiler`` window of ``--iters`` steps: device time by kernel
  name and by kind (the attention kernels, GEMMs, LayerNorm, elementwise,
  ...), the device's busy time over the window and its idle share;
* the peak device memory of one step.

Prints one JSON object as its last line and writes it to
``chiprun_out/profile_torch_train.json``. Needs a CUDA card and ``nvcc``;
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# kernel-name substrings → kind, first match wins
KINDS = (
    ("attention_fwd", "attention forward kernel (csrc/attention_fwd.cu)"),
    ("rows_kernel", "attention backward kernel (csrc/attention_bwd.cu)"),
    ("cols_kernel", "attention backward kernel (csrc/attention_bwd.cu)"),
    ("gemm", "GEMM"), ("nvjet", "GEMM"), ("xmma", "GEMM"), ("cutlass", "GEMM"),
    ("conv", "convolution"), ("wgrad", "convolution"), ("dgrad", "convolution"),
    ("layer_norm", "LayerNorm"), ("LayerNorm", "LayerNorm"),
    ("sort", "sort / top-k"), ("topk", "sort / top-k"), ("scatter", "sort / top-k"),
    ("softmax", "softmax"),
    ("multi_tensor_apply", "optimizer"), ("adam", "optimizer"),
    ("reduce", "reduction"),
    ("copy", "copy / cast"), ("Memcpy", "copy / cast"), ("Memset", "copy / cast"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
)


def kind_of(name: str) -> str:
    for key, kind in KINDS:
        if key in name:
            return kind
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64, help="SOLVER.IMS_PER_BATCH (flagship: 64)")
    ap.add_argument("--iters", type=int, default=5, help="steps per timed window")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"))
    B, C, K = args.batch, 171, cfg.DATALOADER.NUM_INSTANCE
    spec = sm.ModelSpec.from_config(cfg, num_classes=C, camera_num=4)
    model = sm.init_signal(spec, seed=0).to("cuda")
    optimizer = make_optimizer(model, cfg)
    set_lr(optimizer, *schedule_coeffs(cfg, 1))
    aug_gen = torch.Generator(device="cuda").manual_seed(1)
    step = make_train_step(model, cfg, C, optimizer, device_augment=True, gen=aug_gen)
    gen = torch.Generator(device="cuda").manual_seed(1)
    u8 = torch.randint(0, 256, (B, 3, 3, 256, 128), dtype=torch.uint8, device="cuda",
                       generator=gen)
    pids = torch.randperm(C, device="cuda", generator=gen)[:B // K].repeat_interleave(K)
    cams = torch.randint(0, 4, (B,), device="cuda", generator=gen)

    for _ in range(2):  # builds the kernels, warms the allocator and cuBLAS
        step(u8, pids, cams)
    torch.cuda.synchronize()

    # end to end on the host clock
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step(u8, pids, cams)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / args.iters * 1e3

    # device time per stage: the step's own stages with CUDA events between
    prepare, forward, backward, update = step.stages
    stages = defaultdict(float)
    for _ in range(args.iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        imgs = prepare(u8)
        ev[1].record()
        out, loss = forward(imgs, pids, cams)
        ev[2].record()
        backward(loss)
        ev[3].record()
        update(out, loss, pids)
        ev[4].record()
        torch.cuda.synchronize()
        for name, a, b in (("normalize_augment", 0, 1), ("forward_and_loss", 1, 2),
                           ("backward", 2, 3), ("optimizer", 3, 4)):
            stages[name] += ev[a].elapsed_time(ev[b]) / args.iters
        del imgs, out, loss

    # the profiler's view: kernels by device time, busy and idle share
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    attention_fwd_cuda.launches = attention_bwd_cuda.launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step(u8, pids, cams)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    launches = {"attention_fwd": attention_fwd_cuda.launches / args.iters,
                "attention_bwd": attention_bwd_cuda.launches / args.iters}
    # device events only; the optimizer's step annotation spans its kernels
    # on the device timeline and would count them twice
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    by_name = sorted(((e.key, e.self_device_time_total / 1e3 / args.iters, e.count // args.iters)
                      for e in kernels), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_name)
    by_kind = defaultdict(float)
    for name, ms, _ in by_name:
        by_kind[kind_of(name)] += ms

    torch.cuda.reset_peak_memory_stats()
    step(u8, pids, cams)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    report = {
        "device": smi, "torch": torch.__version__, "batch": B, "iters": args.iters,
        "ms_per_step": ms_step, "samples_per_s": B / ms_step * 1e3,
        "stage_ms": dict(stages),
        "profiled_window_ms_per_step": window_ms / args.iters,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (1.0 - busy_ms * args.iters / window_ms
                              if busy_ms else "not measured (profiler saw no device time)"),
        "kernel_launches_per_step": launches,
        "ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms": ms, "launches": c} for n, ms, c in by_name[:20]],
        "peak_memory_gib": peak_gib,
    }
    for key in ("ms_per_step", "samples_per_s", "stage_ms", "device_busy_ms_per_step",
                "device_idle_share", "kernel_launches_per_step", "ms_by_kind",
                "peak_memory_gib"):
        print(f"[profile] {key}: {json.dumps(report[key])}")
    for row in report["top_kernels"]:
        print(f"[kernel] {row['ms']:.3f} ms x{row['launches']} {row['name']}")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_torch_train.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
