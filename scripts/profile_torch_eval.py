#!/usr/bin/env python3
"""Where the time of the PyTorch port's flagship eval forward goes, on one
NVIDIA GPU.

    python3 scripts/profile_torch_eval.py [--batch 128] [--iters 5]

Builds the flagship RGBNT201 model of the port (CLIP ViT-B/16, width 768,
12 heads, 256x128, SIE, SIM TOPK 80; bf16; random weights from seed 0),
feeds it B random packed uint8 images with random cameras, and reports:

* ms per batch and samples/s: host clock around synchronised forwards;
* device time per stage (CUDA events): normalize, ViT tower
  (``signal_model._encode``), SIM (``sim.sim_forward``);
* a ``torch.profiler`` window of ``--iters`` forwards: device time by
  kernel name and by kind (the attention kernel, GEMMs, LayerNorm,
  elementwise, ...), the device's busy time over the window and its idle
  share, and the launches a batch of the attention kernel and of each of
  the tower's one-pass epilogues (``ops/epilogue.py``);
* the peak device memory of one forward.

Prints one JSON object as its last line and writes it to
``chiprun_out/profile_torch_eval.json``. Needs a CUDA card and ``nvcc``;
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
    ("attention_fwd", "attention kernel (csrc/attention_fwd.cu)"),
    ("gemm", "GEMM"), ("nvjet", "GEMM"), ("xmma", "GEMM"), ("cutlass", "GEMM"),
    ("conv", "convolution"),
    ("layer_norm", "LayerNorm"), ("LayerNorm", "LayerNorm"),
    ("sort", "sort / top-k"), ("topk", "sort / top-k"), ("scatter", "sort / top-k"),
    ("softmax", "softmax"),
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
    ap.add_argument("--batch", type=int, default=128, help="TEST.IMS_PER_BATCH (flagship: 128)")
    ap.add_argument("--iters", type=int, default=5, help="forwards per timed window")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data.augment import normalize_images
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.models.sim import sim_forward
    from signal_tpu_torch.ops import epilogue
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda
    from signal_tpu_torch.utils.flops import peak_flops_per_chip, signal_analytic_flops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"))
    spec = sm.ModelSpec.from_config(cfg, num_classes=171, camera_num=4)
    model = sm.init_signal(spec, seed=0).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    B = args.batch
    u8 = torch.randint(0, 256, (B, 3, 3, 256, 128), dtype=torch.uint8, device="cuda",
                       generator=gen)
    cams = torch.randint(0, 4, (B,), device="cuda", generator=gen)
    mean, std = cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD

    def forward():
        with torch.inference_mode():
            return sm.forward_eval(model, normalize_images(u8, mean, std), cams)

    forward()  # builds the kernel, warms the allocator and cuBLAS
    torch.cuda.synchronize()

    # end to end on the host clock
    t0 = time.perf_counter()
    for _ in range(args.iters):
        forward()
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) / args.iters * 1e3

    # device time per stage (CUDA events between the stages of forward_eval)
    stages = defaultdict(float)
    for _ in range(args.iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with torch.inference_mode():
            ev[0].record()
            imgs = normalize_images(u8, mean, std)
            ev[1].record()
            patches, cls, _ = sm._encode(model, imgs, cams)
            ev[2].record()
            sim_forward(model.SIM, patches, cls, k=spec.topk, compute_dtype=spec.cdtype)
            ev[3].record()
        torch.cuda.synchronize()
        for name, a, b in (("normalize", 0, 1), ("vit_tower", 1, 2), ("sim", 2, 3)):
            stages[name] += ev[a].elapsed_time(ev[b]) / args.iters

    # the profiler's view: kernels by device time, busy and idle share
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    attention_fwd_cuda.launches = 0
    epilogues = {n: getattr(epilogue, f"{n}_cuda") for n in
                 ("bias_cast", "bias_gelu", "bias_residual")}
    for fn in epilogues.values():
        fn.launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            forward()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    launches = attention_fwd_cuda.launches
    epilogue_launches = {n: fn.launches / args.iters for n, fn in epilogues.items()}
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    by_name = sorted(((e.key, e.self_device_time_total / 1e3 / args.iters, e.count // args.iters)
                      for e in kernels), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_name)
    by_kind = defaultdict(float)
    for name, ms, _ in by_name:
        by_kind[kind_of(name)] += ms

    torch.cuda.reset_peak_memory_stats()
    forward()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    report = {
        "device": smi, "torch": torch.__version__, "batch": B, "iters": args.iters,
        "ms_per_batch": ms_batch, "samples_per_s": B / ms_batch * 1e3,
        "stage_ms": dict(stages),
        "profiled_window_ms_per_batch": window_ms / args.iters,
        "device_busy_ms_per_batch": busy_ms,
        "device_idle_share": (1.0 - busy_ms * args.iters / window_ms
                              if busy_ms else "not measured (profiler saw no device time)"),
        "attention_launches_per_batch": launches / args.iters,
        "epilogue_launches_per_batch": epilogue_launches,
        "ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms": ms, "launches": c} for n, ms, c in by_name[:15]],
        "peak_memory_gib": peak_gib,
    }
    # model FLOPs over the host-clock time and the published bf16 peak
    report["analytic_tflop_per_batch"] = signal_analytic_flops(spec, B) / 1e12
    report["mfu"] = report["analytic_tflop_per_batch"] / (ms_batch / 1e3) / \
        (peak_flops_per_chip(torch.cuda.get_device_name(0)) / 1e12)
    for key in ("ms_per_batch", "samples_per_s", "stage_ms", "device_busy_ms_per_batch",
                "device_idle_share", "attention_launches_per_batch",
                "epilogue_launches_per_batch", "ms_by_kind", "peak_memory_gib",
                "analytic_tflop_per_batch", "mfu"):
        print(f"[profile] {key}: {json.dumps(report[key])}")
    for row in report["top_kernels"]:
        print(f"[kernel] {row['ms']:.3f} ms x{row['launches']} {row['name']}")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_torch_eval.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
