#!/usr/bin/env python3
"""What bounds the bf16 attention kernels of the PyTorch port, on one
NVIDIA GPU.

    python3 scripts/profile_torch_attention.py [--iters 20]

Builds three versions of ``signal_tpu_torch/csrc/attention_{fwd,bwd}.cu``
into ``build/profile_attention/`` (git-ignored), each one ``nvcc`` per
source, all started together:

* ``as_built``: the sources as they are;
* ``staging_only``: each bf16 kernel returns right after staging its
  operands in shared memory (the device-memory reads, no math, no stores);
* ``math_only``: each bf16 kernel skips the staging and computes on
  whatever shared memory holds (the on-chip work and the stores).

and times each bf16 kernel in each version at the main paths' shapes
(forward [384, 129, 768] and [192, 129, 768], backward [192, 129, 768], 12
heads of 64), and the backward's long route (its statistics and dK/dV
kernels together) at STRIDE_SIZE 12's [192, 211, 768] and a 384×128
input's [192, 193, 768], with CUDA events, in turns (every version twice). Only the
``as_built`` outputs mean anything; the script also reports the share of
them that differ from the plain PyTorch version (the rest are equal to the
bit). Prints one JSON object as its last line and writes it to
``chiprun_out/profile_torch_attention.json``. Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# the text each cut replaces in the sources; the script fails if one is
# missing, so an edited kernel cannot be profiled by a stale cut
_STAGED = "  cp_async_wait_all();\n  __syncthreads();\n"
# the long route's two kernels: each chunk of their rings skips its math
# once it has landed, and the dK/dV kernel returns before its cluster's
# last barrier (no block has arrived at it) and its stores
_RING = "    cp_async_wait<kLongStages - 1>();\n    __syncthreads();\n"
_LONG_TAIL = "  if (n > 1) {\n    asm volatile(\"barrier.cluster.wait"
_CUTS = {
    "staging_only": {
        "attention_fwd.cu": [("  stage_async(Vs, v + koff, Lk, LKP, hd, D);\n" + _STAGED,
                              "  stage_async(Vs, v + koff, Lk, LKP, hd, D);\n" + _STAGED
                              + "  if (Lq > 0) return;\n")],
        "attention_bwd.cu": [("  stage_async(Vs, v + koff, Lk, LKP, hd, D);\n" + _STAGED,
                              "  stage_async(Vs, v + koff, Lk, LKP, hd, D);\n" + _STAGED
                              + "  if (Lq > 0) return;\n"),
                             (_RING, _RING + "    if (Lq > 0) continue;\n"),
                             (_LONG_TAIL, "  if (Lq > 0) return;\n" + _LONG_TAIL)],
    },
    "math_only": {
        "attention_fwd.cu": [("  stage_async(Qs, q + qoff, Lq - row0, rows, hd, D);\n", ""),
                             ("  stage_async(Ks, k + koff, Lk, LKP, hd, D);\n", ""),
                             ("  stage_async(Vs, v + koff, Lk, LKP, hd, D);\n", "")],
        "attention_bwd.cu": [("  stage_async(Qs, q + qoff, Lq, LQP, hd, D);\n", ""),
                             ("  stage_async(Gs, g + qoff, Lq, LQP, hd, D);\n", ""),
                             ("  stage_async(Ks, k + koff, Lk, LKP, hd, D);\n", ""),
                             ("  stage_async(Vs, v + koff, Lk, LKP, hd, D);\n", ""),
                             # the long route
                             ("  stage_async(Qs, q + qoff, Lq - q0, QR, hd, D);\n", ""),
                             ("  stage_async(Gs, g + qoff, Lq - q0, QR, hd, D);\n", ""),
                             ("    stage_async(Kc, k + off, Lk - c * kStatKeys, kStatKeys, hd, D);\n",
                              ""),
                             ("    stage_async(Kc + kStatKeys * so, v + off, Lk - c * kStatKeys, "
                              "kStatKeys, hd, D);\n", ""),
                             ("  stage_async(Ks, k + koff + (size_t)k0 * D, nk, KR, hd, D);\n", ""),
                             ("  stage_async(Vs, v + koff + (size_t)k0 * D, nk, KR, hd, D);\n", ""),
                             ("    stage_async(Qc, q + off, Lq - c * kLongQ, kLongQ, hd, D);\n", ""),
                             ("    stage_async(Qc + kLongQ * so, g + off, Lq - c * kLongQ, kLongQ, "
                              "hd, D);\n", ""),
                             ("      cp_async16(st + t * kLongQ + r, stat_bh + t * rows + c * kLongQ "
                              "+ r, true);\n", "")],
    },
}


def build(out: Path):
    """→ {version: {source name: library path}}, all built in parallel."""
    from signal_tpu_torch.ops import _build

    running, libs = [], {}
    for version in ("as_built", *_CUTS):
        d = out / version
        d.mkdir(parents=True, exist_ok=True)
        for src in _build.CSRC_DIR.iterdir():
            text = src.read_text()
            for old, new in _CUTS.get(version, {}).get(src.name, []):
                if old not in text:
                    raise SystemExit(f"{version}: {src.name} no longer holds {old!r}")
                text = text.replace(old, new)
            (d / src.name).write_text(text)
        for name in ("attention_fwd", "attention_bwd"):
            lib = d / f"lib{name}.so"
            libs.setdefault(version, {})[name] = lib
            running.append(subprocess.Popen(
                [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(d / f"{name}.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
    if any(p.wait() for p in running):
        raise SystemExit("nvcc failed")
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from signal_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    libs = build(REPO / "build" / "profile_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {B: [torch.randn(B, 129, 768, device="cuda", generator=gen).bfloat16()
                for _ in range(4)] for B in (384, 192)}
    long_lengths = (211, 193)
    long_data = {L: [torch.randn(192, L, 768, device="cuda", generator=gen).bfloat16()
                     for _ in range(4)] for L in long_lengths}
    # the long route's statistics scratch: 3 B H Lq rounded up to 32, fp32
    long_stats = {L: torch.empty(3 * 192 * 12 * ((L + 31) // 32 * 32), device="cuda")
                  for L in long_lengths}

    def ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    def launchers(version):
        fwd = ctypes.CDLL(str(libs[version]["attention_fwd"]))
        bwd = ctypes.CDLL(str(libs[version]["attention_bwd"]))
        fwd.attention_fwd.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_float, p]
        bwd.attention_bwd.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, p]
        calls = {}
        for B in (384, 192):
            q, k, v, g = data[B]
            o = torch.empty_like(q)
            calls[f"fwd [{B}, 129, 768]"] = (o, lambda q=q, k=k, v=v, o=o, B=B: fwd.attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, B, 12, 129, 129,
                64, 0.125, stream))
        q, k, v, g = data[192]
        grads = [torch.empty_like(q) for _ in range(3)]
        calls["bwd [192, 129, 768]"] = (
            grads, lambda q=q, k=k, v=v, g=g, grads=grads: bwd.attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                *(t.data_ptr() for t in grads), None, 1, 192, 12, 129, 129, 64, 0.125, stream))
        for L in long_lengths:
            q, k, v, g = long_data[L]
            grads = [torch.empty_like(q) for _ in range(3)]
            calls[f"bwd long [192, {L}, 768]"] = (
                grads, lambda q=q, k=k, v=v, g=g, grads=grads, L=L: bwd.attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                    *(t.data_ptr() for t in grads), long_stats[L].data_ptr(), 1, 192, 12, L, L,
                    64, 0.125, stream))
        return calls

    versions = {v: launchers(v) for v in libs}
    times = {}
    for version in [*libs, *reversed(libs)]:
        for case, (_, fn) in versions[version].items():
            if fn() != 0:
                raise SystemExit(f"{version} {case}: launch failed")
            times.setdefault(case, {}).setdefault(version, []).append(ms(fn))

    # the as-built outputs against the plain versions: the share that differ
    differ = {}
    for case, (out, fn) in versions["as_built"].items():
        fn()
        torch.cuda.synchronize()
        if case.startswith("fwd"):
            q, k, v, _ = data[int(case[5:8])]
            want = [flash_attention_reference(q, k, v, 12)]
            out = [out]
        elif case.startswith("bwd long"):
            want = flash_attention_bwd_reference(*long_data[int(case[15:18])], 12)
        else:
            want = flash_attention_bwd_reference(*data[192], 12)
        differ[case] = [(a != b).float().mean().item() for a, b in zip(out, want)]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "ms": {c: {v: sum(t) / len(t) for v, t in vs.items()} for c, vs in times.items()},
              "ms_each_turn": times, "as_built_share_differing_from_plain": differ}
    for case, vs in result["ms"].items():
        print(f"[attention] {case}: " + ", ".join(f"{v} {t:.4f} ms" for v, t in vs.items()))
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_torch_attention.json").write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
