#!/usr/bin/env python3
"""What bounds the bf16 attention kernels of the PyTorch port, on one
NVIDIA GPU.

    python3 scripts/profile_torch_attention.py [--iters 20]

Builds three versions of ``signal_tpu_torch/csrc/attention_{fwd,bwd}.cu``
into ``build/profile_attention/`` (git-ignored), each one ``nvcc`` per
source, all started together:

* ``as_built``: the sources as they are;
* ``staging_only``: each bf16 kernel moves its operands into shared memory
  and does no math and no stores (the device-memory reads alone; the
  forward's one-pass kernel still waits for every copy and keeps its ring
  of query tiles turning, its long-route kernel's consumer warps wait for
  every chunk of the ring and release it, the backward's fused kernel
  waits for every copy and skips both phases' tiles);
* ``math_only``: each bf16 kernel skips the copies (and the waits for them)
  and computes on whatever shared memory holds (the on-chip work and the
  stores).

and times each bf16 kernel in each version at the main paths' shapes, with
CUDA events, in turns (every version twice): the forward's one-pass kernel
at [384, 129, 768], [192, 129, 768] and STRIDE_SIZE 12's [192, 211, 768]
(12 heads of 64), and at the same shapes and at a 384×128 input's
STRIDE_SIZE 12 shape [192, 311, 768] the long-route kernel that takes keys
past 256 (launched through its route directly); the backward's fused kernel at
[192, 129, 768], and the backward's long route (its statistics and dK/dV
kernels together) at [192, 211, 768] and a 384×128 input's [192, 193,
768]. Only the ``as_built`` outputs mean anything; the script also reports
the share of them that differ from the plain PyTorch version (the rest are
equal to the bit). Prints one JSON object as its last line and writes it
to ``chiprun_out/profile_torch_attention.json``. Imports nothing of JAX or
of the JAX package.
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
# the forward's long-route kernel: its consumer warps take every chunk of
# the ring and release it, with no math and no stores
_LONG_FWD_CONSUMERS = ("  const float sl2 = scale * 1.4426950408889634f;\n"
                       "  // S = Q.K^T of the 64 rows against the chunk in stage st")
_LONG_FWD_STAGING = ("  if (Lq > 0) {\n    for (int t = 0; t < 3 * n; ++t) {\n"
                     "      tma::mbar_wait(full + t % ST, (t / ST) & 1);\n"
                     "      __syncwarp();\n"
                     "      if (lane == 0) tma::mbar_arrive(empty + t % ST);\n"
                     "    }\n    return;\n  }\n" + _LONG_FWD_CONSUMERS)
# the long route's two kernels: each chunk of their rings skips its math
# once it has landed, and the dK/dV kernel returns before its cluster's
# last barrier (no block has arrived at it) and its stores
_RING = "    cp_async_wait<kLongStages - 1>();\n    __syncthreads();\n"
_LONG_TAIL = "  if (n > 1) {\n    asm volatile(\"barrier.cluster.wait"
# the backward's fused kernel: the tile loops of its two phases (query
# tiles, then key tiles)
_FUSED_PHASES = ("  for (int t = first; t < LQP / kRows; t += workers) {\n",
                 "  for (int t = workers - 1 - first; t < LKP / kRows; t += workers) {\n")
# the forward's one-pass kernel: its product Q.K^T, and the softmax, P.V and
# stores of a query tile
_ONE_PASS_QK = "    dot_qk(s, Qw + st * slabs * q_slab, q_slab, Ks, kv_slab, HDP, lane);\n"
_ONE_PASS_REST = ("    softmax_pv_store(s, Vs, kv_slab, Lk, hd, scale, dst, D, Lq - tile * kTileRows, "
                  "lane);\n")
_CUTS = {
    "staging_only": {
        "attention_fwd.cu": [(_LONG_FWD_CONSUMERS, _LONG_FWD_STAGING),
                             # the one-pass kernel: no products, no softmax, no stores
                             (_ONE_PASS_QK, ""), (_ONE_PASS_REST, "")],
        "attention_bwd.cu": [*((loop, loop + "    if (Lq > 0) continue;\n")
                               for loop in _FUSED_PHASES),
                             (_RING, _RING + "    if (Lq > 0) continue;\n"),
                             (_LONG_TAIL, "  if (Lq > 0) return;\n" + _LONG_TAIL)],
    },
    "math_only": {
        "attention_fwd.cu": [# the one-pass and long-route kernels: no TMA
                             # copy is issued or waited for
                             ("tma::load_4d", "if (h < 0) tma::load_4d"),
                             ("tma::mbar_expect_tx(", "if (h < 0) tma::mbar_expect_tx("),
                             ("tma::mbar_wait(", "if (h < 0) tma::mbar_wait(")],
        "attention_bwd.cu": [# the fused kernel: no TMA copy is issued or
                             # waited for
                             ("tma::load_4d", "if (h < 0) tma::load_4d"),
                             ("tma::mbar_expect_tx(", "if (h < 0) tma::mbar_expect_tx("),
                             ("tma::mbar_wait(", "if (h < 0) tma::mbar_wait("),
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
                 str(d / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    outputs = [(p, p.communicate()[0]) for p in running]
    failed = [text for p, text in outputs if p.returncode]
    if failed:
        raise SystemExit("nvcc failed:\n" + "\n".join(failed))
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
        BWD_ROUTES,
        FWD_ROUTES,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    libs = build(REPO / "build" / "profile_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {B: [torch.randn(B, 129, 768, device="cuda", generator=gen).bfloat16()
                for _ in range(4)] for B in (384, 192)}
    fwd_shapes = ((384, 129), (192, 129), (192, 211))
    long_lengths = (211, 193)
    long_data = {L: [torch.randn(192, L, 768, device="cuda", generator=gen).bfloat16()
                     for _ in range(4)] for L in (*long_lengths, 311)}
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
        for B, L in (*fwd_shapes, (192, 311)):
            q, k, v, g = data[B] if L == 129 else long_data[L]
            o = torch.empty_like(q)
            routes = (("fwd", "one_pass"), ("fwd long", "long")) if L <= 256 else \
                (("fwd long", "long"),)
            for tag, route in routes:
                calls[f"{tag} [{B}, {L}, 768]"] = (
                    o, lambda q=q, k=k, v=v, o=o, B=B, L=L, code=FWD_ROUTES[route]:
                    fwd.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                      code, B, 12, L, L, 64, 0.125, stream))
        q, k, v, g = data[192]
        grads = [torch.empty_like(q) for _ in range(3)]
        calls["bwd fused [192, 129, 768]"] = (
            grads, lambda q=q, k=k, v=v, g=g, grads=grads: bwd.attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                *(t.data_ptr() for t in grads), None, BWD_ROUTES["fused"], 192, 12, 129, 129, 64,
                0.125, stream))
        for L in long_lengths:
            q, k, v, g = long_data[L]
            grads = [torch.empty_like(q) for _ in range(3)]
            calls[f"bwd long [192, {L}, 768]"] = (
                grads, lambda q=q, k=k, v=v, g=g, grads=grads, L=L: bwd.attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                    *(t.data_ptr() for t in grads), long_stats[L].data_ptr(), BWD_ROUTES["long"], 192,
                    12, L, L, 64, 0.125, stream))
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
            B, L = (int(x) for x in case[case.index("[") + 1:].split(",")[:2])
            q, k, v, _ = data[B] if L == 129 else long_data[L]
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
