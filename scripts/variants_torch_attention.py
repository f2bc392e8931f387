#!/usr/bin/env python3
"""Design variants of the bf16 attention forward's one-pass kernel, timed
against each other on one NVIDIA GPU.

    python3 scripts/variants_torch_attention.py [scripts/attention_fwd_variants.json]

The JSON file names each variant by a list of text cuts ``[old, new]`` of
``signal_tpu_torch/csrc/attention_fwd.cu`` (an empty list is the source as
it is). The script builds every variant with ``nvcc`` into
``build/variants_attention/`` (git-ignored; one ``nvcc`` per variant, all
started together; a cut whose text is missing fails the script), reports
each one-pass instance's registers and spill bytes, and times the one-pass
route of each variant, the first variant's two-pass route (the kernel the
one-pass route replaced up to 256 keys) and
``torch.nn.functional.scaled_dot_product_attention`` at the main paths'
bf16 shapes with CUDA events, in turns (forward, then backward through the
names), each launch straight through the C interface (no Python wrapper).
Every variant's output is held against the plain PyTorch version (bf16
atol 1.6e-2). Prints one JSON object as its last line and writes it to
``chiprun_out/variants_torch_attention.json``. Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# (B, L, D, H): eval and train at 129 tokens, STRIDE_SIZE 12's 211, a TP
# rank at 211 (MODEL_AXIS 4), pipeline microbatches (fewer heads than SMs)
SHAPES = ((384, 129, 768, 12), (192, 129, 768, 12), (192, 211, 768, 12), (192, 211, 192, 3),
          (12, 129, 768, 12), (3, 129, 768, 12), (12, 211, 768, 12))
BF16_ATOL = 1.6e-2


def build(variants: dict) -> dict:
    """→ {variant: (library path, nvcc's report)}; raises with nvcc's
    output if one fails."""
    from signal_tpu_torch.ops import _build

    running = {}
    for name, cuts in variants.items():
        d = REPO / "build" / "variants_attention" / name
        d.mkdir(parents=True, exist_ok=True)
        for src in _build.CSRC_DIR.iterdir():
            text = src.read_text()
            if src.name == "attention_fwd.cu":
                for old, new in cuts:
                    if old not in text:
                        raise SystemExit(f"{name}: attention_fwd.cu no longer holds {old!r}")
                    text = text.replace(old, new)
            (d / src.name).write_text(text)
        lib = d / "libattention_fwd.so"
        running[name] = (lib, subprocess.Popen(
            [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / "attention_fwd.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, failed = {}, []
    for name, (lib, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
        libs[name] = (lib, log)
    if failed:
        raise SystemExit("nvcc failed:\n" + "\n".join(failed))
    return libs


def ptxas(log: str) -> dict:
    """The one-pass instances' registers and spill bytes in nvcc's report."""
    out, fn = {}, None
    for line in log.splitlines():
        hit = re.search(r"Function properties for (\w+)", line)
        if hit:
            inst = re.search(r"onepass_kernelILi(\d+)ELi(\d+)E", hit.group(1))
            fn = f"<{inst.group(1)}, {inst.group(2)}>" if inst else None
            continue
        if fn is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit:
            out.setdefault(fn, {})["spill_bytes"] = int(hit.group(1)) + int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out.setdefault(fn, {})["registers"] = int(hit.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="?", default=str(REPO / "scripts/attention_fwd_variants.json"))
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from signal_tpu_torch.ops.flash_attention import FWD_ROUTES, flash_attention_reference

    libs = build(json.loads(Path(args.variants).read_text()))
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    fns = {}
    for name, (lib, _) in libs.items():
        fns[name] = ctypes.CDLL(str(lib))
        fns[name].attention_fwd.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_float, p]

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, bad = {}, []
    for B, L, D, H in SHAPES:
        q, k, v = (torch.randn(B, L, D, device="cuda", generator=gen).bfloat16() for _ in "qkv")
        o = torch.empty_like(q)
        hd = D // H
        want = flash_attention_reference(q, k, v, H).float()
        qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
        as_built = fns[next(iter(fns))]
        calls = {"sdpa": lambda: F.scaled_dot_product_attention(qh, kh, vh),
                 # the design the one-pass kernel replaced at these lengths,
                 # the first variant's two-pass route
                 "two_pass": lambda: as_built.attention_fwd(
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), FWD_ROUTES["long"],
                     B, H, L, L, hd, hd ** -0.5, stream)}
        for name, lib in fns.items():
            calls[name] = lambda lib=lib: lib.attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), FWD_ROUTES["one_pass"],
                B, H, L, L, hd, hd ** -0.5, stream)
        row, shape = {}, f"[{B}, {L}, {D}]"
        for name in fns:
            if calls[name]() != 0:
                raise SystemExit(f"{name} {shape}: launch failed")
            torch.cuda.synchronize()
            err = (o.float() - want).abs().max().item()
            row[f"{name}_max_abs_err"] = err
            if not err <= BF16_ATOL:
                bad.append(f"{name} {shape}: max abs err {err}")
        names = list(calls)
        for turn in range(2):
            for name in (names if turn == 0 else names[::-1]):
                row.setdefault(name, []).append(ms(calls[name]))
        rows[shape] = row
        print(f"[variants] {shape}: " + ", ".join(
            f"{n} {sum(row[n]) / 2:.4f} ms" for n in names), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "ptxas": {name: ptxas(log) for name, (_, log) in libs.items()},
              "ms_each_turn": rows,
              "ms": {s: {n: sum(t) / len(t) for n, t in r.items() if isinstance(t, list)}
                     for s, r in rows.items()}}
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "variants_torch_attention.json").write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
