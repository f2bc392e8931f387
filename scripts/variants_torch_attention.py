#!/usr/bin/env python3
"""Design variants of the bf16 attention kernels, timed against each other
on one NVIDIA GPU.

    python3 scripts/variants_torch_attention.py [scripts/attention_fwd_variants.json]
    python3 scripts/variants_torch_attention.py --bwd [scripts/attention_bwd_variants.json] \
        [--baseline DIR]

The JSON file names each variant by a list of text cuts ``[old, new]`` of
``signal_tpu_torch/csrc/attention_fwd.cu`` (with ``--bwd``:
``attention_bwd.cu``; an empty list is the source as it is). The script
builds every variant with ``nvcc`` into ``build/variants_attention/``
(git-ignored; one ``nvcc`` per variant, all started together; a cut whose
text is missing fails the script) and reports each instance's registers
and spill bytes of the kernel under study. The forward: it times the
one-pass route of each variant, the first variant's two-pass route (the
kernel the one-pass route replaced up to 256 keys) and
``torch.nn.functional.scaled_dot_product_attention``. The backward: the
fused route of each variant, SDPA's backward alone (``autograd.grad`` of
its output) and, with ``--baseline DIR``, the fused route of
``DIR/signal_tpu_torch/csrc/attention_bwd.cu`` (an earlier tree, for
example ``git archive`` of a parent commit unpacked under ``build/``).
Each at the main paths' bf16 shapes with CUDA events, in turns (forward,
then backward through the names), each launch straight through the C
interface (no Python wrapper). Every variant's output is held against the
plain PyTorch version (forward: bf16 atol 1.6e-2; backward: atol 8e-3 +
rtol 1e-2). Prints one JSON object as its last line and writes it to
``chiprun_out/variants_torch_attention.json`` (``--bwd``:
``variants_torch_attention_bwd.json``). Imports nothing of JAX or of the
JAX package.
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
# the backward's fused route: the train step, a TP 4 rank, a pipeline
# microbatch of 3 rows
BWD_SHAPES = ((192, 129, 768, 12), (192, 129, 192, 3), (3, 129, 768, 12))
BF16_ATOL = 1.6e-2
BWD_BF16_TOL = dict(atol=8e-3, rtol=1e-2)


def build(variants: dict, name_cu: str = "attention_fwd", baseline: Path | None = None) -> dict:
    """→ {variant: (library path, nvcc's report)}; raises with nvcc's
    output if one fails. ``baseline``: a directory whose csrc/ is built as
    it is, as the variant ``baseline``."""
    from signal_tpu_torch.ops import _build

    running = {}
    sources = {name: (_build.CSRC_DIR, cuts) for name, cuts in variants.items()}
    if baseline is not None:
        sources["baseline"] = (baseline / "signal_tpu_torch" / "csrc", [])
    for name, (csrc, cuts) in sources.items():
        d = REPO / "build" / "variants_attention" / name
        d.mkdir(parents=True, exist_ok=True)
        for src in csrc.iterdir():
            text = src.read_text()
            if src.name == f"{name_cu}.cu":
                for old, new in cuts:
                    if old not in text:
                        raise SystemExit(f"{name}: {name_cu}.cu no longer holds {old!r}")
                    text = text.replace(old, new)
            (d / src.name).write_text(text)
        lib = d / f"lib{name_cu}.so"
        running[name] = (lib, subprocess.Popen(
            [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / f"{name_cu}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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


def ptxas(log: str, kernel: str = "onepass_kernel") -> dict:
    """The instances of ``kernel`` in nvcc's report: registers and spill
    bytes, by template arguments."""
    out, fn = {}, None
    for line in log.splitlines():
        hit = re.search(r"Function properties for (\w+)", line)
        if hit:
            inst = re.search(kernel + r"I((?:Li\d+E)+)E", hit.group(1))
            fn = "<" + ", ".join(re.findall(r"Li(\d+)E", inst.group(1))) + ">" if inst else None
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


def ms_of(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, calls: dict, row: dict, iters: int) -> None:
    """Time every call twice, forward then backward through the names."""
    names = list(calls)
    for turn in range(2):
        for name in (names if turn == 0 else names[::-1]):
            row.setdefault(name, []).append(ms_of(torch, calls[name], iters))


def time_forward(torch, fns, iters, bad) -> dict:
    import torch.nn.functional as F

    from signal_tpu_torch.ops.flash_attention import FWD_ROUTES, flash_attention_reference

    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in fns.values():
        lib.attention_fwd.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_float, p]
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
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
        in_turns(torch, calls, row, iters)
        rows[shape] = row
        print(f"[variants] {shape}: " + ", ".join(
            f"{n} {sum(row[n]) / 2:.4f} ms" for n in calls), flush=True)
    return rows


def time_backward(torch, fns, iters, bad) -> dict:
    from signal_tpu_torch.ops.flash_attention import BWD_ROUTES, flash_attention_bwd_reference

    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in fns.values():
        lib.attention_bwd.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, p]
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for B, L, D, H in BWD_SHAPES:
        q, k, v, g = (torch.randn(B, L, D, device="cuda", generator=gen).bfloat16()
                      for _ in "qkvg")
        grads = [torch.empty_like(q) for _ in range(3)]
        hd = D // H
        want = [t.float() for t in flash_attention_bwd_reference(q, k, v, g, H)]
        qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
        gh = g.view(B, L, H, hd).transpose(1, 2)
        calls = {"sdpa": lambda: torch.autograd.grad(o, (qh, kh, vh), gh, retain_graph=True)}
        for name, lib in fns.items():
            # the fused route: the same number in every tree that has one
            calls[name] = lambda lib=lib: lib.attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                *(t.data_ptr() for t in grads), None, BWD_ROUTES["fused"], B, H, L, L, hd,
                hd ** -0.5, stream)
        row, shape = {}, f"[{B}, {L}, {D}]"
        for name in fns:
            for t in grads:
                t.zero_()
            if calls[name]() != 0:
                raise SystemExit(f"{name} {shape}: launch failed")
            torch.cuda.synchronize()
            errs = [(a.float() - b).abs() for a, b in zip(grads, want)]
            row[f"{name}_max_abs_err"] = max(e.max().item() for e in errs)
            if not all(bool((e <= BWD_BF16_TOL["atol"] + BWD_BF16_TOL["rtol"] * b.abs()).all())
                       for e, b in zip(errs, want)):
                bad.append(f"{name} {shape}: max abs err {row[f'{name}_max_abs_err']}")
        in_turns(torch, calls, row, iters)
        rows[shape] = row
        print(f"[variants bwd] {shape}: " + ", ".join(
            f"{n} {sum(row[n]) / 2:.4f} ms" for n in calls), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="?", default=None,
                    help="the variants' JSON (default scripts/attention_{fwd,bwd}_variants.json)")
    ap.add_argument("--bwd", action="store_true", help="the backward's fused route")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="with --bwd: a tree whose fused route is timed beside the variants")
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    tag = "bwd" if args.bwd else "fwd"
    path = args.variants or str(REPO / f"scripts/attention_{tag}_variants.json")
    libs = build(json.loads(Path(path).read_text()), f"attention_{tag}",
                 args.baseline if args.bwd else None)
    fns = {name: ctypes.CDLL(str(lib)) for name, (lib, _) in libs.items()}
    bad = []
    rows = (time_backward if args.bwd else time_forward)(torch, fns, args.iters, bad)
    kernel = "fused_kernel" if args.bwd else "onepass_kernel"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "ptxas": {name: ptxas(log, kernel) for name, (_, log) in libs.items()},
              "ms_each_turn": rows,
              "ms": {s: {n: sum(t) / len(t) for n, t in r.items() if isinstance(t, list)}
                     for s, r in rows.items()}}
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "variants_torch_attention" + ("_bwd" if args.bwd else "")
    (out_dir / f"{name}.json").write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
