#!/usr/bin/env python3
"""Design variants of the attention kernels, timed against each other on
one NVIDIA GPU.

    python3 scripts/variants_torch_attention.py [scripts/attention_fwd_variants.json]
    python3 scripts/variants_torch_attention.py --bwd [scripts/attention_bwd_variants.json] \
        [--baseline DIR]
    python3 scripts/variants_torch_attention.py --fp32 [scripts/attention_fp32_variants.json] \
        [--baseline DIR ...] [--steps] [--tests]
    python3 scripts/variants_torch_attention.py --long [scripts/attention_fwd_long_variants.json] \
        [--baseline DIR]

The JSON file names each variant by a list of text cuts ``[old, new]`` of
``signal_tpu_torch/csrc/attention_fwd.cu`` (with ``--bwd``:
``attention_bwd.cu``; an empty list is the source as it is). The script
builds every variant with ``nvcc`` into ``build/variants_attention/``
(git-ignored; one ``nvcc`` per variant, all started together; a cut whose
text is missing fails the script) and reports each instance's registers
and spill bytes of the kernel under study. The forward: it times the
one-pass route of each variant, the first variant's long route (route 2,
which takes any length) at the same lengths and
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

``--fp32``: the fp32 routes of both kernels (the forward on the CUDA
cores, the backward in 3xTF32). A variant there is a dict of text cuts by
file (``attention_fwd.cu``, ``attention_bwd.cu``, ``mma_tf32.cuh``); each
variant, and each ``--baseline DIR``'s csrc as it is (named by DIR's last
part; the option repeats), builds both libraries. It times each one's fp32
forward and backward (route 0) at the main paths' fp32 shapes beside
SDPA's fp32 forward and backward, each held to the plain version (forward
atol 2e-5 + rtol 1e-4, backward atol 1e-4 + rtol 1e-4), says whether each
forward gives the same bits as each baseline's, and takes every output's
max abs error against an fp64 computation, and the plain fp32 version's,
at the main shapes, at hd 128 and (backward) over 1000 queries.
``--steps`` adds the fp32 flagship (configs/RGBNT201/Signal.yml, random
weights) with the source's and each baseline's libraries: the eval
forward's ms a batch of 128 (CUDA events) and the train step's device ms
at B = 64 (``torch.profiler``), in turns. ``--tests`` runs the whole-step
fp32 card tests (``tests/test_torch_cuda.py``) with each variant's
kernels, and with each baseline's forward or backward beside the source's
other direction. Writes ``chiprun_out/variants_torch_attention_fp32.json``.

``--long``: the bf16 forward's route past 256 keys (route 2,
``attention_fwd_long_kernel``). Its variants are text cuts of
``attention_fwd.cu``, as the forward's; each is timed in turns beside
``--baseline DIR``'s route 2 (an earlier tree's kernel there) and SDPA at a
384×128 input's STRIDE_SIZE 12 shape ``[192, 311, 768]``, SIM-style cross
attention ``[128, 3, 384]`` (8 heads of 64) and 1024 keys at hd 64 and 128,
each held to the plain version (bf16 atol 1.6e-2) and launched twice for
the same bits. A shape whose route needs more shared memory than the card
allows a block (the parent's kernel past about 780 keys) is reported as
not taken. Writes ``chiprun_out/variants_torch_attention_long.json``.
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
# the forward's route past 256 keys (B, Lq, Lk, D, H): a 384×128 input at
# STRIDE_SIZE 12 (311 tokens), SIM-style cross attention, 1024 keys at hd 64
# and 128
LONG_SHAPES = ((192, 311, 311, 768, 12), (128, 3, 384, 512, 8), (16, 1024, 1024, 768, 12),
               (16, 1024, 1024, 1024, 8))
BF16_ATOL = 1.6e-2
BWD_BF16_TOL = dict(atol=8e-3, rtol=1e-2)
# fp32: the eval forward, a TP 2 rank at STRIDE_SIZE 12's 211 and a
# pipeline stage there, CLIP-ReID's eval; the train step's backward, its TP
# 2 and 4 ranks, a pipeline stage, TP 2 and 4 ranks at 211
FP32_SHAPES = ((384, 129, 768, 12), (192, 211, 384, 6), (12, 211, 768, 12), (128, 129, 768, 12))
FP32_BWD_SHAPES = ((192, 129, 768, 12), (192, 129, 384, 6), (192, 129, 192, 3), (12, 129, 768, 12),
                   (192, 211, 384, 6), (192, 211, 192, 3))
# fp32 errors against fp64: the first shape of each list above, a head dim
# of 128, and (backward) 211 and 1000 queries, whose sums over the queries
# are the longest
FP64_FWD_SHAPES = (FP32_SHAPES[0], (96, 129, 768, 6))
FP64_BWD_SHAPES = (FP32_BWD_SHAPES[0], (192, 211, 384, 6), (96, 129, 768, 6), (2, 1000, 128, 2),
                   (2, 1000, 256, 2))
FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BWD_FP32_TOL = dict(atol=1e-4, rtol=1e-4)


def build(variants: dict, name_cu: str = "attention_fwd", baselines: dict | None = None) -> dict:
    """→ {variant: (library path, nvcc's report)}; raises with nvcc's
    output if one fails. A variant's cuts apply to ``name_cu``.cu, or by
    file where they are a dict. ``baselines``: {name: a directory whose
    csrc/ is built as it is, as the variant of that name}."""
    from signal_tpu_torch.ops import _build

    running = {}
    sources = {name: (_build.CSRC_DIR, cuts) for name, cuts in variants.items()}
    for name, tree in (baselines or {}).items():
        sources[name] = (tree / "signal_tpu_torch" / "csrc", [])
    for name, (csrc, cuts) in sources.items():
        by_file = cuts if isinstance(cuts, dict) else {f"{name_cu}.cu": cuts}
        d = REPO / "build" / "variants_attention" / name_cu / name
        d.mkdir(parents=True, exist_ok=True)
        for src in csrc.iterdir():
            text = src.read_text()
            for old, new in by_file.get(src.name, []):
                if old not in text:
                    raise SystemExit(f"{name}: {src.name} no longer holds {old!r}")
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
    """The instances of ``kernel`` (a regular expression) in nvcc's report:
    registers and spill bytes, by template arguments (and by kernel, where
    the expression names more than one)."""
    out, fn = {}, None
    for line in log.splitlines():
        hit = re.search(r"Function properties for (\w+)", line)
        if hit:
            inst = re.search("(" + kernel + r")I((?:L[ib]\d+E)+)E", hit.group(1))
            fn = None
            if inst:
                args = "<" + ", ".join(re.findall(r"L[ib](\d+)E", inst.group(2))) + ">"
                fn = args if inst.group(1) == kernel else inst.group(1) + args
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
                 # the first variant's long route at these lengths
                 "long_route": lambda: as_built.attention_fwd(
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


def time_long(torch, fns, iters, bad) -> dict:
    """Route 2 of each library beside SDPA at LONG_SHAPES: each held to the
    plain version and launched twice for the same bits, then timed in
    turns; a library whose route needs more shared memory than the card
    allows at a shape is not taken there."""
    import torch.nn.functional as F

    from signal_tpu_torch.ops.flash_attention import FWD_ROUTES, flash_attention_reference

    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in fns.values():
        lib.attention_fwd.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_float, p]
        lib.attention_fwd_smem_bytes.argtypes = [i] * 4
        lib.attention_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.attention_fwd_smem_limit.argtypes = [i]
    stream = torch.cuda.current_stream().cuda_stream
    route = FWD_ROUTES["long"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for B, Lq, Lk, D, H in LONG_SHAPES:
        q = torch.randn(B, Lq, D, device="cuda", generator=gen).bfloat16()
        k, v = (torch.randn(B, Lk, D, device="cuda", generator=gen).bfloat16() for _ in "kv")
        o, again = torch.empty_like(q), torch.empty_like(q)
        hd = D // H
        want = flash_attention_reference(q, k, v, H).float()
        qh = q.view(B, Lq, H, hd).transpose(1, 2)
        kh, vh = (t.view(B, Lk, H, hd).transpose(1, 2) for t in (k, v))
        calls = {"sdpa": lambda: F.scaled_dot_product_attention(qh, kh, vh)}
        row, shape = {}, f"[{B}, {Lq}, {Lk}, {D}]"
        for name, lib in fns.items():
            if lib.attention_fwd_smem_bytes(route, Lq, Lk, hd) > lib.attention_fwd_smem_limit(0):
                row[f"{name}_taken"] = False
                continue
            launch = (lambda out, lib=lib: lib.attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), route, B, H, Lq, Lk,
                hd, hd ** -0.5, stream))
            if launch(o) != 0 or launch(again) != 0:
                raise SystemExit(f"{name} {shape}: launch failed")
            torch.cuda.synchronize()
            err = (o.float() - want).abs().max().item()
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_same_bits"] = bool(torch.equal(o, again))
            if not (err <= BF16_ATOL and row[f"{name}_same_bits"]):
                bad.append(f"{name} {shape}: max abs err {err}, same bits "
                           f"{row[f'{name}_same_bits']}")
            calls[name] = lambda launch=launch: launch(o)
        in_turns(torch, calls, row, iters)
        rows[shape] = row
        print(f"[variants long] {shape}: " + ", ".join(
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


def fp64_errors(torch, fwd, bwd) -> dict:
    """Every output's max abs error against fp64 at FP64_FWD_SHAPES and
    FP64_BWD_SHAPES, each library's and the plain fp32 version's."""
    from signal_tpu_torch.ops.flash_attention import (
        attention64,
        attention_bwd64,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for B, L, D, H in FP64_FWD_SHAPES:
        q, k, v = (torch.randn(B, L, D, device="cuda", generator=gen) for _ in "qkv")
        o, hd = torch.empty_like(q), D // H
        ref = attention64(q, k, v, H)
        row = {"plain": (flash_attention_reference(q, k, v, H).double() - ref).abs().max().item()}
        for name, lib in fwd.items():
            if lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0, B, H,
                                 L, L, hd, hd ** -0.5, stream):
                row[name] = None  # a shape this tree's kernel does not take
                continue
            torch.cuda.synchronize()
            row[name] = (o.double() - ref).abs().max().item()
        out[f"fwd [{B}, {L}, {D}] hd {hd}"] = row
    for B, L, D, H in FP64_BWD_SHAPES:
        q, k, v, g = (torch.randn(B, L, D, device="cuda", generator=gen) for _ in "qkvg")
        grads = [torch.empty_like(q) for _ in range(3)]
        stats = torch.empty(4 * B * H * ((L + 15) // 16 * 16), device="cuda")
        hd = D // H
        ref = attention_bwd64(q, k, v, g, H)
        row = {"plain": [(a.double() - b).abs().max().item()
                         for a, b in zip(flash_attention_bwd_reference(q, k, v, g, H), ref)]}
        for name, lib in bwd.items():
            if lib.attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                                 *(t.data_ptr() for t in grads), stats.data_ptr(), 0, B, H, L, L,
                                 hd, hd ** -0.5, stream):
                row[name] = None  # a shape this tree's kernels do not take
                continue
            torch.cuda.synchronize()
            row[name] = [(a.double() - b).abs().max().item() for a, b in zip(grads, ref)]
        out[f"bwd [{B}, {L}, {D}] hd {hd}"] = row
        print(f"[variants fp32 fp64] bwd [{B}, {L}, {D}] hd {hd}: " + ", ".join(
            f"{n} " + ("-" if r is None else "/".join(f"{e / p:.2f}" for e, p in zip(
                r, row["plain"]))) + "x" for n, r in row.items() if n != "plain"), flush=True)
    return out


def time_fp32(torch, fwd, bwd, iters, bad, baselines=()) -> dict:
    """The fp32 route (0) of each library pair, forward and backward,
    beside SDPA's fp32 forward and backward; whether each forward gives the
    same bits as each of ``baselines``'."""
    import torch.nn.functional as F

    from signal_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in fwd.values():
        lib.attention_fwd.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_float, p]
    for lib in bwd.values():
        lib.attention_bwd.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, p]
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for B, L, D, H in FP32_SHAPES:
        q, k, v = (torch.randn(B, L, D, device="cuda", generator=gen) for _ in "qkv")
        o = torch.empty_like(q)
        hd = D // H
        want = flash_attention_reference(q, k, v, H)
        qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
        calls = {"sdpa": lambda: F.scaled_dot_product_attention(qh, kh, vh)}
        for name, lib in fwd.items():
            calls[name] = lambda lib=lib: lib.attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0, B, H, L, L, hd,
                hd ** -0.5, stream)
        row, shape, outs = {}, f"fwd [{B}, {L}, {D}]", {}
        for name in fwd:
            if calls[name]() != 0:
                raise SystemExit(f"{name} {shape}: launch failed")
            torch.cuda.synchronize()
            outs[name] = o.clone()
            err = (o - want).abs()
            row[f"{name}_max_abs_err"] = err.max().item()
            if not bool((err <= FP32_TOL["atol"] + FP32_TOL["rtol"] * want.abs()).all()):
                bad.append(f"{name} {shape}: max abs err {err.max().item()}")
        for ref in baselines:
            for name in fwd:
                if name != ref:
                    row[f"{name}_same_bits_as_{ref}"] = bool(torch.equal(outs[name], outs[ref]))
        in_turns(torch, calls, row, iters)
        rows[shape] = row
        print(f"[variants fp32] {shape}: " + ", ".join(
            f"{n} {sum(row[n]) / 2:.4f} ms" for n in calls) + "; same bits: " + ", ".join(
            f"{k[:-len('_same_bits_as_') - len(r)]} as {r} {row[k]}" for r in baselines
            for k in row if k.endswith(f"_same_bits_as_{r}")), flush=True)
    for B, L, D, H in FP32_BWD_SHAPES:
        q, k, v, g = (torch.randn(B, L, D, device="cuda", generator=gen) for _ in "qkvg")
        grads = [torch.empty_like(q) for _ in range(3)]
        # the larger of the two trees' scratch: 4 floats a row, rows to 16
        stats = torch.empty(4 * B * H * ((L + 15) // 16 * 16), device="cuda")
        hd = D // H
        want = flash_attention_bwd_reference(q, k, v, g, H)
        qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh)
        gh = g.view(B, L, H, hd).transpose(1, 2)
        calls = {"sdpa": lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True)}
        for name, lib in bwd.items():
            calls[name] = lambda lib=lib: lib.attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                *(t.data_ptr() for t in grads), stats.data_ptr(), 0, B, H, L, L, hd, hd ** -0.5,
                stream)
        row, shape = {}, f"bwd [{B}, {L}, {D}]"
        for name in bwd:
            if calls[name]() != 0:
                raise SystemExit(f"{name} {shape}: launch failed")
            torch.cuda.synchronize()
            errs = [(a - b).abs() for a, b in zip(grads, want)]
            row[f"{name}_max_abs_err"] = max(e.max().item() for e in errs)
            if not all(bool((e <= BWD_FP32_TOL["atol"] + BWD_FP32_TOL["rtol"] * b.abs()).all())
                       for e, b in zip(errs, want)):
                bad.append(f"{name} {shape}: max abs err {row[f'{name}_max_abs_err']}")
        in_turns(torch, calls, row, max(iters // 2, 5))
        rows[shape] = row
        print(f"[variants fp32] {shape}: " + ", ".join(
            f"{n} {sum(row[n]) / 2:.4f} ms" for n in calls), flush=True)
    return rows


def time_fp32_steps(torch, pairs: dict) -> dict:
    """The fp32 flagship with each library pair ({name: (fwd, bwd)}): the
    eval forward's ms a batch of 128 (CUDA events) and the train step's
    device ms at B = 64 (``torch.profiler``), in turns (a, b, b, a)."""
    import dataclasses

    from torch.autograd import DeviceType

    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data.augment import normalize_images
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops import _build
    from signal_tpu_torch.ops import flash_attention as fa
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"))
    C, K = 171, cfg.DATALOADER.NUM_INSTANCE
    spec = dataclasses.replace(sm.ModelSpec.from_config(cfg, num_classes=C, camera_num=4),
                               compute_dtype="float32")
    model = sm.init_signal(spec, seed=0).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    u8 = torch.randint(0, 256, (128, 3, 3, 256, 128), dtype=torch.uint8, device="cuda",
                       generator=gen)
    cams = torch.randint(0, 4, (128,), device="cuda", generator=gen)
    imgs = normalize_images(u8, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
    B = cfg.SOLVER.IMS_PER_BATCH
    pids = torch.randperm(C, device="cuda", generator=gen)[:B // K].repeat_interleave(K)
    optimizer = make_optimizer(model, cfg)
    set_lr(optimizer, *schedule_coeffs(cfg, 1))
    step = make_train_step(model, cfg, C, optimizer, device_augment=True,
                           gen=torch.Generator(device="cuda").manual_seed(4))
    load = _build.load

    def use(name):
        fa._libs.clear()
        _build.load = lambda n: pairs[name][0 if n == "attention_fwd" else 1]

    def eval_ms():
        with torch.inference_mode():
            return ms_of(torch, lambda: sm.forward_eval(model, imgs, cams), 5)

    def step_ms():
        for _ in range(2):
            step(u8[:B], pids, cams[:B])
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(2):
                step(u8[:B], pids, cams[:B])
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("Optimizer.")) / 1e3 / 2

    out = {}
    names = list(pairs)
    try:
        for turn in range(2):
            for name in (names if turn == 0 else names[::-1]):
                use(name)
                row = out.setdefault(name, {"eval_ms_b128": [], "train_device_ms_b64": []})
                row["eval_ms_b128"].append(eval_ms())
                row["train_device_ms_b64"].append(step_ms())
                print(f"[variants fp32 steps] {name}: eval {row['eval_ms_b128'][-1]:.2f} ms, "
                      f"train device {row['train_device_ms_b64'][-1]:.2f} ms", flush=True)
    finally:
        _build.load = load
        fa._libs.clear()
    return out


def run_step_tests(pairs: dict) -> dict:
    """The whole-step fp32 card tests (``tests/test_torch_cuda.py``'s
    ``test_variant_train_step_goes_through_both_kernels``: a small variant
    tower's kernel path against its plain-attention path) with each pair
    of libraries ({name: (forward, backward)}) → {name: passed and
    failed}."""
    import pytest

    from signal_tpu_torch.ops import _build
    from signal_tpu_torch.ops import flash_attention as fa

    class Count:
        def __init__(self):
            self.passed, self.failed = [], []

        def pytest_runtest_logreport(self, report):
            if report.when == "call":
                (self.passed if report.passed else self.failed).append(report.nodeid.split("[")[-1])

    load, out = _build.load, {}
    try:
        for name, (fwd, bwd) in pairs.items():
            fa._libs.clear()
            _build.load = lambda n, f=fwd, b=bwd: f if n == "attention_fwd" else b
            count = Count()
            pytest.main([str(REPO / "tests/test_torch_cuda.py"), "-m", "cuda", "-q", "--noconftest",
                         "-p", "no:cacheprovider", "-k", "variant_train_step", "--tb=no"],
                        plugins=[count])
            out[name] = {"passed": len(count.passed), "failed": sorted(count.failed)}
            print(f"[variants fp32 tests] {name}: {out[name]}", flush=True)
    finally:
        _build.load = load
        fa._libs.clear()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="?", default=None,
                    help="the variants' JSON (default scripts/attention_{fwd,bwd}_variants.json)")
    ap.add_argument("--bwd", action="store_true", help="the backward's fused route")
    ap.add_argument("--fp32", action="store_true", help="the fp32 routes of both kernels")
    ap.add_argument("--long", action="store_true",
                    help="the bf16 forward's route past 256 keys")
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="with --bwd, --long or --fp32: a tree whose kernels are timed "
                         "beside the variants (--fp32: repeatable)")
    ap.add_argument("--steps", action="store_true",
                    help="with --fp32: the fp32 flagship eval forward and train step too")
    ap.add_argument("--tests", action="store_true",
                    help="with --fp32: the whole-step fp32 card tests with each variant's "
                         "kernels, and with the baseline's in either direction")
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    tag = "fp32" if args.fp32 else "bwd" if args.bwd else "long" if args.long else "fwd"
    default = "fwd_long" if args.long else tag
    path = args.variants or str(REPO / f"scripts/attention_{default}_variants.json")
    variants = json.loads(Path(path).read_text())
    bad = []
    baselines = {tree.name: tree for tree in args.baseline}
    if args.fp32:
        libs = build(variants, "attention_fwd", baselines)
        libs_bwd = build(variants, "attention_bwd", baselines)
        fwd = {name: ctypes.CDLL(str(lib)) for name, (lib, _) in libs.items()}
        bwd = {name: ctypes.CDLL(str(lib)) for name, (lib, _) in libs_bwd.items()}
        rows = time_fp32(torch, fwd, bwd, args.iters, bad, tuple(baselines))
        errors64 = fp64_errors(torch, fwd, bwd)
        kernel = "(?:fwd_fp32|fwd_tf32|rows_tf32|cols_tf32)_kernel"
        ptx = {name: {**ptxas(libs[name][1], kernel), **ptxas(libs_bwd[name][1], kernel)}
               for name in libs}
    else:
        if len(baselines) > 1 or baselines and not (args.bwd or args.long):
            raise SystemExit("--baseline: once, and with --bwd, --long or --fp32 only")
        libs = build(variants, "attention_bwd" if args.bwd else "attention_fwd",
                     {"baseline": args.baseline[0]} if baselines else None)
        fns = {name: ctypes.CDLL(str(lib)) for name, (lib, _) in libs.items()}
        timer = time_backward if args.bwd else time_long if args.long else time_forward
        rows = timer(torch, fns, args.iters, bad)
        kernel = ("fused_kernel" if args.bwd else "fwd_long_kernel" if args.long
                  else "onepass_kernel")
        ptx = {name: ptxas(log, kernel) for name, (_, log) in libs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": ptx,
              "ms_each_turn": rows,
              "ms": {s: {n: sum(t) / len(t) for n, t in r.items() if isinstance(t, list)}
                     for s, r in rows.items()}}
    if args.fp32:
        result["max_abs_err_fp64"] = errors64
    if args.fp32 and args.tests:
        pairs = {name: (fwd[name], bwd[name]) for name in fwd}
        for name in baselines:
            pairs[f"{name}_forward"] = (fwd[name], bwd["as_built"])
            pairs[f"{name}_backward"] = (fwd["as_built"], bwd[name])
        result["step_tests"] = run_step_tests(pairs)
    if args.fp32 and args.steps:
        pairs = {name: (fwd[name], bwd[name]) for name in fwd
                 if name == "as_built" or name in baselines}
        steps = time_fp32_steps(torch, pairs)
        result["steps"] = {name: {k: sum(v) / len(v) for k, v in row.items()}
                           for name, row in steps.items()}
        result["steps_each_turn"] = steps
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "variants_torch_attention" + ("" if tag == "fwd" else f"_{tag}")
    (out_dir / f"{name}.json").write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
