#!/usr/bin/env python3
"""Drive the PyTorch port (signal_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card, nvcc

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port from ``signal_tpu_torch/csrc``,
     one nvcc per source, all started together; each kernel's registers,
     spill bytes and tensor-core instructions (HMMA in ``cuobjdump -sass``;
     a bf16 kernel without them fails);
  3. kernels vs plain: each kernel's wrapper (attention forward and
     backward) against its plain PyTorch version on the card, at the main
     paths' shapes, at odd ones and at every tile edge of the bf16 kernels
     (the backward's long route past 160 tokens included, with its own
     edges: a ring chunk of 32 queries, a cluster's block of 256 keys, its
     longest 1024), with the tolerance stated; two launches of the long
     route at [192, 211, 768] equal to the bit; kernel, plain and library
     times (CUDA events) and the achieved TFLOP/s, also at the variants'
     lengths (141, 193, 211, 223 forward; 193 and 211 backward) and at
     deit_small's D = 384 with 6 heads ([384, 129, 384] and [192, 129,
     384] forward, [192, 129, 384] backward);
  4. eval slice: ``forward_eval`` of the flagship RGBNT201 model (CLIP
     ViT-B/16, width 768, 12 heads, 256×128, SIE, SIM TOPK 80; random
     weights from a seed) on B=128 random packed uint8 images, kernel path
     against the plain-attention path (fp32 features; bf16 ViT-output
     cosines and SIM mask agreement), 12 kernel launches per forward,
     ms/batch;
  5. eval end to end: ``signal_tpu_torch.cli.test_main`` on
     configs/synthetic/smoke.yml at full width → mAP/CMC;
  6. train slice: the flagship train step (GAM + LAM, Adam, IMS_PER_BATCH
     64, remat) on random packed uint8 images and P×K labels: the kernel
     path against the plain-attention path (fp32 loss and every gradient;
     bf16 loss), and in bf16 per-tensor gradient cosines of the backward
     kernel against its plain version in the step and of both kernels
     through the ViT tower; 24 forward and 12 backward kernel launches per
     step, ms/step, samples/s, peak memory;
  7. train end to end: ``signal_tpu_torch.cli.train_main`` on
     configs/synthetic/smoke.yml at full width, two epochs and an eval →
     finite loss and mAP;
  8. the paper's recipe end to end: a seeded fp16 TorchScript archive laid
     out as CLIP's ``ViT-B-16.pt`` (published shapes) imported through
     MODEL.PRETRAIN_PATH_CLIP (the tower equals the archive, the pos embed
     resized 14×14 → 16×8), then ``train_main`` with ACCUM_ITER 2, center
     loss, REMAT_POLICY attn and re-ranking → finite loss and mAP; then a
     real SIGTERM at the first step, the preemption checkpoint, and a
     ``--resume`` of it to MAX_EPOCHS;
  9. accumulation at full width: the flagship config in fp32 (SGD, center
     loss), one step at ACCUM_ITER 2 on [h; h] (B = 64) against one at 1
     on h (B = 32): loss, gradients, parameters, centres; (48, 24) launches;
 10. REMAT policies: the flagship bf16 step at B = 64 under full, dots,
     attn, attn_mlp, half and without remat: ms/step, peak memory and
     launches per step; gradients against 'full' in fp32 and bf16;
 11. re-ranking on the card: N = 5,000 (1,000 query + 4,000 gallery, width
     3072) for time and memory; N = 320 against the CPU;
 12. serving: the flagship model (bf16, random weights from SOLVER.SEED)
     exported with ``torch.export`` with uint8 input, at a fixed batch of
     128 and at a symbolic batch, both on the card (the attention kernel in
     the graph as its registered operator, 12 launches a batch), saved,
     loaded and run against eager ``forward_eval`` (per-row cosine >
     0.9999): the fixed one at B = 128, the symbolic one at B = 2, 8 and
     128; both timed against eager in turns at B = 128; artifact bytes;
 13. host data: cores and libjpeg on this host; a seeded RGBNT201-shaped
     tree of 1,024 + 1,024 JPEG triplets (256×128); the val loader (B 128)
     and the device-augment train loader (PK 8×8, bicubic) per decoder the
     host has, at the config's thread count and at the core count, in host
     samples/s; the fed paths end to end (loader → prefetch → copy →
     phase 12's artifact; → the train step) beside the device-only figures,
     and the share of time the card waits on the host;
 14. the CLIP tower's variants at the flagship widths (random weights from
     SOLVER.SEED): ADAPTER, PROMPT, PROMPT + ADAPTER, FROZEN (LoRA r 8),
     MOE_EXPERTS 4 at MOE_TOPK 1 and 2 (capacity 1.25), and STRIDE_SIZE 12
     (211 tokens: the backward's long route): ``forward_eval`` at B = 128
     and one train step at B = 64, kernel path against plain path as
     phases 4 and 6; launches per eval forward, train forward and backward
     (12 / 24 / 12, the prompted towers 36 / 72 / 36), ms per step by the
     host clock and device time, peak memory (no MFU: ``utils/flops``
     counts the plain tower);
 15. the other backbones at full width (random weights from SOLVER.SEED;
     the flagship config but MODEL.TRANSFORMER_TYPE): vit_base_patch16_224
     at STRIDE_SIZE 16 (129 tokens) and 12 (211), deit_small_patch16_224,
     vit_small_patch16_224, t2t_vit_t_14, resnet50, osnet_x1_0:
     ``forward_eval`` at B = 128 and one train step at B = 64 (bf16, device
     augment, Adam, DROP_PATH 0.1), where the blocks take the kernels their
     kernel path against the plain path as phases 4 and 6 (fp32 at DROP_PATH
     0); launches per eval forward, train forward and backward asserted
     (12 / 24 / 12, the long route's 12 at 211 tokens, 0 for vit_small's qk
     scale, T2T and the CNNs, as in JAX), ms by the host clock and device
     time, peak memory, MFU, and the CNN trunks' running statistics (moved
     by the step, not by eval); then ``train_main`` and ``test_main`` on
     the synthetic config with vit_base_patch16_224 and resnet50;
 16. CLIP-ReID at full width (random weights from SOLVER.SEED, bf16, the
     flagship config's 256×128 input and SIE, RGBNT201's 171 classes; CLIP
     ViT-B/16 and its text tower 512 × 12 × 8 heads over 77 positions and
     49,408 tokens; the tokenizer on the port's vocabulary):
     ``clipreid_forward_eval`` at B = 128 with NECK_FEAT before and after,
     and one train step at B = 64 (P×K 8 × 8; cross entropy on both
     scores, triplet on the three features, image-to-text cross entropy
     against the 171 classes' text features, SupCon both ways; Adam), the
     kernel path against the plain path as phases 4 and 6; launches (12 a
     forward, 24 + 12 a step), ms by the host clock and device time, peak
     memory, eval MFU; the text features of all classes (ms, finite,
     causal in fp32); the metric-loss zoo on the card against the CPU
     (fp32, B = 64, D 768 and 512, C 171, values and input gradients); a
     seeded CLIP archive with both halves at their published shapes
     imported through ``load_clip_into_clipreid``. The kernels of phase 3
     also run at its shapes ([128, 129, 768] forward, [64, 129, 768]
     forward and backward, bf16 and fp32).
Phases 4, 6 and 15 also print MFU: the analytic model FLOPs
(``utils/flops.py``) over the measured time and the card's bf16 peak.
Phases 5, 7, 8, 12, 14, 15 and 16 are the main paths: every launch count
is zeroed just before each and read just after. Then the script prints the kernel table
as one JSON line, and as its last line ``{"ok": true, "device": {...}}``.
Details go to chiprun_out/chip_smoke.json. It imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

FP32_TOL = dict(atol=2e-5, rtol=1e-4)   # summation order only
BF16_ATOL = 1.6e-2                      # one bf16 ulp of |o| < 4 (2^-6)
# the backward on randn q, k, v, g (hd 64, scale 1/8): dq, dk, dv are ~0.15
# and peak at 2-3 (each row records max |want|). fp32: summation order
# only. bf16: dS is rounded to bf16 before dQ/dK and every output is bf16,
# so a different fp32 order may tip a value across a rounding boundary:
# two bf16 ulps of |x| < 1 (2 · 2^-8) absolute, and rtol 1e-2 (one ulp is
# 2^-8 to 2^-7 of the value) above that
BWD_FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BWD_BF16_TOL = dict(atol=8e-3, rtol=1e-2)


def log(msg: str) -> None:
    print(msg, flush=True)


# the bf16 kernels pad rows and the head dim to multiples of 16: every
# length at or next to a tile edge, at head dims 8 and 24 (a zero-padded
# contraction), 64 and 128; cross attention both ways (B = 2, 2 heads)
EDGE_LENGTHS = [(n, n) for n in (1, 15, 16, 17, 129, 145)] + [
    (1, 145), (145, 1), (17, 129), (129, 16), (15, 17)]
EDGES = [(f"edge-{lq}x{lk}-hd{hd}", 2, lq, lk, 2 * hd, 2)
         for hd in (8, 24, 64, 128) for lq, lk in EDGE_LENGTHS]
# past 160 tokens the bf16 backward takes its long route (a statistics
# kernel, then a key-parallel kernel that streams the queries in chunks of
# 32): lengths across its 16-row tiles and chunks, the train shapes of
# STRIDE_SIZE 12 (211) and a 384×128 input (193), one past a block of 256
# keys (257: a cluster of two; 128 keys a block at hd 128), its longest
# (1024), and cross attention both ways, at head dims 64 and 128
LONG_EDGES = [(f"edge-{lq}x{lk}-hd{hd}", 2, lq, lk, 2 * hd, 2) for hd in (64, 128)
              for lq, lk in [(n, n) for n in (161, 176, 193, 211, 223, 225, 256, 257, 1024)]
              + [(211, 129), (129, 211), (1024, 17), (17, 1024)]]
# the forward at the variants' lengths: the prompted blocks' 141, and 193,
# 211 and 223 (the second pass over keys)
LONG_LENGTHS = (141, 193, 211, 223)


def clipreid_cases(torch, kinds=("eval", "train")):
    """CLIP-ReID's attention shapes (phase 16): one modality, eval at
    TEST.IMS_PER_BATCH 128 and train at IMS_PER_BATCH 64, bf16 and fp32;
    (name, B, Lq, Lk, D, H, dtype)."""
    return [(f"clipreid-{kind}-{tag}", b, 129, 129, 768, 12, dt)
            for kind, b in (("eval", 128), ("train", 64)) if kind in kinds
            for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32))]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def mfu(torch, spec, batch: int, ms: float, train: bool = False) -> dict:
    """The analytic model FLOPs of one eval forward (or train step) of
    ``batch`` over ``ms``, against the card's published bf16 peak."""
    from signal_tpu_torch.utils.flops import peak_flops_per_chip, signal_analytic_flops

    flops = signal_analytic_flops(spec, batch, train=train)
    rate = flops / (ms / 1e3)
    return {"analytic_tflop": flops / 1e12, "model_tflops": rate / 1e12,
            "mfu": rate / peak_flops_per_chip(torch.cuda.get_device_name(0))}


def time_train_steps(torch, step, batch, n: int = 5):
    """One warm-up step, then ``n`` timed ones (host clock around
    synchronised steps) → {ms_per_step, peak_memory_gib, forward and
    backward kernel launches per step, losses}."""
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda

    step(*batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention_fwd_cuda.launches = attention_bwd_cuda.launches = 0
    attention_bwd_cuda.launches_long = 0
    t0 = time.perf_counter()
    losses = [step(*batch)[0] for _ in range(n)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    return {"ms_per_step": ms, "samples_per_s": batch[1].shape[0] / ms * 1e3,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "attention_fwd_launches_per_step": attention_fwd_cuda.launches / n,
            "attention_bwd_launches_per_step": attention_bwd_cuda.launches / n,
            "attention_bwd_long_launches_per_step": attention_bwd_cuda.launches_long / n,
            "losses": [x.item() for x in losses]}


def device_busy_ms(torch, step, batch, n: int = 2) -> float:
    """Device time of one step: the kernels' own time summed under
    ``torch.profiler`` over ``n`` steps, / n. Unlike the host clock it does
    not count the time the device waits for the host."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step(*batch)
        torch.cuda.synchronize()
    # device events only; the optimizer's step annotation spans its kernels
    # on the device timeline and would count them twice
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")) / 1e3 / n


def in_turns(torch, steps: dict, batch, rounds: int = 3):
    """Time each of ``steps`` (name → train step) in turns, forward then
    backward through the names, ``rounds`` times (a, b, b, a: drift on the
    card and load on the host fall on all alike) → {name: the timing of its
    fastest window, with every window's ms, and its device busy time}."""
    out = {}
    names = list(steps)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            row = time_train_steps(torch, steps[name], batch)
            if not all(math.isfinite(x) for x in row["losses"]):
                raise SystemExit(f"{name}: non-finite train loss {row['losses']}")
            best = out.get(name)
            windows = (best["ms_all"] if best else []) + [row["ms_per_step"]]
            if best is None or row["ms_per_step"] < best["ms_per_step"]:
                best = row
            out[name] = dict(best, ms_all=windows)
    for name, step in steps.items():
        out[name]["device_busy_ms_per_step"] = device_busy_ms(torch, step, batch)
    return out


def check_attention(torch, report, peaks):
    """Phase 3: the attention kernel against its plain version."""
    import torch.nn.functional as F

    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda, flash_attention_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (name, B, Lq, Lk, D, H, dtype)
        ("main-bf16", 384, 129, 129, 768, 12, torch.bfloat16),
        ("main-fp32", 384, 129, 129, 768, 12, torch.float32),
        ("train-bf16", 192, 129, 129, 768, 12, torch.bfloat16),
        ("cross-bf16", 128, 3, 384, 512, 8, torch.bfloat16),
        ("cross-fp32", 128, 3, 384, 512, 8, torch.float32),
        ("odd-bf16", 16, 9, 9, 384, 6, torch.bfloat16),
        ("odd-fp32", 16, 9, 9, 384, 6, torch.float32),
        ("long-hd128-bf16", 8, 17, 300, 256, 2, torch.bfloat16),   # two passes over keys
        # deit_small's eval and train shapes: D = 384, 6 heads of 64
        ("d384-eval-bf16", 384, 129, 129, 384, 6, torch.bfloat16),
        ("d384-train-bf16", 192, 129, 129, 384, 6, torch.bfloat16),
    ] + clipreid_cases(torch) + [
        (f"len{L}-bf16", 192, L, L, 768, 12, torch.bfloat16) for L in LONG_LENGTHS] + [
        (*edge, torch.bfloat16) for edge in EDGES]
    rows = {}
    for name, B, Lq, Lk, D, H, dt in cases:
        q = torch.randn(B, Lq, D, device="cuda", generator=gen).to(dt)
        k = torch.randn(B, Lk, D, device="cuda", generator=gen).to(dt)
        v = torch.randn(B, Lk, D, device="cuda", generator=gen).to(dt)
        got = attention_fwd_cuda(q, k, v, H)
        torch.cuda.synchronize()
        want = flash_attention_reference(q, k, v, H)
        err = (got.float() - want.float()).abs()
        if dt == torch.float32:
            tol = FP32_TOL["atol"] + FP32_TOL["rtol"] * want.float().abs()
            tol_text = "atol 2e-5 + rtol 1e-4"
        else:
            tol, tol_text = BF16_ATOL, f"atol {BF16_ATOL}"
        ok = bool((err <= tol).all())
        row = {"shape": [B, Lq, Lk, D, H], "dtype": str(dt).split(".")[1],
               "max_abs_err": err.max().item(), "tolerance": tol_text}
        if name.startswith(("main", "train", "len", "d384", "clipreid")):
            hd = D // H
            elt = q.element_size()
            nbytes = (2 * B * Lq * D + 2 * B * Lk * D) * elt      # q, k, v read; o written
            flops = 4 * B * H * Lq * Lk * hd                      # QKᵀ and P·V
            bw, bf16_peak, fp32_peak = peaks
            t_bytes = nbytes / bw * 1e3
            t_ops = flops / (bf16_peak if dt == torch.bfloat16 else fp32_peak) * 1e3
            qh, kh, vh = (t.view(t.shape[0], t.shape[1], H, hd).transpose(1, 2)
                          for t in (q, k, v))
            row.update(
                ms=cuda_ms(torch, lambda: attention_fwd_cuda(q, k, v, H)),
                plain_ms=cuda_ms(torch, lambda: flash_attention_reference(q, k, v, H), iters=5),
                library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh)),
                bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            row["tflops"] = flops / row["ms"] / 1e9
        rows[name] = row
        if not name.startswith("edge"):
            log(f"[kernel] attention_fwd {name}: {json.dumps(row)}")
        if not ok:
            raise SystemExit(f"attention_fwd {name} disagrees with its plain version: "
                             f"max abs err {row['max_abs_err']} ({tol_text})")
        del q, k, v, got, want, err
    log_edges("attention_fwd", rows)
    report["attention"] = rows
    return rows


def check_attention_bwd(torch, report, peaks):
    """Phase 3: the attention backward kernel against its plain version."""
    import torch.nn.functional as F

    from signal_tpu_torch.ops.flash_attention import (
        attention_bwd_cuda,
        flash_attention_bwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [  # (name, B, Lq, Lk, D, H, dtype): main = the train step's shape
        ("main-bf16", 192, 129, 129, 768, 12, torch.bfloat16),
        ("main-fp32", 192, 129, 129, 768, 12, torch.float32),
        ("cross-bf16", 128, 3, 129, 512, 8, torch.bfloat16),
        ("cross-fp32", 128, 40, 7, 512, 8, torch.float32),
        ("odd-bf16", 16, 9, 9, 384, 6, torch.bfloat16),
        ("odd-fp32", 16, 9, 9, 384, 6, torch.float32),
        ("longest-fused-bf16", 8, 160, 160, 256, 2, torch.bfloat16),  # the fused kernel's limit
        # the long route at the train shapes past 160 tokens: STRIDE_SIZE 12
        # (211 tokens) and a 384×128 input (193)
        ("long211-bf16", 192, 211, 211, 768, 12, torch.bfloat16),
        ("long193-bf16", 192, 193, 193, 768, 12, torch.bfloat16),
        # deit_small's train shape: D = 384, 6 heads of 64
        ("d384-train-bf16", 192, 129, 129, 384, 6, torch.bfloat16),
    ] + clipreid_cases(torch, ("train",)) + [
        (*edge, torch.bfloat16) for edge in EDGES + LONG_EDGES]
    rows = {}
    for name, B, Lq, Lk, D, H, dt in cases:
        q, g = (torch.randn(B, Lq, D, device="cuda", generator=gen).to(dt) for _ in "qg")
        k, v = (torch.randn(B, Lk, D, device="cuda", generator=gen).to(dt) for _ in "kv")
        got = attention_bwd_cuda(q, k, v, g, H)
        torch.cuda.synchronize()
        want = flash_attention_bwd_reference(q, k, v, g, H)
        tol = BWD_FP32_TOL if dt == torch.float32 else BWD_BF16_TOL
        tol_text = f"atol {tol['atol']} + rtol {tol['rtol']}"
        errs = [(a.float() - b.float()).abs() for a, b in zip(got, want)]
        ok = all(bool((e <= tol["atol"] + tol["rtol"] * b.float().abs()).all())
                 for e, b in zip(errs, want))
        row = {"shape": [B, Lq, Lk, D, H], "dtype": str(dt).split(".")[1],
               "max_abs_err": max(e.max().item() for e in errs),
               "max_abs_err_dq_dk_dv": [e.max().item() for e in errs],
               "max_abs_want_dq_dk_dv": [b.float().abs().max().item() for b in want],
               "tolerance": tol_text}
        if name.startswith(("main", "long", "d384", "clipreid")):
            hd = D // H
            elt = q.element_size()
            # q, g read and dq written (Lq); k, v read and dk, dv written (Lk)
            nbytes = (3 * B * Lq * D + 4 * B * Lk * D) * elt
            flops = 5 * 2 * B * H * Lq * Lk * hd                  # QKᵀ, dV, dP, dQ, dK
            bw, bf16_peak, fp32_peak = peaks
            t_bytes = nbytes / bw * 1e3
            t_ops = flops / (bf16_peak if dt == torch.bfloat16 else fp32_peak) * 1e3
            # the library yardstick: SDPA's backward alone on the same shapes
            qh, kh, vh = (t.view(B, t.shape[1], H, hd).transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qh, kh, vh)
            gh = g.view(B, Lq, H, hd).transpose(1, 2)
            row.update(
                ms=cuda_ms(torch, lambda: attention_bwd_cuda(q, k, v, g, H)),
                plain_ms=cuda_ms(torch, lambda: flash_attention_bwd_reference(q, k, v, g, H),
                                 iters=5),
                library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                    o, (qh, kh, vh), gh, retain_graph=True)),
                bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            row["tflops"] = flops / row["ms"] / 1e9
            del qh, kh, vh, o, gh
        if name == "long211-bf16":
            # the long route sums dQ over a head's key blocks in a fixed
            # order: a second launch gives the same bits
            again = attention_bwd_cuda(q, k, v, g, H)
            torch.cuda.synchronize()
            row["repeat_bit_identical"] = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
        rows[name] = row
        if not name.startswith("edge"):
            log(f"[kernel] attention_bwd {name}: {json.dumps(row)}")
        if not ok:
            raise SystemExit(f"attention_bwd {name} disagrees with its plain version: "
                             f"max abs err {row['max_abs_err']} ({tol_text})")
        if row.get("repeat_bit_identical") is False:
            raise SystemExit(f"attention_bwd {name}: two launches differ")
        del q, k, v, g, got, want, errs
    log_edges("attention_bwd", rows)
    report["attention_bwd"] = rows
    return rows


def log_edges(kernel: str, rows) -> None:
    """One line for the tile-edge cases (each row is in chip_smoke.json)."""
    edges = {n: r for n, r in rows.items() if n.startswith("edge")}
    worst = max(edges, key=lambda n: edges[n]["max_abs_err"])
    log(f"[kernel] {kernel} {len(edges)} tile-edge cases (bf16, {edges[worst]['tolerance']}) "
        f"pass; largest max abs err {edges[worst]['max_abs_err']} at {worst}")


def check_build(torch, report):
    """Phase 2: build every kernel; per kernel its registers, spill bytes
    and tensor-core instructions. → {library name: path}"""
    from signal_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build(["attention_fwd", "attention_bwd"])
    report["build_s"] = time.perf_counter() - t0
    kernels = {}
    for lib in libs:
        ptxas, hmma = _build.ptxas_report(lib), _build.hmma_counts(lib)
        for fn, short in zip(ptxas, demangle(list(ptxas))):
            row = dict(ptxas[fn], hmma=hmma.get(fn, 0))
            kernels[short] = row
            log(f"[build] {lib}: {short}: {row['registers']} registers, spill stores "
                f"{row['spill_stores']} B, spill loads {row['spill_loads']} B, "
                f"HMMA {row['hmma']}")
            if "mma_kernel" in short and row["hmma"] == 0:
                raise SystemExit(f"{short} has no tensor-core instruction")
    report["build"] = kernels
    log(f"[build] {sorted(libs)} in {report['build_s']:.1f} s")
    return libs


def demangle(names):
    """C++ names without the anonymous namespace and the argument list."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
    except (FileNotFoundError, subprocess.CalledProcessError):
        return names
    return [n.replace("(anonymous namespace)::", "").split("(")[0] for n in out]


def check_slice(torch, report):
    """Phase 4: flagship forward_eval, kernel path vs plain-attention path."""
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data.augment import normalize_images
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.models.sim import sim_forward
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"))
    B = 128  # TEST.IMS_PER_BATCH of the flagship config
    spec = sm.ModelSpec.from_config(cfg, num_classes=171, camera_num=4)
    assert (spec.width, spec.layers, spec.num_heads, spec.topk, spec.use_flash) == \
        (768, 12, 12, 80, True), spec
    model = sm.init_signal(spec, seed=0).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    u8 = torch.randint(0, 256, (B, 3, 3, 256, 128), dtype=torch.uint8, device="cuda",
                       generator=gen)
    cams = torch.randint(0, 4, (B,), device="cuda", generator=gen)
    imgs = normalize_images(u8, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
    out = {}

    def run(dtype: str, use_flash: bool):
        model.spec = dataclasses.replace(spec, compute_dtype=dtype, use_flash=use_flash)
        before = attention_fwd_cuda.launches
        with torch.inference_mode():
            patches, cls, _ = sm._encode(model, imgs, cams)
            fused, masks = sim_forward(model.SIM, patches, cls, k=spec.topk,
                                       compute_dtype=model.spec.cdtype)
            feats = sm.forward_eval(model, imgs, cams)
        torch.cuda.synchronize()
        # two tower passes (_encode, forward_eval): 12 launches each on the
        # kernel path, none on the plain-attention path
        launched = attention_fwd_cuda.launches - before
        if launched != (2 * spec.layers if use_flash else 0):
            raise SystemExit(f"{dtype} use_flash={use_flash}: {launched} kernel launches")
        return patches, cls, torch.stack([masks[m] for m in sm.MODALITIES], 1), feats

    # fp32: the two paths differ only in where the scale is applied and in
    # summation order
    p_k, c_k, m_k, f_k = run("float32", True)
    p_p, c_p, m_p, f_p = run("float32", False)
    feat_err = (f_k - f_p).abs().max().item()
    out["fp32"] = {"feat_max_abs_err": feat_err, "feat_max_abs": f_p.abs().max().item(),
                   "mask_agree": (m_k == m_p).float().mean().item(),
                   "vit_max_abs_err": max((p_k - p_p).abs().max().item(),
                                          (c_k - c_p).abs().max().item())}
    log(f"[slice] fp32 kernel vs plain path: {json.dumps(out['fp32'])}")
    if not torch.allclose(f_k, f_p, atol=1e-3, rtol=1e-3):
        raise SystemExit(f"fp32 features: kernel path vs plain path max abs err {feat_err}"
                         f" (atol 1e-3 + rtol 1e-3)")
    del p_k, c_k, m_k, f_k, p_p, c_p, m_p, f_p

    # bf16: rounding points move, so the ViT outputs are held by cosine
    # and SIM by the share of mask entries that agree
    p_k, c_k, m_k, f_k = run("bfloat16", True)
    p_p, c_p, m_p, f_p = run("bfloat16", False)
    cos_cls = torch.nn.functional.cosine_similarity(c_k.flatten(0, 1), c_p.flatten(0, 1), dim=-1)
    cos_pat = torch.nn.functional.cosine_similarity(p_k.flatten(0, 2), p_p.flatten(0, 2), dim=-1)
    out["bf16"] = {"cls_cos_min": cos_cls.min().item(), "patch_cos_min": cos_pat.min().item(),
                   "mask_agree": (m_k == m_p).float().mean().item(),
                   "feat_finite": bool(torch.isfinite(f_k).all())}
    log(f"[slice] bf16 kernel vs plain path: {json.dumps(out['bf16'])}")
    if not (out["bf16"]["cls_cos_min"] > 0.99 and out["bf16"]["patch_cos_min"] > 0.99
            and out["bf16"]["mask_agree"] > 0.9 and out["bf16"]["feat_finite"]):
        raise SystemExit(f"bf16 kernel path disagrees with the plain path: {out['bf16']}")
    if tuple(f_k.shape) != (B, spec.eval_feat_dim):
        raise SystemExit(f"features {tuple(f_k.shape)}, want {(B, spec.eval_feat_dim)}")
    del p_k, c_k, m_k, f_k, p_p, c_p, m_p, f_p

    # the flagship path as configured (bf16, kernel): launches and time
    model.spec = spec

    def step():
        with torch.inference_mode():
            return sm.forward_eval(model, normalize_images(u8, cfg.INPUT.PIXEL_MEAN,
                                                           cfg.INPUT.PIXEL_STD), cams)

    step()
    torch.cuda.synchronize()
    n = 5
    attention_fwd_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    per_fwd = attention_fwd_cuda.launches / n
    out["bf16_forward"] = {"batch": B, "ms_per_batch": ms, "samples_per_s": B / ms * 1e3,
                           "attention_launches_per_forward": per_fwd,
                           **mfu(torch, spec, B, ms)}
    log(f"[slice] flagship forward_eval bf16 B={B}: {json.dumps(out['bf16_forward'])}")
    if per_fwd != spec.layers:
        raise SystemExit(f"{per_fwd} attention launches per forward, want {spec.layers}")
    report["slice"] = out
    del model


class Paths:
    """One model's train-step gradients on the kernel path and on the
    plain-attention path, from the same weights and batch (phases 6 and
    14). ``streams``: encoder calls per batch (3 for the prompted tower),
    for the launch counts each path must show."""

    def __init__(self, torch, model, spec, cfg, imgs, pids, cams, streams: int = 1):
        from signal_tpu_torch.losses import make_loss

        self.torch, self.model, self.spec, self.cfg = torch, model, spec, cfg
        self.imgs, self.pids, self.cams = imgs, pids, cams
        self.layers = streams * spec.layers
        self.loss_fn = make_loss(cfg, spec.num_classes)
        self.params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_and_grads(self, dtype: str, use_flash: bool, plain_bwd: bool = False):
        """The step's loss and every gradient. plain_bwd: the backward
        kernel's plain version on the card in its place (the forward kernel
        stays)."""
        from signal_tpu_torch.losses import total_train_loss
        from signal_tpu_torch.models import signal_model as sm
        from signal_tpu_torch.ops import flash_attention as fa
        from signal_tpu_torch.ops.attention import true_fp32

        torch, model, cfg = self.torch, self.model, self.cfg
        kernel = fa.attention_bwd_cuda
        model.load_state_dict(self.state0)        # the BNNecks' running stats move
        model.spec = dataclasses.replace(self.spec, compute_dtype=dtype, use_flash=use_flash)
        fwd, bwd = fa.attention_fwd_cuda.launches, kernel.launches
        if plain_bwd:
            fa.attention_bwd_cuda = fa.flash_attention_bwd_reference
        try:
            with true_fp32():
                o = sm.forward_train(model, self.imgs, self.cams)
                loss = total_train_loss(o, self.pids, self.loss_fn,
                                        gram_weight=cfg.MODEL.Gram_Loss_weight,
                                        pat_weight=cfg.MODEL.PAT_Loss_weight,
                                        moe_weight=cfg.MODEL.MoE_Loss_weight)
                grads = torch.autograd.grad(loss, [p for _, p in self.params],
                                            allow_unused=True)
            torch.cuda.synchronize()
        finally:
            fa.attention_bwd_cuda = kernel
        launched = (fa.attention_fwd_cuda.launches - fwd, kernel.launches - bwd)
        n = self.layers
        want = (2 * n, 0 if plain_bwd else n) if use_flash else (0, 0)
        if launched != want:
            raise SystemExit(f"train {dtype} use_flash={use_flash}: (fwd, bwd) launches "
                             f"{launched}, want {want}")
        return loss.item(), {n_: (torch.zeros_like(p) if g is None else g)
                             for (n_, p), g in zip(self.params, grads)}

    def tower_grads(self, use_flash: bool):
        """Gradients of a smooth loss of the bf16 ViT tower (remat on): the
        mean square of its patch and class tokens."""
        from signal_tpu_torch.models import signal_model as sm
        from signal_tpu_torch.ops.attention import true_fp32

        model = self.model
        model.load_state_dict(self.state0)
        model.spec = dataclasses.replace(self.spec, compute_dtype="bfloat16",
                                         use_flash=use_flash)
        with true_fp32():
            patches, cls, _ = sm._encode(model, self.imgs, self.cams, remat=self.spec.remat)
            loss = patches.float().square().mean() + cls.float().square().mean()
            grads = self.torch.autograd.grad(loss, [p for _, p in self.params],
                                             allow_unused=True)
        return {n: g for (n, _), g in zip(self.params, grads) if g is not None}


def hold_fp32(torch, g_k, g_plain, label: str):
    """fp32 gradients of the kernel path against the plain path: the
    paths differ in where the scale is applied and in summation order,
    so each tensor is held by allclose(rtol 1e-3, atol 1e-4·max|g|);
    one that is zero on the plain path (SIM's W_q/W_k feed only the
    top-k; a bias in front of a BatchNorm) must be noise on both. →
    (largest relative L2 error, the zero tensors' names)."""
    worst, zero = 0.0, []
    for n, b in g_plain.items():
        a = g_k[n]
        if b.norm().item() < 1e-6:
            zero.append(n)
            if a.norm().item() >= 1e-5:
                raise SystemExit(f"{label}: fp32 gradient of {n} zero on the plain path, "
                                 f"norm {a.norm().item()} on the kernel path")
            continue
        scale = b.abs().max().item()
        worst = max(worst, ((a - b).norm() / b.norm()).item())
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-4 * scale):
            raise SystemExit(f"{label}: fp32 gradient of {n}, kernel path vs plain path "
                             f"max abs err {(a - b).abs().max().item()} (max |g| {scale})")
    return worst, zero


def cosines(torch, a, b, names):
    return {n: torch.nn.functional.cosine_similarity(a[n].flatten().float(),
                                                     b[n].flatten().float(), dim=0).item()
            for n in names}


def check_train_step(torch, report):
    """Phase 6: the flagship train step, kernel path vs plain-attention path."""
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data.augment import normalize_images
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"))
    B, C, K = cfg.SOLVER.IMS_PER_BATCH, 171, cfg.DATALOADER.NUM_INSTANCE
    spec = sm.ModelSpec.from_config(cfg, num_classes=C, camera_num=4)
    assert (B, spec.width, spec.layers, spec.num_heads, spec.topk, spec.use_flash, spec.remat,
            spec.use_b, spec.stage) == (64, 768, 12, 12, 80, True, True, True,
                                        "together_CLS_Patch"), spec
    model = sm.init_signal(spec, seed=0).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    u8 = torch.randint(0, 256, (B, 3, 3, 256, 128), dtype=torch.uint8, device="cuda",
                       generator=gen)
    ids = torch.randperm(C, device="cuda", generator=gen)[:B // K]
    pids = ids.repeat_interleave(K)                                # P×K: 8 ids × 8
    cams = torch.randint(0, 4, (B,), device="cuda", generator=gen)
    imgs = normalize_images(u8, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
    paths = Paths(torch, model, spec, cfg, imgs, pids, cams)
    loss_and_grads, tower_grads, state0 = paths.loss_and_grads, paths.tower_grads, paths.state0
    out = {}

    loss_k, g_k = loss_and_grads("float32", True)
    loss_p, g32 = loss_and_grads("float32", False)
    worst, zero = hold_fp32(torch, g_k, g32, "phase 6")
    out["fp32"] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                   "grad_max_rel_l2": worst, "n_grads": len(g32), "zero_grads": zero}
    log(f"[train] fp32 kernel vs plain path: {json.dumps(out['fp32'])}")
    if not math.isclose(loss_k, loss_p, rel_tol=1e-5):
        raise SystemExit(f"fp32 loss: kernel path {loss_k} vs plain path {loss_p} (rtol 1e-5)")
    del g_k

    # bf16: rounding points move, so the loss is held within 1e-2 relative
    # of the plain path's, and gradients by cosine > 0.99 for every one that
    # is not analytically zero. The step's discrete choices (SIM's top-k,
    # DAS's sampling cells, hard mining) turn on single bf16 ulps of the
    # attention output, and the tensor-core kernel sums in another order
    # than cuBLAS's fp32 GEMMs: the whole-step gradients of the kernel path
    # and the plain path then differ as two bf16 runs do, not as the kernels
    # do (PERF.md). They are reported, with each path against fp32.
    # The kernels are held where no discrete choice intervenes: (a) the
    # step with the backward kernel against the step with its plain version
    # (the same forward); (b) both kernels through the ViT tower (remat on)
    # under a smooth loss, against the plain-attention path.
    names = [n for n in g32 if n not in zero]
    loss_k, g_k = loss_and_grads("bfloat16", True)
    loss_p, g_p = loss_and_grads("bfloat16", False)
    step = cosines(torch, g_k, g_p, names)
    vs32_k, vs32_p = cosines(torch, g_k, g32, names), cosines(torch, g_p, g32, names)
    del g_p, g32
    _, g_b = loss_and_grads("bfloat16", True, plain_bwd=True)
    bwd_cos = cosines(torch, g_k, g_b, names)
    del g_k, g_b
    t_k, t_p = tower_grads(True), tower_grads(False)
    tower = cosines(torch, t_k, t_p, [n for n in t_p if n not in zero])
    del t_k, t_p
    low = {k: min(c, key=c.get) for k, c in (("step", step), ("bwd", bwd_cos), ("tower", tower),
                                             ("k32", vs32_k), ("p32", vs32_p))}
    out["bf16"] = {
        "loss_kernel": loss_k, "loss_plain": loss_p,
        "bwd_kernel_vs_plain_grad_cos_min": bwd_cos[low["bwd"]],
        "bwd_kernel_vs_plain_grad_cos_min_tensor": low["bwd"], "n_grads": len(bwd_cos),
        "tower_grad_cos_min": tower[low["tower"]], "tower_grad_cos_min_tensor": low["tower"],
        "n_tower_grads": len(tower),
        "step_kernel_vs_plain_path_grad_cos_min": step[low["step"]],
        "step_kernel_vs_plain_path_grad_cos_min_tensor": low["step"],
        "kernel_path_vs_fp32_grad_cos_min": vs32_k[low["k32"]],
        "plain_path_vs_fp32_grad_cos_min": vs32_p[low["p32"]]}
    log(f"[train] bf16 kernel vs plain: {json.dumps(out['bf16'])}")
    if not (math.isclose(loss_k, loss_p, rel_tol=1e-2) and bwd_cos[low["bwd"]] > 0.99
            and tower[low["tower"]] > 0.99):
        raise SystemExit(f"bf16 train step: kernel path disagrees with the plain path: "
                         f"{out['bf16']}")

    # the flagship step as configured (bf16, kernels, remat, device augment,
    # Adam): launches, time, memory
    model.load_state_dict(state0)
    model.spec = spec
    optimizer = make_optimizer(model, cfg)
    set_lr(optimizer, *schedule_coeffs(cfg, 1))
    step = make_train_step(model, cfg, C, optimizer, device_augment=True,
                           gen=torch.Generator(device="cuda").manual_seed(4))
    for _ in range(2):
        step(u8, pids, cams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    attention_fwd_cuda.launches = attention_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    losses = [step(u8, pids, cams)[0] for _ in range(n)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    out["bf16_step"] = {
        "batch": B, "ms_per_step": ms, "samples_per_s": B / ms * 1e3,
        "attention_fwd_launches_per_step": attention_fwd_cuda.launches / n,
        "attention_bwd_launches_per_step": attention_bwd_cuda.launches / n,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "losses": [x.item() for x in losses], **mfu(torch, spec, B, ms, train=True)}
    log(f"[train] flagship train step bf16 B={B}: {json.dumps(out['bf16_step'])}")
    if (out["bf16_step"]["attention_fwd_launches_per_step"],
            out["bf16_step"]["attention_bwd_launches_per_step"]) != (2 * spec.layers, spec.layers):
        raise SystemExit(f"launches per step: {out['bf16_step']}")
    if not all(math.isfinite(x) for x in out["bf16_step"]["losses"]):
        raise SystemExit(f"non-finite train loss: {out['bf16_step']['losses']}")
    report["train"] = out
    del model, optimizer, step


def run_train_path(torch, report):
    """Phase 7: the train CLI end to end on the synthetic config."""
    from signal_tpu_torch.cli import train_main
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda

    # checkpoints of the full-width model go to the git-ignored build tree
    # and are removed after; the train log is kept in chiprun_out
    work = REPO / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    attention_fwd_cuda.launches = attention_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    state = train_main(["--config_file", str(REPO / "configs/synthetic/smoke.yml"),
                        "MODEL.DEVICE", "cuda", "OUTPUT_DIR", str(work)])
    torch.cuda.synchronize()
    launches = {"attention_fwd": attention_fwd_cuda.launches,
                "attention_bwd": attention_bwd_cuda.launches}
    e2e = {"epochs": state.epoch, "loss": state.loss, "acc": state.acc, "mAP": state.mAP,
           "rank1": float(state.cmc[0]) if state.cmc is not None else None,
           "seconds": time.perf_counter() - t0, "launches": launches}
    out = REPO / "chiprun_out" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(work / "synthetic_run" / "train_log.txt", out / "train_log.txt")
    shutil.rmtree(work)
    log(f"[e2e] train_main synthetic: {json.dumps(e2e)}")
    if not (math.isfinite(e2e["loss"]) and e2e["mAP"] is not None and math.isfinite(e2e["mAP"])):
        raise SystemExit(f"non-finite train loss or mAP: {e2e}")
    if min(launches.values()) == 0:
        raise SystemExit(f"the train path left a kernel unlaunched: {launches}")
    report["e2e_train"] = e2e
    return launches


def write_clip_archive(torch, path: Path, layers: int = 12, text: bool = False):
    """A seeded fp16 TorchScript archive laid out as OpenAI's ``ViT-B-16.pt``:
    the ``visual.*`` tensors of ViT-B/16 at their published shapes (width
    768, 14×14 + 1 positions, proj 768×512) and one text-side tensor; with
    ``text`` also the text tower at its published shapes (vocabulary
    49,408 × 512, 77 positions, 12 blocks of width 512, projection
    512×512) under CLIP's top-level names. → the archive's state dict
    (fp16, on the CPU)."""
    from torch import nn

    from signal_tpu_torch.models.text_encoder import TextTransformer
    from signal_tpu_torch.models.vit import VisionTransformer

    class Clip(TextTransformer if text else nn.Module):
        def __init__(self):
            super().__init__()
            self.visual = VisionTransformer(h_resolution=14, w_resolution=14, width=768,
                                            layers=layers, output_dim=512)
            self.logit_scale = nn.Parameter(torch.ones([]))

        def forward(self, x: torch.Tensor) -> torch.Tensor:
            return x * self.logit_scale

    gen = torch.Generator().manual_seed(11)
    clip = Clip()
    clip.visual.reset_parameters(gen)
    if text:
        TextTransformer.reset_parameters(clip, gen)
    with torch.no_grad():
        for name, p in clip.named_parameters():
            if "ln" in name:  # LayerNorms off their identity init
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    clip = clip.half()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.jit.script(clip).save(str(path))
    return clip.state_dict()


def run_recipe_path(torch, report):
    """Phase 8: the paper's recipe through ``train_main``: a CLIP import,
    ACCUM_ITER 2, center loss, REMAT_POLICY attn, re-ranking; then a real
    SIGTERM at the first step, the preemption checkpoint and its resume."""
    import os
    import signal

    from signal_tpu_torch.cli import train_main
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.models.clip_loader import load_clip_into_model
    from signal_tpu_torch.models.vit import resize_pos_embed
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda

    work = REPO / "build" / "chip_smoke_recipe"
    shutil.rmtree(work, ignore_errors=True)
    archive = work / "ViT-B-16.pt"
    t0 = time.perf_counter()
    src = write_clip_archive(torch, archive)
    out = {"archive_mb": archive.stat().st_size / 2 ** 20,
           "archive_s": time.perf_counter() - t0}
    config = str(REPO / "configs/synthetic/smoke.yml")
    opts = ["MODEL.DEVICE", "cuda", "OUTPUT_DIR", str(work),
            "MODEL.PRETRAIN_PATH_CLIP", str(archive), "SOLVER.ACCUM_ITER", "2",
            "MODEL.METRIC_LOSS_TYPE", "triplet_center", "MODEL.REMAT_POLICY", "attn",
            "TEST.RE_RANKING", "yes"]

    # the import as train_main makes it: the tower equals the archive,
    # widened to fp32, the pos embed resized 14×14 → the 16×8 grid
    cfg = load_config(config, opts)
    spec = sm.ModelSpec.from_config(cfg, num_classes=10, camera_num=4)
    model = load_clip_into_model(sm.init_signal(spec, seed=cfg.SOLVER.SEED), str(archive))
    tower = model.clip_vision_encoder.base.state_dict()
    worst = 0.0
    for k, v in tower.items():
        want = src[f"visual.{k}"].float()
        if k == "positional_embedding":
            want = resize_pos_embed(want, spec.h, spec.w)
        if v.shape != want.shape:
            raise SystemExit(f"imported {k}: shape {tuple(v.shape)}, want {tuple(want.shape)}")
        worst = max(worst, (v - want).abs().max().item())
    out["import_max_abs_err"] = worst
    if worst != 0.0:
        raise SystemExit(f"the imported tower differs from the archive: max abs err {worst}")
    del model, tower

    attention_fwd_cuda.launches = attention_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    state = train_main(["--config_file", config] + opts)
    torch.cuda.synchronize()
    launches = {"attention_fwd": attention_fwd_cuda.launches,
                "attention_bwd": attention_bwd_cuda.launches}
    run = work / "synthetic_run"
    log_text = (run / "train_log.txt").read_text()
    out["train"] = {"epochs": state.epoch, "loss": state.loss, "acc": state.acc,
                    "mAP": state.mAP, "rank1": float(state.cmc[0]) if state.cmc is not None
                    else None, "seconds": time.perf_counter() - t0, "launches": launches,
                    "clip_loaded": f"Loaded CLIP weights from {archive}" in log_text}
    log(f"[recipe] train_main CLIP + ACCUM_ITER 2 + center + remat attn + re-ranking: "
        f"{json.dumps(out['train'])}")
    if not (math.isfinite(state.loss) and state.mAP is not None and math.isfinite(state.mAP)
            and state.epoch == cfg.SOLVER.MAX_EPOCHS and out["train"]["clip_loaded"]):
        raise SystemExit(f"recipe run: {out['train']}")
    if min(launches.values()) == 0:
        raise SystemExit(f"the recipe path left a kernel unlaunched: {launches}")

    # preemption: a real SIGTERM to this process at the first step
    shutil.rmtree(run)
    sent = []

    def sigterm_at_first_step(epoch, n_iter):
        if not sent:
            sent.append((epoch, n_iter))
            os.kill(os.getpid(), signal.SIGTERM)

    stopped = train_main(["--config_file", config] + opts, step_callback=sigterm_at_first_step)
    restored = signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, None)
    stopped_log = (run / "train_log.txt").read_text()    # each run rewrites the log
    ckpt = run / "Signal_preempt.pth"
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    resumed = train_main(["--resume", str(ckpt), "--config_file", config] + opts)
    resumed_log = (run / "train_log.txt").read_text()
    out["preempt"] = {"sigterm_at": sent, "returned_at_epoch": stopped.epoch,
                      "saved_epoch": saved["epoch"], "saved_centers": "centers" in saved,
                      "resumed_to_epoch": resumed.epoch, "resumed_loss": resumed.loss,
                      "resumed_mAP": resumed.mAP,
                      "handler_ran": "SIGTERM received" in stopped_log,
                      "resumed_from_it": f"Resumed from {ckpt}" in resumed_log,
                      "sigterm_handler_restored": restored}
    log(f"[recipe] SIGTERM at the first step, then --resume: {json.dumps(out['preempt'])}")
    p = out["preempt"]
    if not (p["saved_epoch"] == 0 and p["returned_at_epoch"] == 0 and p["saved_centers"]
            and p["handler_ran"] and p["resumed_from_it"]
            and p["resumed_to_epoch"] == cfg.SOLVER.MAX_EPOCHS
            and math.isfinite(resumed.loss) and p["sigterm_handler_restored"]):
        raise SystemExit(f"preemption on the card: {p}")
    logs = REPO / "chiprun_out" / "chip_smoke"
    logs.mkdir(parents=True, exist_ok=True)
    (logs / "recipe_preempted_log.txt").write_text(stopped_log)
    (logs / "recipe_resumed_log.txt").write_text(resumed_log)
    shutil.rmtree(work)
    report["recipe"] = out
    return launches


def check_accumulation(torch, report):
    """Phase 9: ACCUM_ITER at full width: the flagship config in fp32 on
    the kernel path, center loss on; one step at A = 2 on [h; h] (B = 64)
    against one step at A = 1 on h (B = 32). SGD: its update is linear in
    the gradient (Adam turns the rounding noise of an analytically zero
    gradient into ±lr steps, as tests/test_accum.py notes)."""
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.engine.train import init_centers, make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    C = 171
    gen = torch.Generator(device="cuda").manual_seed(9)
    h = 32
    u8 = torch.randint(0, 256, (h, 3, 3, 256, 128), dtype=torch.uint8, device="cuda",
                       generator=gen)
    pids = torch.randperm(C, device="cuda", generator=gen)[:h // 8].repeat_interleave(8)
    cams = torch.randint(0, 4, (h,), device="cuda", generator=gen)
    runs = {}
    for accum, batch in ((1, (u8, pids, cams)),
                         (2, tuple(torch.cat([t, t]) for t in (u8, pids, cams)))):
        cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"), [
            "SOLVER.ACCUM_ITER", str(accum), "MODEL.METRIC_LOSS_TYPE", "triplet_center",
            "SOLVER.OPTIMIZER_NAME", "SGD", "MODEL.COMPUTE_DTYPE", "float32"])
        spec = sm.ModelSpec.from_config(cfg, num_classes=C, camera_num=4)
        model = sm.init_signal(spec, seed=0).to("cuda")
        optimizer = make_optimizer(model, cfg)
        set_lr(optimizer, *schedule_coeffs(cfg, 1))
        centers = init_centers(cfg, spec, C, torch.device("cuda"))
        step = make_train_step(model, cfg, C, optimizer, centers=centers)
        attention_fwd_cuda.launches = attention_bwd_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        loss, _ = step(*batch)
        torch.cuda.synchronize()
        runs[accum] = {
            "loss": loss.item(),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": (attention_fwd_cuda.launches, attention_bwd_cuda.launches),
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "centers": centers.detach().clone()}
        del model, optimizer, step, centers
    a1, a2 = runs[1], runs[2]
    worst_p = max(((a2["params"][n] - p).abs() / (1e-6 + 1e-4 * p.abs())).max().item()
                  for n, p in a1["params"].items())
    grad_rel = {n: ((a2["grads"][n] - g).norm() / g.norm()).item()
                for n, g in a1["grads"].items() if g.norm().item() >= 1e-6}
    worst_g = max(grad_rel, key=grad_rel.get)
    out = {"batch": [h, 2 * h], "loss_a1": a1["loss"], "loss_a2": a2["loss"],
           "param_err_over_tol_max": worst_p,
           "centers_max_abs_err": (a2["centers"] - a1["centers"]).abs().max().item(),
           "grad_max_rel_l2": grad_rel[worst_g], "grad_max_rel_l2_tensor": worst_g,
           "launches_a1": a1["launches"], "launches_a2": a2["launches"],
           "peak_memory_gib_a1": a1["peak_memory_gib"],
           "peak_memory_gib_a2": a2["peak_memory_gib"]}
    log(f"[accum] flagship fp32, center loss, A=2 on [h; h] vs A=1 on h: {json.dumps(out)}")
    if not (math.isclose(a2["loss"], a1["loss"], rel_tol=1e-5) and worst_p <= 1.0
            and torch.allclose(a2["centers"], a1["centers"], rtol=1e-4, atol=1e-6)
            and grad_rel[worst_g] < 1e-4):
        raise SystemExit(f"accumulation: A=2 on [h; h] differs from A=1 on h: {out}")
    if a2["launches"] != (48, 24) or a1["launches"] != (24, 12):
        raise SystemExit(f"launches per step: A=1 {a1['launches']}, A=2 {a2['launches']}; "
                         f"want (24, 12) and (48, 24)")
    del runs, a1, a2

    # the flagship bf16 step as configured (Adam, device augment, remat) at
    # B = 64 in one batch and in two microbatches of 32, on one model in
    # turns: time, memory, launches
    B = 2 * h
    u8 = torch.randint(0, 256, (B, 3, 3, 256, 128), dtype=torch.uint8, device="cuda",
                       generator=gen)
    pids = torch.randperm(C, device="cuda", generator=gen)[:B // 8].repeat_interleave(8)
    cams = torch.randint(0, 4, (B,), device="cuda", generator=gen)
    torch.cuda.empty_cache()
    cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"))
    model = sm.init_signal(sm.ModelSpec.from_config(cfg, num_classes=C, camera_num=4),
                           seed=0).to("cuda")
    optimizer = make_optimizer(model, cfg)
    set_lr(optimizer, *schedule_coeffs(cfg, 1))
    steps = {}
    for accum in (1, 2):
        cfg_a = load_config(str(REPO / "configs/RGBNT201/Signal.yml"),
                            ["SOLVER.ACCUM_ITER", str(accum)])
        steps[f"a{accum}"] = make_train_step(model, cfg_a, C, optimizer, device_augment=True,
                                             gen=torch.Generator(device="cuda").manual_seed(4))
    timed = in_turns(torch, steps, (u8, pids, cams))
    for name, row in timed.items():
        log(f"[accum] flagship bf16 step B={B}, ACCUM_ITER {name[1:]}: {json.dumps(row)}")
        out[f"bf16_step_{name}"] = row
    want = {"a1": (24.0, 12.0), "a2": (48.0, 24.0)}
    for name, row in timed.items():
        got = (row["attention_fwd_launches_per_step"], row["attention_bwd_launches_per_step"])
        if got != want[name]:
            raise SystemExit(f"ACCUM_ITER {name[1:]}: launches per step {got}, want {want[name]}")
    del model, optimizer, steps
    report["accumulation"] = out


def check_remat_policies(torch, report):
    """Phase 10: the flagship bf16 step at B = 64 under every REMAT policy
    and without remat: ms/step, peak memory, launches per step; gradients
    against 'full' (bf16 cosine, fp32 allclose)."""
    import contextlib

    from torch.utils._python_dispatch import TorchDispatchMode

    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data.augment import normalize_images
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.losses import make_loss, total_train_loss
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.attention import true_fp32
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"))
    B, C, K = cfg.SOLVER.IMS_PER_BATCH, 171, cfg.DATALOADER.NUM_INSTANCE
    spec = sm.ModelSpec.from_config(cfg, num_classes=C, camera_num=4)
    model = sm.init_signal(spec, seed=0).to("cuda")
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(10)
    u8 = torch.randint(0, 256, (B, 3, 3, 256, 128), dtype=torch.uint8, device="cuda",
                       generator=gen)
    pids = torch.randperm(C, device="cuda", generator=gen)[:B // K].repeat_interleave(K)
    cams = torch.randint(0, 4, (B,), device="cuda", generator=gen)
    imgs = normalize_images(u8, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
    loss_fn = make_loss(cfg, C)
    make_optimizer(model, cfg)   # freezes what the step does not train, as below
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    policies = [(True, "full"), (True, "dots"), (True, "attn"), (True, "attn_mlp"),
                (True, "half"), (False, "full")]

    class CountProducts(TorchDispatchMode):
        """The 2-D products (``aten.mm``, any overload) dispatched inside."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func.overloadpacket is torch.ops.aten.mm
            return func(*args, **(kwargs or {}))

    def grads(dtype, remat, policy, counter=None):
        model.load_state_dict(state0)
        model.spec = dataclasses.replace(spec, compute_dtype=dtype, remat=remat,
                                         remat_policy=policy)
        with true_fp32():
            o = sm.forward_train(model, imgs, cams)
            loss = total_train_loss(o, pids, loss_fn, gram_weight=cfg.MODEL.Gram_Loss_weight,
                                    pat_weight=cfg.MODEL.PAT_Loss_weight)
            with counter or contextlib.nullcontext():
                g = torch.autograd.grad(loss, [p for _, p in params], allow_unused=True)
        return {n: (torch.zeros_like(p) if x is None else x) for (n, p), x in zip(params, g)}

    rows = {}
    ref = {dt: grads(dt, True, "full") for dt in ("float32", "bfloat16")}
    for remat, policy in policies:
        name = policy if remat else "off"
        row = {}
        # numbers: fp32 allclose as phase 6, bf16 cosine, against 'full'
        g32 = grads("float32", remat, policy)
        worst = 0.0
        for n, b in ref["float32"].items():
            if b.norm().item() < 1e-6:
                continue
            a = g32[n]
            worst = max(worst, ((a - b).norm() / b.norm()).item())
            if not torch.allclose(a, b, rtol=1e-3, atol=1e-4 * b.abs().max().item()):
                raise SystemExit(f"remat {name}: fp32 gradient of {n} differs from 'full'")
        del g32
        products = CountProducts()
        g16 = grads("bfloat16", remat, policy, products)
        cos = {n: torch.nn.functional.cosine_similarity(
                   g16[n].flatten().float(), b.flatten().float(), dim=0).item()
               for n, b in ref["bfloat16"].items() if b.norm().item() >= 1e-6}
        del g16
        low = min(cos, key=cos.get)
        row.update(fp32_grad_max_rel_l2=worst, bf16_grad_cos_min=cos[low],
                   bf16_grad_cos_min_tensor=low, backward_products=products.n)
        if cos[low] <= 0.99:
            raise SystemExit(f"remat {name}: bf16 gradient of {low} has cosine {cos[low]}")
        rows[name] = row
        log(f"[remat] {name} numbers: {json.dumps(row)}")

    # the step as configured but for the policy, one model and optimizer,
    # the policies in turns (the spec is read at each forward): time,
    # memory, launches
    del ref
    model.load_state_dict(state0)
    optimizer = make_optimizer(model, cfg)
    set_lr(optimizer, *schedule_coeffs(cfg, 1))
    step = make_train_step(model, cfg, C, optimizer, device_augment=True,
                           gen=torch.Generator(device="cuda").manual_seed(4))

    def under(remat, policy):
        def run(*batch):
            model.spec = dataclasses.replace(spec, remat=remat, remat_policy=policy)
            return step(*batch)
        return run

    torch.cuda.empty_cache()
    timed = in_turns(torch, {(p if r else "off"): under(r, p) for r, p in policies},
                     (u8, pids, cams))
    for name, row in timed.items():
        rows[name].update(row)
        log(f"[remat] {name}: {json.dumps(rows[name])}")
    report["remat"] = rows
    del model, optimizer, step
    # a block that is recomputed at all relaunches the forward kernel: the
    # out-proj's weight gradient needs the attention core's output
    for name, fwd in {"full": 24, "dots": 24, "attn": 24, "attn_mlp": 24, "half": 18,
                      "off": 12}.items():
        got = (rows[name]["attention_fwd_launches_per_step"],
               rows[name]["attention_bwd_launches_per_step"])
        if got != (fwd, 12):
            raise SystemExit(f"remat {name}: launches per step {got}, want ({fwd}, 12)")
    # 'dots' keeps every product's output: its backward runs the products
    # of the step without remat and none more
    if rows["dots"]["backward_products"] != rows["off"]["backward_products"]:
        raise SystemExit(f"'dots' recomputes products: {rows['dots']['backward_products']} "
                         f"in its backward, {rows['off']['backward_products']} without remat")


def check_reranking(torch, report):
    """Phase 11: re-ranking on the card at the JAX package's sizing (N =
    5,000: 1,000 query + 4,000 gallery, width 3072) for time and memory,
    and at N = 320 against the same function on the CPU."""
    import numpy as np

    from signal_tpu_torch.reranking import re_ranking

    out = {}
    # small integers: every distance is exact on both devices, so they rank
    # alike (ties by index) and only summation order separates the results
    small = torch.from_numpy(np.random.default_rng(12).integers(-3, 4, (320, 64))
                             .astype(np.float32))
    want = re_ranking(small[:40], small[40:], k1=20, k2=6, lambda_value=0.3)
    got = re_ranking(small[:40].cuda(), small[40:].cuda(), k1=20, k2=6, lambda_value=0.3)
    err = (got.cpu() - want).abs()
    out["n320_max_abs_err"] = err.max().item()
    if not bool((err <= 1e-5 + 1e-4 * want.abs()).all()):
        raise SystemExit(f"re-ranking on the card differs from the CPU: max abs err "
                         f"{out['n320_max_abs_err']} (atol 1e-5 + rtol 1e-4)")

    gen = torch.Generator(device="cuda").manual_seed(13)
    feats = torch.randn(5000, 3072, device="cuda", generator=gen)
    feats = feats / feats.norm(dim=1, keepdim=True)
    qf, gf = feats[:1000], feats[1000:]
    re_ranking(qf, gf, k1=50, k2=15, lambda_value=0.3)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        dist = re_ranking(qf, gf, k1=50, k2=15, lambda_value=0.3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out.update(n=5000, num_query=1000, width=3072, ms=min(times), ms_all=times,
               peak_memory_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
               finite=bool(torch.isfinite(dist).all()), shape=list(dist.shape))
    log(f"[rerank] {json.dumps(out)}")
    if not (out["finite"] and out["shape"] == [1000, 4000]):
        raise SystemExit(f"re-ranking at N=5000: {out}")
    report["reranking"] = out


def check_serving(torch, report):
    """Phase 12: the serving export of the flagship model (bf16, random
    weights from SOLVER.SEED) with uint8 input, on the card, at a fixed
    batch of 128 and at a symbolic batch: each keeps the attention kernel
    in the graph as its registered operator. Each is saved, loaded and run
    against eager ``forward_eval`` with the kernel (the fixed one at
    B = 128, the symbolic one at B = 2, 8 and 128, 12 launches a batch),
    and both are timed against eager in turns at B = 128. → (the fixed
    artifact's callable, its ms per batch, its kernel launches per batch)."""
    from signal_tpu_torch import serving
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data.augment import normalize_images
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"))
    B, hw = cfg.TEST.IMS_PER_BATCH, tuple(cfg.INPUT.SIZE_TEST)
    norm = (tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD))
    spec = sm.ModelSpec.from_config(cfg, num_classes=171, camera_num=4)
    assert (B, spec.compute_dtype, spec.use_flash) == (128, "bfloat16", True), spec
    model = sm.init_signal(spec, seed=cfg.SOLVER.SEED).to("cuda")
    # the artifacts (weights included, ~0.4 GB each) go to the git-ignored
    # build tree and are removed after; their manifests are kept
    work = REPO / "build" / "chip_smoke_serving"
    logs = REPO / "chiprun_out" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    logs.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(14)

    def batch(n):
        imgs = {m: torch.randint(0, 256, (n, 3, *hw), dtype=torch.uint8, device="cuda",
                                 generator=gen) for m in sm.MODALITIES}
        return imgs, torch.randint(0, 4, (n,), device="cuda", generator=gen)

    def eager(imgs, cams, use_flash=True):
        model.spec = dataclasses.replace(spec, use_flash=use_flash)
        with torch.inference_mode():
            return sm.forward_eval(model, normalize_images(imgs, *norm), cams)

    def agree(got, want):
        cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1)
        return {"cos_min": cos.min().item(), "max_abs_err": (got - want).abs().max().item(),
                "max_abs": want.abs().max().item(), "finite": bool(torch.isfinite(got).all())}

    out = {}
    artifacts = {}
    for name, b in (("fixed", B), ("symbolic", None)):
        t0 = time.perf_counter()
        ep = serving.export_eval(model, spec, image_size=hw, batch=b, normalize=norm,
                                 device="cuda")
        export_s = time.perf_counter() - t0
        nodes = sum(str(n.target) == "signal_tpu_torch.attention_fwd.default"
                    for n in ep.graph.nodes)
        path = serving.save_exported(ep, str(work / name), extra_manifest={
            "config_file": "configs/RGBNT201/Signal.yml", "weight": cfg.TEST.WEIGHT,
            "image_size": list(hw), "uint8_input": True})
        del ep
        call, manifest = serving.load_exported(path)
        shutil.copy(Path(path) / "manifest.json", logs / f"serving_{name}_manifest.json")
        artifacts[name] = call
        out[name] = {"export_s": export_s, "kernel_nodes": nodes, "bytes": manifest["bytes"],
                     "in_avals": manifest["in_avals"], "out_avals": manifest["out_avals"],
                     "device": manifest["device"]}
        log(f"[serving] {name} artifact: {json.dumps(out[name])}")
    if out["fixed"]["kernel_nodes"] != spec.layers or out["symbolic"]["kernel_nodes"] != spec.layers:
        raise SystemExit(f"kernel operator nodes: fixed {out['fixed']['kernel_nodes']}, symbolic "
                         f"{out['symbolic']['kernel_nodes']} (want {spec.layers} each)")

    def served(name, call, n):
        """One call at batch ``n``: its launches and its agreement with
        eager ``forward_eval`` on the same inputs."""
        imgs, cams = batch(n)
        call(imgs, cams)
        torch.cuda.synchronize()
        attention_fwd_cuda.launches = 0
        got = call(imgs, cams)
        torch.cuda.synchronize()
        launches = attention_fwd_cuda.launches
        row = dict(agree(got, eager(imgs, cams)), launches_per_batch=launches)
        log(f"[serving] {name} artifact at B={n} vs eager forward_eval: {json.dumps(row)}")
        if not (tuple(got.shape) == (n, spec.eval_feat_dim) and row["finite"]
                and row["cos_min"] > 0.9999 and row["launches_per_batch"] == spec.layers):
            raise SystemExit(f"{name} artifact at B={n}: {row} (want {spec.layers} launches)")
        return row

    fixed, sym = artifacts["fixed"], artifacts["symbolic"]
    out["fixed"].update(served("fixed", fixed, B))
    launches = out["fixed"]["launches_per_batch"]
    for n in (2, 8, B):
        out["symbolic"][f"B{n}"] = served("symbolic", sym, n)

    # in turns at B = 128: eager, fixed, symbolic, symbolic, fixed, eager
    imgs, cams = batch(B)
    calls = {"eager": lambda: eager(imgs, cams), "fixed": lambda: fixed(imgs, cams),
             "symbolic": lambda: sym(imgs, cams)}
    times = {side: [] for side in calls}
    for side in ("eager", "fixed", "symbolic", "symbolic", "fixed", "eager"):
        times[side].append(cuda_ms(torch, calls[side], iters=10, warmup=2))
    timing = {"eager_ms_per_batch": min(times["eager"]), "eager_ms_all": times["eager"]}
    for name in ("fixed", "symbolic"):
        out[name].update(ms_per_batch=min(times[name]), ms_all=times[name],
                         samples_per_s=B / min(times[name]) * 1e3, **timing)
    log(f"[serving] B={B} ms per batch, in turns: {json.dumps(times)}")
    model.spec = spec
    report["serving"] = out
    shutil.rmtree(work)
    del model, artifacts, sym, calls
    return fixed, out["fixed"]["ms_per_batch"], launches


def write_rgbnt201(root: Path, ids: int, per_id: int, seed: int) -> dict:
    """A seeded tree in RGBNT201's layout,
    ``RGBNT201/{train_171,test}/{RGB,NI,TI}/<pid6>_cam<c>_<i>.jpg``, 256×128
    per modality: ``ids`` × ``per_id`` triplets per split. Each image is a
    smooth per-identity field with a per-instance shift and mild noise, so
    its JPEG is a few KB as a photo's crop is (pure noise would be ~60 KB).
    → {files, bytes, seconds}."""
    import concurrent.futures as cf
    import os

    import numpy as np
    from PIL import Image

    t0 = time.perf_counter()
    jobs = []
    for split in ("train_171", "test"):
        for m in ("RGB", "NI", "TI"):
            (root / "RGBNT201" / split / m).mkdir(parents=True, exist_ok=True)
        for pid in range(1, ids + 1):
            for i in range(per_id):
                jobs.append((split, pid, i))

    def write(job):
        split, pid, i = job
        rng = np.random.default_rng((seed, pid, i, split == "test"))
        base = np.random.default_rng((seed, pid)).integers(0, 256, (3, 16, 8, 3), dtype=np.uint8)
        name = f"{pid:06d}_cam{1 + i % 4}_{i:02d}.jpg"
        for k, m in enumerate(("RGB", "NI", "TI")):
            field = np.asarray(Image.fromarray(base[k]).resize((128, 256), Image.BICUBIC),
                               np.float32)
            field = np.roll(field, rng.integers(-8, 9, 2), axis=(0, 1))
            img = np.clip(field + rng.normal(0, 4, field.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / "RGBNT201" / split / m / name, quality=90)

    with cf.ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(write, jobs))
    files = list((root / "RGBNT201").rglob("*.jpg"))
    return {"files": len(files), "bytes": sum(f.stat().st_size for f in files),
            "seconds": time.perf_counter() - t0}


def check_host_data(torch, report, artifact, artifact_ms: float):
    """Phase 13: the host data path on the card's host. A seeded
    RGBNT201-shaped tree (1,024 train and 1,024 test triplets of 256×128
    JPEGs); the val loader at TEST.IMS_PER_BATCH and the train loader (PK
    8×8, bicubic u8 for the device augment) for each decoder the host has,
    at the config's thread count and at ``os.cpu_count()``, as host
    samples/s (the better of two passes); then the fed paths end to end: loader → prefetch → copy →
    phase 12's artifact, and loader → prefetch → copy → the train step,
    beside the device-only figures of phases 4, 6 and 12."""
    import ctypes.util
    import os

    import numpy as np

    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data import make_dataloader
    from signal_tpu_torch.data import native_decoder
    from signal_tpu_torch.data.prefetch import prefetch
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    out = {"cpu_count": os.cpu_count(),
           "libjpeg_headers": Path("/usr/include/jpeglib.h").exists(),
           "libjpeg_library": ctypes.util.find_library("jpeg"),
           "native_decoder": native_decoder.available(),
           "native_decoder_unavailable_because": native_decoder.unavailable_reason()}
    log(f"[data] host: {json.dumps(out)}")
    if not out["native_decoder"]:
        log("[data] the native decoder cannot be built on this host: every loader below "
            "decodes with PIL")
    work = REPO / "build" / "chip_smoke_data"
    shutil.rmtree(work, ignore_errors=True)
    out["tree"] = write_rgbnt201(work, ids=128, per_id=8, seed=15)
    log(f"[data] RGBNT201-shaped tree: {json.dumps(out['tree'])}")

    base = ["DATASETS.ROOT_DIR", str(work), "MODEL.DEVICE", "cuda"]
    cfg0 = load_config(str(REPO / "configs/RGBNT201/Signal.yml"), base)
    threads = sorted({cfg0.DATALOADER.NUM_WORKERS, os.cpu_count()})
    decoders = (["native"] if out["native_decoder"] else []) + ["pil"]
    real_available = native_decoder.available

    def loaders(n_threads, decoder):
        """→ (cfg, train loader, val loader, classes, cameras); the PIL
        decoder is chosen by making the native one unavailable."""
        cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"),
                          base + ["DATALOADER.NUM_WORKERS", str(n_threads)])
        native_decoder.available = real_available if decoder == "native" else (lambda: False)
        train, _, val, _, classes, cams, _ = make_dataloader(cfg)
        return cfg, train, val, classes, cams

    def drain(loader):
        """Host samples/s over one pass, from the first batch to the last
        (the pool's start-up and the first batch's decode are apart)."""
        t0 = time.perf_counter()
        first = None
        n = 0
        for b in loader:
            if first is None:
                first, t1 = b, time.perf_counter()
            else:
                n += b["packed"].shape[0]
        t2 = time.perf_counter()
        return {"samples_per_s": n / (t2 - t1), "first_batch_s": t1 - t0,
                "batches": len(loader), "decoder": loader.decoder}, first

    rows, firsts = {}, {}
    try:
        for decoder in decoders:
            for n_threads in threads:
                _, train, val, _, _ = loaders(n_threads, decoder)
                for kind, loader in (("val", val), ("train", train)):
                    # two passes: the host is shared, so one pass says
                    # little about the spread
                    (row, first), (again, _) = drain(loader), drain(loader)
                    row["samples_per_s_passes"] = [row["samples_per_s"], again["samples_per_s"]]
                    row["samples_per_s"] = max(row["samples_per_s_passes"])
                    rows[f"{kind}_{decoder}_{n_threads}t"] = row
                    firsts[(kind, decoder)] = first
                    log(f"[data] {kind} loader, {decoder} decode, {n_threads} threads: "
                        f"{json.dumps(row)}")
                    if row["decoder"] != decoder:
                        raise SystemExit(f"{kind} loader: asked {decoder}, served {row['decoder']}")
    finally:
        native_decoder.available = real_available
    out["loaders"] = rows
    if "native" in decoders:
        a = firsts[("val", "native")]["packed"].astype(np.int64)
        b = firsts[("val", "pil")]["packed"].astype(np.int64)
        diff = np.abs(a - b)
        out["native_vs_pil"] = {"max_lsb": int(diff.max()), "share_off": float((diff > 0).mean())}
        log(f"[data] native vs PIL val batch (u8): {json.dumps(out['native_vs_pil'])}")
        if not (diff.max() <= 1 and (diff > 0).mean() < 0.02):
            raise SystemExit(f"native decode vs PIL: {out['native_vs_pil']}")

    # the fed paths, at the config's thread count with the best decoder
    decoder, n_threads = decoders[0], cfg0.DATALOADER.NUM_WORKERS
    cfg, train, val, C, cams = loaders(n_threads, decoder)
    native_decoder.available = real_available
    device = torch.device("cuda")

    def fed(loader, put, consume):
        it = prefetch(loader, put)
        consume(next(it))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for item in it:
            n += consume(item)
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0), time.perf_counter() - t0

    def put(*arrays):
        """The engines' copy (``extract_features``, ``do_train``)."""
        return tuple(torch.from_numpy(a).to(device, non_blocking=True) for a in arrays)

    def put_val(b):
        imgs, cams = put(b["packed"], b["camids"])
        return {m: imgs[:, i].contiguous() for i, m in enumerate(sm.MODALITIES)}, cams

    def eval_consume(item):
        artifact(*item)
        return item[1].shape[0]

    eval_rate, eval_s = fed(val, put_val, eval_consume)
    device_rate = cfg.TEST.IMS_PER_BATCH / artifact_ms * 1e3
    out["fed_eval"] = {"samples_per_s": eval_rate, "seconds": eval_s,
                       "device_only_samples_per_s": device_rate,
                       "phase4_samples_per_s": report["slice"]["bf16_forward"]["samples_per_s"],
                       "card_waits_share": max(0.0, 1.0 - eval_rate / device_rate),
                       "decoder": val.decoder, "threads": n_threads}
    log(f"[data] fed eval: val loader → prefetch → copy → fixed artifact: "
        f"{json.dumps(out['fed_eval'])}")

    spec = sm.ModelSpec.from_config(cfg, num_classes=C, camera_num=cams)
    model = sm.init_signal(spec, seed=cfg.SOLVER.SEED).to(device)
    optimizer = make_optimizer(model, cfg)
    set_lr(optimizer, *schedule_coeffs(cfg, 1))
    step = make_train_step(model, cfg, C, optimizer, device_augment=True,
                           gen=torch.Generator(device="cuda").manual_seed(16))
    losses = []

    def train_consume(item):
        loss, _ = step(*item)
        losses.append(loss)
        return item[0].shape[0]

    train_rate, train_s = fed(train, lambda b: put(b["packed"], b["pids"], b["camids"]),
                              train_consume)
    step_ms = report["train"]["bf16_step"]["ms_per_step"]
    device_rate = cfg.SOLVER.IMS_PER_BATCH / step_ms * 1e3
    out["fed_train"] = {"samples_per_s": train_rate, "seconds": train_s, "steps": len(losses),
                        "device_only_samples_per_s": device_rate,
                        "card_waits_share": max(0.0, 1.0 - train_rate / device_rate),
                        "decoder": train.decoder, "threads": n_threads,
                        "loss_first_last": [losses[0].item(), losses[-1].item()]}
    log(f"[data] fed train: train loader → prefetch → copy → train step: "
        f"{json.dumps(out['fed_train'])}")
    if not all(math.isfinite(x.item()) for x in losses):
        raise SystemExit("fed train: non-finite loss")
    report["host_data"] = out
    shutil.rmtree(work)
    del model, optimizer, step


# the CLIP tower's variants at the flagship widths: (name, overrides of
# configs/RGBNT201/Signal.yml)
VARIANTS = [
    ("adapter", ["MODEL.ADAPTER", "True"]),
    ("prompt", ["MODEL.PROMPT", "True"]),
    ("prompt_adapter", ["MODEL.PROMPT", "True", "MODEL.ADAPTER", "True"]),
    ("frozen_lora8", ["MODEL.FROZEN", "True"]),
    ("moe4_top1", ["MODEL.MOE_EXPERTS", "4", "MODEL.MOE_TOPK", "1", "MODEL.MOE_CAPACITY", "1.25"]),
    ("moe4_top2", ["MODEL.MOE_EXPERTS", "4", "MODEL.MOE_TOPK", "2", "MODEL.MOE_CAPACITY", "1.25"]),
    ("stride12", ["MODEL.STRIDE_SIZE", "[12, 12]"]),
]


def check_variants(torch, report):
    """Phase 14: each variant of the CLIP tower at the flagship widths
    (random weights from SOLVER.SEED): ``forward_eval`` at B = 128, kernel
    path against the plain-attention path as phase 4 holds it; one train
    step's fp32 loss and gradients against the plain path as phase 6, and
    in bf16 the backward kernel against its plain version inside the step
    (cosine > 0.99) and both kernels through the tower under a smooth loss
    (held > 0.99 but for MoE, whose router turns on single ulps); then the
    step as configured (bf16, device augment, Adam, B = 64): launches per
    eval forward, train forward and backward, ms per step by the host
    clock and device time, peak memory. → the launches of the driven paths
    (the counts are zeroed before each and read after; the comparisons'
    launches are not counted)."""
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data.augment import normalize_images
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    C, B_eval = 171, 128
    gen = torch.Generator(device="cuda").manual_seed(14)
    driven = {"attention_fwd": 0, "attention_bwd": 0, "attention_bwd_long": 0}
    out = {}
    for name, opts in VARIANTS:
        t0 = time.perf_counter()
        cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"), opts)
        B, K = cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.NUM_INSTANCE
        spec = sm.ModelSpec.from_config(cfg, num_classes=C, camera_num=4)
        assert (spec.width, spec.layers, spec.num_heads, spec.topk, spec.use_flash, B) == \
            (768, 12, 12, 80, True, 64), spec
        streams = 3 if spec.prompt else 1
        tokens = spec.h * spec.w + 1 + (12 if spec.prompt else 0)
        model = sm.init_signal(spec, seed=cfg.SOLVER.SEED).to("cuda")
        make_optimizer(model, cfg)   # freezes what the step does not train (FROZEN)
        H, W = cfg.INPUT.SIZE_TRAIN
        u8e = torch.randint(0, 256, (B_eval, 3, 3, H, W), dtype=torch.uint8, device="cuda",
                            generator=gen)
        cams_e = torch.randint(0, 4, (B_eval,), device="cuda", generator=gen)
        imgs_e = normalize_images(u8e, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
        u8 = torch.randint(0, 256, (B, 3, 3, H, W), dtype=torch.uint8, device="cuda",
                           generator=gen)
        pids = torch.randperm(C, device="cuda", generator=gen)[:B // K].repeat_interleave(K)
        cams = torch.randint(0, 4, (B,), device="cuda", generator=gen)
        imgs = normalize_images(u8, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
        paths = Paths(torch, model, spec, cfg, imgs, pids, cams, streams)
        state0 = paths.state0
        row = {"tokens_per_block": tokens, "streams": streams, "batch_eval": B_eval,
               "batch_train": B}

        def features(dtype, use_flash):
            model.spec = dataclasses.replace(spec, compute_dtype=dtype, use_flash=use_flash)
            before = attention_fwd_cuda.launches
            with torch.inference_mode():
                patches, cls, _ = sm._encode(model, imgs_e, cams_e)
                feats = sm.forward_eval(model, imgs_e, cams_e)
            torch.cuda.synchronize()
            launched = attention_fwd_cuda.launches - before
            if launched != (2 * streams * spec.layers if use_flash else 0):
                raise SystemExit(f"{name} eval {dtype} use_flash={use_flash}: {launched} "
                                 f"kernel launches")
            return patches, cls, feats

        # eval, fp32: where the scale is applied and summation order only
        _, _, f_k = features("float32", True)
        _, _, f_p = features("float32", False)
        row["eval_fp32_feat_max_abs_err"] = (f_k - f_p).abs().max().item()
        if not torch.allclose(f_k, f_p, atol=1e-3, rtol=1e-3):
            raise SystemExit(f"{name}: fp32 features, kernel vs plain path max abs err "
                             f"{row['eval_fp32_feat_max_abs_err']} (atol 1e-3 + rtol 1e-3)")
        del f_k, f_p
        # eval, bf16: the tower's outputs by cosine. An MoE router turns on
        # single bf16 ulps (a flipped argmax moves a token to another
        # expert, or past a full one), so there the cosines are reported,
        # not held: fp32 above holds the MoE tower's kernel path
        p_k, c_k, f_k = features("bfloat16", True)
        p_p, c_p, _ = features("bfloat16", False)
        cos = torch.nn.functional.cosine_similarity
        cls_cos = cos(c_k.flatten(0, 1), c_p.flatten(0, 1), dim=-1)
        patch_cos = cos(p_k.flatten(0, 2), p_p.flatten(0, 2), dim=-1)
        row.update(eval_bf16_cls_cos_min=cls_cos.min().item(),
                   eval_bf16_patch_cos_min=patch_cos.min().item(),
                   eval_bf16_patch_cos_mean=patch_cos.mean().item(),
                   eval_bf16_cos_held=not spec.moe_experts)
        if not (bool(torch.isfinite(f_k).all())
                and tuple(f_k.shape) == (B_eval, spec.eval_feat_dim)
                and (spec.moe_experts or min(row["eval_bf16_cls_cos_min"],
                                             row["eval_bf16_patch_cos_min"]) > 0.99)):
            raise SystemExit(f"{name}: bf16 eval, kernel vs plain path: {row}")
        del p_k, c_k, f_k, p_p, c_p

        # train, fp32: loss rtol 1e-5, every gradient as phase 6
        loss_k, g_k = paths.loss_and_grads("float32", True)
        loss_p, g32 = paths.loss_and_grads("float32", False)
        worst, zero = hold_fp32(torch, g_k, g32, name)
        row.update(train_fp32_loss_kernel=loss_k, train_fp32_loss_plain=loss_p,
                   train_fp32_grad_max_rel_l2=worst, n_grads=len(g32))
        if not math.isclose(loss_k, loss_p, rel_tol=1e-5):
            raise SystemExit(f"{name}: fp32 loss, kernel path {loss_k} vs plain {loss_p}")
        del g_k, g32
        # train, bf16: the backward kernel against its plain version in the
        # step (the same forward), and both kernels through the tower
        names = [n_ for n_, _ in paths.params if n_ not in zero]
        loss_k, g_k = paths.loss_and_grads("bfloat16", True)
        _, g_b = paths.loss_and_grads("bfloat16", True, plain_bwd=True)
        bwd_cos = cosines(torch, g_k, g_b, names)
        del g_k, g_b
        t_k, t_p = paths.tower_grads(True), paths.tower_grads(False)
        tower = cosines(torch, t_k, t_p, [n_ for n_ in t_p if n_ not in zero])
        del t_k, t_p
        lb, lt = min(bwd_cos, key=bwd_cos.get), min(tower, key=tower.get)
        row.update(train_bf16_loss=loss_k, bwd_kernel_vs_plain_grad_cos_min=bwd_cos[lb],
                   bwd_kernel_vs_plain_grad_cos_min_tensor=lb, tower_grad_cos_min=tower[lt],
                   tower_grad_cos_min_tensor=lt, tower_grad_cos_held=not spec.moe_experts)
        if not (math.isfinite(loss_k) and bwd_cos[lb] > 0.99
                and (spec.moe_experts or tower[lt] > 0.99)):
            raise SystemExit(f"{name}: bf16 kernels disagree with their plain versions: {row}")

        # the paths as configured, driven with the counts zeroed before and
        # read after: the eval forward, then the train step
        model.load_state_dict(state0)
        model.spec = spec

        def evaluate():
            with torch.inference_mode():
                return sm.forward_eval(model, normalize_images(u8e, cfg.INPUT.PIXEL_MEAN,
                                                               cfg.INPUT.PIXEL_STD), cams_e)

        evaluate()
        torch.cuda.synchronize()
        attention_fwd_cuda.launches = attention_bwd_cuda.launches = 0
        t1 = time.perf_counter()
        for _ in range(3):
            evaluate()
        torch.cuda.synchronize()
        row["eval_ms_per_batch"] = (time.perf_counter() - t1) / 3 * 1e3
        row["eval_launches_per_forward"] = attention_fwd_cuda.launches / 3
        driven["attention_fwd"] += attention_fwd_cuda.launches
        optimizer = make_optimizer(model, cfg)
        set_lr(optimizer, *schedule_coeffs(cfg, 1))
        step = make_train_step(model, cfg, C, optimizer, device_augment=True,
                               gen=torch.Generator(device="cuda").manual_seed(4))
        timed = time_train_steps(torch, step, (u8, pids, cams), n=3)
        driven["attention_fwd"] += round(timed["attention_fwd_launches_per_step"] * 3)
        driven["attention_bwd"] += round(timed["attention_bwd_launches_per_step"] * 3)
        driven["attention_bwd_long"] += round(timed["attention_bwd_long_launches_per_step"] * 3)
        row.update(train_ms_per_step=timed["ms_per_step"],
                   train_samples_per_s=timed["samples_per_s"],
                   train_peak_memory_gib=timed["peak_memory_gib"],
                   train_fwd_launches_per_step=timed["attention_fwd_launches_per_step"],
                   train_bwd_launches_per_step=timed["attention_bwd_launches_per_step"],
                   train_bwd_long_launches_per_step=timed[
                       "attention_bwd_long_launches_per_step"],
                   train_losses=timed["losses"],
                   train_device_busy_ms_per_step=device_busy_ms(torch, step, (u8, pids, cams),
                                                                n=1),
                   seconds=time.perf_counter() - t0)
        n = streams * spec.layers
        got = (row["eval_launches_per_forward"], row["train_fwd_launches_per_step"],
               row["train_bwd_launches_per_step"])
        log(f"[variants] {name}: {json.dumps(row)}")
        if got != (n, 2 * n, n):
            raise SystemExit(f"{name}: launches (eval, train fwd, train bwd) {got}, "
                             f"want {(n, 2 * n, n)}")
        long_want = n if tokens > 160 else 0   # the backward's long route past 160 tokens
        if row["train_bwd_long_launches_per_step"] != long_want:
            raise SystemExit(f"{name}: {row['train_bwd_long_launches_per_step']} long-route "
                             f"launches a step, want {long_want}")
        if not all(math.isfinite(x) for x in row["train_losses"]):
            raise SystemExit(f"{name}: non-finite train loss {row['train_losses']}")
        out[name] = row
        del model, optimizer, step, paths, state0, imgs, imgs_e, u8, u8e
        torch.cuda.empty_cache()
    report["variants"] = out
    if min(driven.values()) == 0:
        raise SystemExit(f"the variants left a kernel unlaunched: {driven}")
    return driven


# the other backbones at full width: (name, overrides of
# configs/RGBNT201/Signal.yml, forward / backward kernel launches per eval
# forward and train step: 12 / 24 / 12 where the blocks take the kernel, 0
# where JAX's do not (vit_small's qk scale, T2T, the CNNs))
BACKBONES = [
    ("vit_base", ["MODEL.TRANSFORMER_TYPE", "vit_base_patch16_224"], True),
    ("vit_base_stride12", ["MODEL.TRANSFORMER_TYPE", "vit_base_patch16_224",
                           "MODEL.STRIDE_SIZE", "[12, 12]"], True),
    ("deit_small", ["MODEL.TRANSFORMER_TYPE", "deit_small_patch16_224"], True),
    ("vit_small", ["MODEL.TRANSFORMER_TYPE", "vit_small_patch16_224"], False),
    ("t2t_vit_t_14", ["MODEL.TRANSFORMER_TYPE", "t2t_vit_t_14"], False),
    ("resnet50", ["MODEL.TRANSFORMER_TYPE", "resnet50"], False),
    ("osnet_x1_0", ["MODEL.TRANSFORMER_TYPE", "osnet_x1_0"], False),
]


def base_stats(model):
    """The CNN trunk's BatchNorm running statistics, copied."""
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("base.") and "running_" in k}


def check_backbones(torch, report):
    """Phase 15: each other backbone at full width (random weights from
    SOLVER.SEED; the flagship config but MODEL.TRANSFORMER_TYPE and, where
    named, STRIDE_SIZE). Where the blocks take the kernels, the kernel path
    against the plain-attention path as phases 4 and 6 hold it, in fp32 at
    DROP_PATH 0 (``forward_train`` without a generator draws no masks) and
    in bf16; then the paths as configured, driven with the counts zeroed
    before and read after: ``forward_eval`` at B = 128 and the train step
    at B = 64 (bf16, device augment, Adam, DROP_PATH 0.1 from the config):
    launches per eval forward, train forward and backward (asserted: 12 /
    24 / 12 with the kernel, all 12 backward launches on the long route at
    211 tokens, 0 without), ms by the host clock and device time, peak
    memory, MFU. For the CNNs, the trunk's running statistics move in the
    train step and not in eval. → the driven launches."""
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data.augment import normalize_images
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    C, B_eval = 171, 128
    gen = torch.Generator(device="cuda").manual_seed(15)
    driven = {"attention_fwd": 0, "attention_bwd": 0, "attention_bwd_long": 0}
    out = {}
    for name, opts, kernel in BACKBONES:
        t0 = time.perf_counter()
        cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"), opts)
        B, K = cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.NUM_INSTANCE
        spec = sm.ModelSpec.from_config(cfg, num_classes=C, camera_num=4)
        if spec.attention_kernel != kernel or B != 64 or cfg.MODEL.DROP_PATH != 0.1:
            raise SystemExit(f"{name}: {spec}")
        tokens = spec.h * spec.w + 1
        model = sm.init_signal(spec, seed=cfg.SOLVER.SEED).to("cuda")
        H, W = cfg.INPUT.SIZE_TRAIN
        u8e = torch.randint(0, 256, (B_eval, 3, 3, H, W), dtype=torch.uint8, device="cuda",
                            generator=gen)
        cams_e = torch.randint(0, 4, (B_eval,), device="cuda", generator=gen)
        imgs_e = normalize_images(u8e, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
        u8 = torch.randint(0, 256, (B, 3, 3, H, W), dtype=torch.uint8, device="cuda",
                           generator=gen)
        pids = torch.randperm(C, device="cuda", generator=gen)[:B // K].repeat_interleave(K)
        cams = torch.randint(0, 4, (B,), device="cuda", generator=gen)
        row = {"transformer_type": cfg.MODEL.TRANSFORMER_TYPE, "backbone": spec.backbone,
               "width": spec.width, "layers": spec.layers, "heads": spec.num_heads,
               "tokens": tokens, "feat_dim": spec.feat_dim, "batch_eval": B_eval,
               "batch_train": B, "params_m": sum(p.numel() for p in model.parameters()) / 1e6}
        if kernel:
            imgs = normalize_images(u8, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
            paths = Paths(torch, model, spec, cfg, imgs, pids, cams)

            def features(dtype, use_flash):
                model.spec = dataclasses.replace(spec, compute_dtype=dtype, use_flash=use_flash)
                before = attention_fwd_cuda.launches
                with torch.inference_mode():
                    patches, cls, _ = sm._encode(model, imgs_e, cams_e)
                    feats = sm.forward_eval(model, imgs_e, cams_e)
                torch.cuda.synchronize()
                launched = attention_fwd_cuda.launches - before
                if launched != (2 * spec.layers if use_flash else 0):
                    raise SystemExit(f"{name} eval {dtype} use_flash={use_flash}: {launched} "
                                     f"kernel launches")
                return patches, cls, feats

            # eval, fp32 (phase 4): atol 1e-3 + rtol 1e-3
            _, _, f_k = features("float32", True)
            _, _, f_p = features("float32", False)
            row["eval_fp32_feat_max_abs_err"] = (f_k - f_p).abs().max().item()
            if not torch.allclose(f_k, f_p, atol=1e-3, rtol=1e-3):
                raise SystemExit(f"{name}: fp32 features, kernel vs plain path max abs err "
                                 f"{row['eval_fp32_feat_max_abs_err']} (atol 1e-3 + rtol 1e-3)")
            # eval, bf16 (phase 4): the tower's outputs by cosine > 0.99
            p_k, c_k, f_k = features("bfloat16", True)
            p_p, c_p, _ = features("bfloat16", False)
            cos = torch.nn.functional.cosine_similarity
            row.update(eval_bf16_cls_cos_min=cos(c_k.flatten(0, 1), c_p.flatten(0, 1),
                                                 dim=-1).min().item(),
                       eval_bf16_patch_cos_min=cos(p_k.flatten(0, 2), p_p.flatten(0, 2),
                                                   dim=-1).min().item())
            if min(row["eval_bf16_cls_cos_min"], row["eval_bf16_patch_cos_min"]) <= 0.99:
                raise SystemExit(f"{name}: bf16 eval, kernel vs plain path: {row}")
            del f_k, f_p, p_k, c_k, p_p, c_p
            # train, fp32 at DROP_PATH 0 (phase 6): loss rtol 1e-5, gradients
            loss_k, g_k = paths.loss_and_grads("float32", True)
            loss_p, g32 = paths.loss_and_grads("float32", False)
            worst, zero = hold_fp32(torch, g_k, g32, name)
            row.update(train_fp32_loss_kernel=loss_k, train_fp32_loss_plain=loss_p,
                       train_fp32_grad_max_rel_l2=worst, n_grads=len(g32))
            if not math.isclose(loss_k, loss_p, rel_tol=1e-5):
                raise SystemExit(f"{name}: fp32 loss, kernel path {loss_k} vs plain {loss_p}")
            del g_k, g32
            # train, bf16 (phase 6): the backward kernel against its plain
            # version in the step, both kernels through the tower
            names = [n_ for n_, _ in paths.params if n_ not in zero]
            loss_k, g_k = paths.loss_and_grads("bfloat16", True)
            _, g_b = paths.loss_and_grads("bfloat16", True, plain_bwd=True)
            bwd_cos = cosines(torch, g_k, g_b, names)
            del g_k, g_b
            t_k, t_p = paths.tower_grads(True), paths.tower_grads(False)
            tower = cosines(torch, t_k, t_p, [n_ for n_ in t_p if n_ not in zero])
            del t_k, t_p
            lb, lt = min(bwd_cos, key=bwd_cos.get), min(tower, key=tower.get)
            row.update(train_bf16_loss=loss_k, bwd_kernel_vs_plain_grad_cos_min=bwd_cos[lb],
                       bwd_kernel_vs_plain_grad_cos_min_tensor=lb, tower_grad_cos_min=tower[lt],
                       tower_grad_cos_min_tensor=lt)
            if not (math.isfinite(loss_k) and bwd_cos[lb] > 0.99 and tower[lt] > 0.99):
                raise SystemExit(f"{name}: bf16 kernels disagree with their plain versions: "
                                 f"{row}")
            model.load_state_dict(paths.state0)
            del paths, imgs
        model.spec = spec

        def evaluate():
            with torch.inference_mode():
                return sm.forward_eval(model, normalize_images(u8e, cfg.INPUT.PIXEL_MEAN,
                                                               cfg.INPUT.PIXEL_STD), cams_e)

        feats = evaluate()
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(feats).all())
                and tuple(feats.shape) == (B_eval, spec.eval_feat_dim)):
            raise SystemExit(f"{name}: eval features {tuple(feats.shape)}, finite "
                             f"{bool(torch.isfinite(feats).all())}")
        stats0 = base_stats(model)
        attention_fwd_cuda.launches = attention_bwd_cuda.launches = 0
        t1 = time.perf_counter()
        for _ in range(2):
            evaluate()
        torch.cuda.synchronize()
        row["eval_ms_per_batch"] = (time.perf_counter() - t1) / 2 * 1e3
        row["eval_launches_per_forward"] = attention_fwd_cuda.launches / 2
        driven["attention_fwd"] += attention_fwd_cuda.launches
        row["eval_mfu"] = mfu(torch, spec, B_eval, row["eval_ms_per_batch"])
        eval_moved = any(not torch.equal(v, stats0[k]) for k, v in base_stats(model).items())
        optimizer = make_optimizer(model, cfg)
        set_lr(optimizer, *schedule_coeffs(cfg, 1))
        step = make_train_step(model, cfg, C, optimizer, device_augment=True,
                               gen=torch.Generator(device="cuda").manual_seed(4))
        timed = time_train_steps(torch, step, (u8, pids, cams), n=2)
        for k in ("fwd", "bwd", "bwd_long"):
            key = f"attention_{k}_launches_per_step"
            driven[f"attention_{k}"] += round(timed[key] * 2)
        train_moved = [not torch.equal(v, stats0[k]) for k, v in base_stats(model).items()]
        row.update(train_ms_per_step=timed["ms_per_step"],
                   train_samples_per_s=timed["samples_per_s"],
                   train_peak_memory_gib=timed["peak_memory_gib"],
                   train_fwd_launches_per_step=timed["attention_fwd_launches_per_step"],
                   train_bwd_launches_per_step=timed["attention_bwd_launches_per_step"],
                   train_bwd_long_launches_per_step=timed[
                       "attention_bwd_long_launches_per_step"],
                   train_losses=timed["losses"],
                   train_device_busy_ms_per_step=device_busy_ms(torch, step, (u8, pids, cams),
                                                                n=1))
        row["train_mfu_host"] = mfu(torch, spec, B, row["train_ms_per_step"], train=True)
        row["train_mfu_device"] = mfu(torch, spec, B, row["train_device_busy_ms_per_step"],
                                      train=True)
        if spec.backbone in ("resnet", "osnet"):
            row.update(bn_stats=len(stats0), bn_stats_moved_in_eval=eval_moved,
                       bn_stats_moved_in_train=sum(train_moved))
        row["seconds"] = time.perf_counter() - t0
        log(f"[backbones] {name}: {json.dumps(row)}")
        n = spec.layers if kernel else 0
        got = (row["eval_launches_per_forward"], row["train_fwd_launches_per_step"],
               row["train_bwd_launches_per_step"])
        if got != (n, 2 * n, n):
            raise SystemExit(f"{name}: launches (eval, train fwd, train bwd) {got}, "
                             f"want {(n, 2 * n, n)}")
        long_want = n if tokens > 160 else 0   # the backward's long route past 160 tokens
        if row["train_bwd_long_launches_per_step"] != long_want:
            raise SystemExit(f"{name}: {row['train_bwd_long_launches_per_step']} long-route "
                             f"launches a step, want {long_want}")
        if not all(math.isfinite(x) for x in row["train_losses"]):
            raise SystemExit(f"{name}: non-finite train loss {row['train_losses']}")
        if spec.backbone in ("resnet", "osnet") and (eval_moved or not all(train_moved)):
            raise SystemExit(f"{name}: the trunk's running statistics moved in eval "
                             f"({eval_moved}) or not all in the train step "
                             f"({sum(train_moved)} of {len(train_moved)})")
        out[name] = row
        del model, optimizer, step, imgs_e, u8, u8e, feats
        torch.cuda.empty_cache()
    report["backbones"] = out
    return driven


def run_backbone_entry_points(torch, report):
    """Phase 15, end to end: ``cli.train_main`` (one epoch and its eval)
    then ``cli.test_main`` on the synthetic config at full width with
    MODEL.TRANSFORMER_TYPE vit_base_patch16_224 (the kernels: forward and
    backward launches > 0) and resnet50 (none). → the launches."""
    from signal_tpu_torch.cli import test_main, train_main
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda

    work = REPO / "build" / "chip_smoke_backbones"
    shutil.rmtree(work, ignore_errors=True)
    driven = {"attention_fwd": 0, "attention_bwd": 0}
    out = {}
    for ttype, kernel in (("vit_base_patch16_224", True), ("resnet50", False)):
        opts = ["MODEL.DEVICE", "cuda", "MODEL.TRANSFORMER_TYPE", ttype, "OUTPUT_DIR",
                str(work / ttype)]
        attention_fwd_cuda.launches = attention_bwd_cuda.launches = 0
        t0 = time.perf_counter()
        state = train_main(["--config_file", str(REPO / "configs/synthetic/smoke.yml")] + opts
                           + ["SOLVER.MAX_EPOCHS", "1", "SOLVER.EVAL_PERIOD", "1"])
        cmc, mAP = test_main(["--config_file", str(REPO / "configs/synthetic/smoke.yml")]
                             + opts + ["TEST.IMS_PER_BATCH", "8"])
        torch.cuda.synchronize()
        row = {"loss": state.loss, "train_mAP": state.mAP, "test_mAP": float(mAP),
               "test_rank1": float(cmc[0]), "seconds": time.perf_counter() - t0,
               "attention_fwd_launches": attention_fwd_cuda.launches,
               "attention_bwd_launches": attention_bwd_cuda.launches}
        log(f"[backbones] train_main + test_main {ttype}: {json.dumps(row)}")
        if not all(math.isfinite(x) for x in (row["loss"], row["train_mAP"], row["test_mAP"])):
            raise SystemExit(f"{ttype}: non-finite loss or mAP: {row}")
        launched = min(row["attention_fwd_launches"], row["attention_bwd_launches"]) > 0
        if launched != kernel or (not kernel and row["attention_fwd_launches"]):
            raise SystemExit(f"{ttype}: kernel launches {row}")
        driven["attention_fwd"] += row["attention_fwd_launches"]
        driven["attention_bwd"] += row["attention_bwd_launches"]
        out[ttype] = row
    shutil.rmtree(work)
    report["backbones_e2e"] = out
    return driven


# CLIP-ReID's metric-loss zoo on the card against the CPU (phase 16): (name,
# function of (module, feats [3, B, D], weight [C, D], class labels, PK
# labels, K), the norm its rows are scaled to or None, the head's scale s
# or None)
METRIC_LOSSES = [
    ("arcface", lambda m, f, w, c, y, k: m.arcface_logits({"weight": w}, f[0], c), None, 30.0),
    ("arcface_easy_ls", lambda m, f, w, c, y, k: m.arcface_logits(
        {"weight": w}, f[0], c, easy_margin=True, ls_eps=0.1), None, 30.0),
    ("cosface", lambda m, f, w, c, y, k: m.cosface_logits({"weight": w}, f[0], c), None, 30.0),
    ("amsoftmax", lambda m, f, w, c, y, k: m.amsoftmax_logits({"weight": w}, f[0], c), None,
     30.0),
    ("circle", lambda m, f, w, c, y, k: m.circle_logits({"weight": w}, f[0], c), None, 256.0),
    # the self pair is dropped by sim < 1, which turns on one rounding at
    # unit norm: rows just inside and just outside it
    ("contrastive_self_pairs_in", lambda m, f, w, c, y, k: m.contrastive_loss(f[0], y), 0.99,
     None),
    ("contrastive_self_pairs_out", lambda m, f, w, c, y, k: m.contrastive_loss(f[0], y), 1.01,
     None),
    ("cluster", lambda m, f, w, c, y, k: m.cluster_loss(f[0], k), None, None),
    ("range", lambda m, f, w, c, y, k: m.range_loss(f[0], k), None, None),
    ("hetero_l2", lambda m, f, w, c, y, k: m.hetero_center_loss(f[0], f[1], k, "l2"), None, None),
    ("hetero_l1", lambda m, f, w, c, y, k: m.hetero_center_loss(f[0], f[1], k, "l1"), None, None),
    ("hetero_cos", lambda m, f, w, c, y, k: m.hetero_center_loss(f[0], f[1], k, "cos"), None,
     None),
    ("multi_modal_margin", lambda m, f, w, c, y, k: m.multi_modal_margin_loss(f[0], f[1], f[2], k),
     None, None),
]


def clipreid_loss(torch, model, imgs, cams, pids, text_all, margin, mark=lambda: None):
    """The CLIP-ReID loss this script trains with (composed here from the
    port's pieces, as the CPU tests compose it): cross entropy on both
    scores, triplet on the three features, image-to-text cross entropy
    against every class's text features ``text_all``, and SupCon both ways
    between the batch's text features (through the prompt learner and the
    text tower) and the projected image features. ``mark()`` is called
    after the image forward and after the text forward (stage timing)."""
    from signal_tpu_torch.losses import cross_entropy, i2t_cross_entropy, supcon_loss, \
        triplet_loss
    from signal_tpu_torch.models import clipreid as cr

    scores, feats, proj = cr.clipreid_forward_train(model, imgs, cams)
    mark()
    text_b = cr.clipreid_text_features(model, pids)
    mark()
    return (sum(cross_entropy(s, pids) for s in scores)
            + sum(triplet_loss(f, pids, margin)[0] for f in feats)
            + i2t_cross_entropy(proj, text_all, pids)
            + supcon_loss(text_b, proj, pids, pids) + supcon_loss(proj, text_b, pids, pids))


def profile_by_kind(torch, fn, iters: int = 3) -> dict:
    """``fn()`` ``iters`` times under ``torch.profiler`` (after a warm-up
    call) → ms per call by the host clock, the device's busy ms per call
    in all and by kind (``scripts/profile_torch_train.kind_of``), its idle
    share over the window, launches per call."""
    from torch.autograd import DeviceType

    if str(REPO / "scripts") not in sys.path:
        sys.path.insert(0, str(REPO / "scripts"))
    from profile_torch_train import kind_of

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device events only; the optimizer's step annotation spans its kernels
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    by_kind = {}
    for e in events:
        kind = kind_of(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3 / iters
    busy = sum(by_kind.values())
    return {"window_ms_per_call": window_ms / iters, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy * iters / window_ms,
            "launches_per_call": sum(e.count for e in events) / iters,
            "ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]))}


def check_clipreid(torch, report):
    """Phase 16: CLIP-ReID at full width (random weights from SOLVER.SEED,
    bf16, the flagship config's 256×128 input and SIE, RGBNT201's 171
    classes, the tokenizer on the port's vocabulary). Eval
    (``clipreid_forward_eval`` at B = 128, NECK_FEAT before and after) and
    one train step at B = 64 (PK 8 × 8; the loss of :func:`clipreid_loss`,
    Adam): the kernel path against the plain-attention path as phases 4
    and 6 hold them, then the paths as configured, driven with the counts
    zeroed before and read after: ms (host clock and device time), peak
    memory, launches (12 a forward, 24 + 12 a step), and eval's MFU
    (``utils/flops.cost_analysis`` of the products and the convolution,
    plus the attention kernel's 4·B·L²·D a block, which no counter sees);
    each path's device time by kind (:func:`profile_by_kind`) and the
    step's by stage. The text features of all 171 classes
    (ms, finite, causal); the metric losses on the card against the CPU;
    a CLIP archive with both halves imported. → the driven launches."""
    import torch.nn.functional as F

    from signal_tpu_torch import losses_metric as lm
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.data.augment import normalize_images
    from signal_tpu_torch.models import clipreid as cr
    from signal_tpu_torch.models.clip_loader import load_clip_into_clipreid
    from signal_tpu_torch.models.text_encoder import prompt_forward, text_forward
    from signal_tpu_torch.models.tokenizer import ClipTokenizer
    from signal_tpu_torch.ops import flash_attention as fa
    from signal_tpu_torch.ops.attention import true_fp32
    from signal_tpu_torch.utils.flops import cost_analysis, peak_flops_per_chip

    t_phase = time.perf_counter()
    cfg = load_config(str(REPO / "configs/RGBNT201/Signal.yml"))
    C, B_eval, B, K = 171, cfg.TEST.IMS_PER_BATCH, cfg.SOLVER.IMS_PER_BATCH, \
        cfg.DATALOADER.NUM_INSTANCE
    spec = cr.ClipReIDSpec.from_config(cfg, num_classes=C, camera_num=4)
    tok = ClipTokenizer()
    if not ((B_eval, B, K) == (128, 64, 8) and tok.has_merges and spec.use_flash
            and spec.compute_dtype == "bfloat16" and spec.sie_camera
            and (spec.width, spec.layers, spec.num_heads, spec.proj_dim, spec.h, spec.w,
                 spec.text_width, spec.text_layers) == (768, 12, 12, 512, 16, 8, 512, 12)):
        raise SystemExit(f"phase 16's configuration: {spec}, batches {(B_eval, B, K)}")
    model = cr.ClipReID(spec, gen=torch.Generator().manual_seed(cfg.SOLVER.SEED),
                        tokenizer=tok).to("cuda")
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(16)
    H, W = cfg.INPUT.SIZE_TRAIN

    def images(n):
        u8 = torch.randint(0, 256, (n, 3, H, W), dtype=torch.uint8, device="cuda", generator=gen)
        return normalize_images({"RGB": u8}, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)["RGB"]

    imgs_e, cams_e = images(B_eval), torch.randint(0, 4, (B_eval,), device="cuda", generator=gen)
    imgs, cams = images(B), torch.randint(0, 4, (B,), device="cuda", generator=gen)
    pids = torch.randperm(C, device="cuda", generator=gen)[:B // K].repeat_interleave(K)
    margin = None if cfg.MODEL.NO_MARGIN else cfg.SOLVER.MARGIN
    tokens = spec.h * spec.w + 1
    out = {"params_m": sum(p.numel() for p in model.parameters()) / 1e6, "tokens": tokens,
           "batch_eval": B_eval, "batch_train": B}
    cos = F.cosine_similarity

    # eval: the kernel path against the plain path (phase 4's tolerances)
    def features(dtype, use_flash, neck):
        model.spec = dataclasses.replace(spec, compute_dtype=dtype, use_flash=use_flash,
                                         neck_feat=neck)
        before = fa.attention_fwd_cuda.launches
        with torch.inference_mode(), true_fp32():
            f = cr.clipreid_forward_eval(model, imgs_e, cams_e)
        torch.cuda.synchronize()
        launched = fa.attention_fwd_cuda.launches - before
        if launched != (spec.layers if use_flash else 0):
            raise SystemExit(f"CLIP-ReID eval {dtype} use_flash={use_flash}: {launched} "
                             f"kernel launches")
        if tuple(f.shape) != (B_eval, spec.width + spec.proj_dim) or f.dtype != torch.float32 \
                or not bool(torch.isfinite(f).all()):
            raise SystemExit(f"CLIP-ReID eval {dtype} {neck}: features {tuple(f.shape)} "
                             f"{f.dtype}, finite {bool(torch.isfinite(f).all())}")
        return f

    for neck in ("before", "after"):
        f_k, f_p = features("float32", True, neck), features("float32", False, neck)
        out[f"eval_fp32_{neck}_max_abs_err"] = (f_k - f_p).abs().max().item()
        if not torch.allclose(f_k, f_p, atol=1e-3, rtol=1e-3):
            raise SystemExit(f"CLIP-ReID fp32 features ({neck}): kernel vs plain path max abs "
                             f"err {out[f'eval_fp32_{neck}_max_abs_err']} (atol 1e-3 + rtol 1e-3)")
        f_k, f_p = features("bfloat16", True, neck), features("bfloat16", False, neck)
        out[f"eval_bf16_{neck}_cos_min"] = cos(f_k, f_p, dim=-1).min().item()
        if out[f"eval_bf16_{neck}_cos_min"] <= 0.99:
            raise SystemExit(f"CLIP-ReID bf16 features ({neck}): kernel vs plain path cosine "
                             f"{out[f'eval_bf16_{neck}_cos_min']} (> 0.99)")
    del f_k, f_p

    # the text tower: every class's features, and causality in fp32
    model.spec = spec
    labels = torch.arange(C, device="cuda")

    def text_all():
        with torch.inference_mode():
            return cr.clipreid_text_features(model, labels)

    t_all = text_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        t_all = text_all()
    torch.cuda.synchronize()
    out["text_ms_171_classes"] = (time.perf_counter() - t0) / 3 * 1e3
    if tuple(t_all.shape) != (C, spec.proj_dim) or not bool(torch.isfinite(t_all).all()):
        raise SystemExit(f"CLIP-ReID text features {tuple(t_all.shape)}, finite "
                         f"{bool(torch.isfinite(t_all).all())}")
    with torch.inference_mode(), true_fp32():
        prompts, tokenized = prompt_forward(model.prompt_learner, labels)
        eot = int(tokenized[0].argmax())
        kick = 10.0 * torch.randn(spec.text_width, device="cuda", generator=gen)
        later, earlier = prompts.clone(), prompts.clone()
        later[:, eot + 1] += kick
        earlier[:, eot - 1] += kick
        base, after_eot, before_eot = (
            text_forward(model.text, p, tokenized, num_heads=cr.TEXT_HEADS,
                         compute_dtype=torch.float32) for p in (prompts, later, earlier))
    out["text_fp32_after_eot_max_abs_change"] = (after_eot - base).abs().max().item()
    out["text_fp32_before_eot_max_abs_change"] = (before_eot - base).abs().max().item()
    if out["text_fp32_after_eot_max_abs_change"] > 1e-5 or \
            out["text_fp32_before_eot_max_abs_change"] < 1e-3:
        raise SystemExit(f"CLIP-ReID text tower not causal: {out}")
    del prompts, later, earlier, base, after_eot, before_eot

    # one train step: the kernel path against the plain path (phase 6's
    # tolerances), the backward kernel against its plain version in bf16
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def loss_and_grads(dtype, use_flash, plain_bwd=False):
        kernel = fa.attention_bwd_cuda
        model.load_state_dict(state0)             # the BNNecks' statistics move
        model.spec = dataclasses.replace(spec, compute_dtype=dtype, use_flash=use_flash)
        text = text_all().clone()
        fwd, bwd = fa.attention_fwd_cuda.launches, kernel.launches
        if plain_bwd:
            fa.attention_bwd_cuda = fa.flash_attention_bwd_reference
        try:
            with true_fp32():
                loss = clipreid_loss(torch, model, imgs, cams, pids, text, margin)
                grads = torch.autograd.grad(loss, [p for _, p in params], allow_unused=True)
            torch.cuda.synchronize()
        finally:
            fa.attention_bwd_cuda = kernel
        launched = (fa.attention_fwd_cuda.launches - fwd, kernel.launches - bwd)
        want = (2 * spec.layers, 0 if plain_bwd else spec.layers) if use_flash else (0, 0)
        if launched != want:
            raise SystemExit(f"CLIP-ReID train {dtype} use_flash={use_flash}: (fwd, bwd) "
                             f"launches {launched}, want {want}")
        return loss.item(), {n: (torch.zeros_like(p) if g is None else g)
                             for (n, p), g in zip(params, grads)}

    loss_k, g_k = loss_and_grads("float32", True)
    loss_p, g32 = loss_and_grads("float32", False)
    worst, zero = hold_fp32(torch, g_k, g32, "phase 16")
    out.update(train_fp32_loss_kernel=loss_k, train_fp32_loss_plain=loss_p,
               train_fp32_grad_max_rel_l2=worst, n_grads=len(g32), zero_grads=zero)
    if not math.isclose(loss_k, loss_p, rel_tol=1e-5):
        raise SystemExit(f"CLIP-ReID fp32 loss: kernel path {loss_k} vs plain path {loss_p}")
    del g_k
    names = [n for n in g32 if n not in zero]
    loss_k, g_k = loss_and_grads("bfloat16", True)
    loss_p, g_p = loss_and_grads("bfloat16", False)
    step_cos = cosines(torch, g_k, g_p, names)
    vs32 = cosines(torch, g_k, g32, names)
    del g_p, g32
    _, g_b = loss_and_grads("bfloat16", True, plain_bwd=True)
    bwd_cos = cosines(torch, g_k, g_b, names)
    del g_k, g_b
    low = {k: min(c, key=c.get) for k, c in (("step", step_cos), ("bwd", bwd_cos),
                                             ("k32", vs32))}
    out.update(train_bf16_loss_kernel=loss_k, train_bf16_loss_plain=loss_p,
               bwd_kernel_vs_plain_grad_cos_min=bwd_cos[low["bwd"]],
               bwd_kernel_vs_plain_grad_cos_min_tensor=low["bwd"],
               step_kernel_vs_plain_path_grad_cos_min=step_cos[low["step"]],
               step_kernel_vs_plain_path_grad_cos_min_tensor=low["step"],
               kernel_path_vs_fp32_grad_cos_min=vs32[low["k32"]])
    if not (math.isfinite(loss_k) and bwd_cos[low["bwd"]] > 0.99):
        raise SystemExit(f"CLIP-ReID bf16 step: the backward kernel disagrees with its plain "
                         f"version: {out}")
    model.load_state_dict(state0)
    model.spec = spec
    log(f"[clipreid] kernel vs plain: {json.dumps(out)}")

    # the paths as configured (bf16, kernels): eval, then the train step
    driven = {"attention_fwd": 0, "attention_bwd": 0}

    def evaluate(neck):
        model.spec = dataclasses.replace(spec, neck_feat=neck)
        with torch.inference_mode():
            return cr.clipreid_forward_eval(model, imgs_e, cams_e)

    peak_flops = peak_flops_per_chip(torch.cuda.get_device_name(0))
    attn_flops = 4 * B_eval * tokens * tokens * spec.width * spec.layers
    for neck in ("before", "after"):
        evaluate(neck)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.attention_fwd_cuda.launches = 0
        t0 = time.perf_counter()
        for _ in range(3):
            evaluate(neck)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        per_fwd = fa.attention_fwd_cuda.launches / 3
        driven["attention_fwd"] += fa.attention_fwd_cuda.launches
        flops = cost_analysis(evaluate, neck)["flops"]
        busy = device_busy_ms(torch, lambda n: (evaluate(n),), (neck,), n=2)
        out[f"eval_{neck}"] = {
            "ms_per_batch": ms, "samples_per_s": B_eval / ms * 1e3, "device_busy_ms": busy,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches_per_forward": per_fwd, "counted_tflop": flops / 1e12,
            "attention_kernel_tflop": attn_flops / 1e12,
            "mfu_host": (flops + attn_flops) / (ms / 1e3) / peak_flops,
            "mfu_device": (flops + attn_flops) / (busy / 1e3) / peak_flops}
        if per_fwd != spec.layers:
            raise SystemExit(f"CLIP-ReID eval ({neck}): {per_fwd} launches a forward, "
                             f"want {spec.layers}")
    model.spec = spec
    optimizer = torch.optim.Adam([p for _, p in params], lr=5e-6, weight_decay=1e-4)
    text = text_all().clone()              # once, without grad (CLIP-ReID's stage 2)

    def step(imgs, pids):
        optimizer.zero_grad(set_to_none=True)
        loss = clipreid_loss(torch, model, imgs, cams, pids, text, margin)
        loss.backward()
        optimizer.step()
        return (loss.detach(),)

    timed = time_train_steps(torch, step, (imgs, pids), n=3)
    driven["attention_fwd"] += round(timed["attention_fwd_launches_per_step"] * 3)
    driven["attention_bwd"] += round(timed["attention_bwd_launches_per_step"] * 3)
    out["train_step"] = dict(timed, device_busy_ms_per_step=device_busy_ms(
        torch, step, (imgs, pids), n=1))
    # where the time goes: each path under the profiler, by kind, and the
    # step's stages by CUDA events (which count the device's waits too)
    model.spec = dataclasses.replace(spec, neck_feat="before")
    out["by_kind"] = {"eval": profile_by_kind(torch, lambda: evaluate("before")),
                      "text": profile_by_kind(torch, text_all),
                      "train": profile_by_kind(torch, lambda: step(imgs, pids))}
    stages = dict.fromkeys(("image_forward_and_heads", "text_forward", "losses", "backward",
                            "adam"), 0.0)
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        marks = iter(ev)
        optimizer.zero_grad(set_to_none=True)
        next(marks).record()
        loss = clipreid_loss(torch, model, imgs, cams, pids, text, margin,
                             mark=lambda: next(marks).record())
        next(marks).record()
        loss.backward()
        next(marks).record()
        optimizer.step()
        next(marks).record()
        torch.cuda.synchronize()
        for i, name in enumerate(stages):
            stages[name] += ev[i].elapsed_time(ev[i + 1]) / 3
    out["train_step"]["stage_ms"] = stages
    if (timed["attention_fwd_launches_per_step"], timed["attention_bwd_launches_per_step"]) \
            != (2 * spec.layers, spec.layers) or not all(math.isfinite(x)
                                                         for x in timed["losses"]):
        raise SystemExit(f"CLIP-ReID train step: {out['train_step']}")
    log(f"[clipreid] eval and train step bf16: "
        f"{json.dumps({k: out[k] for k in ('eval_before', 'eval_after', 'train_step')})}")
    log(f"[clipreid] device time by kind: {json.dumps(out['by_kind'])}")
    del optimizer

    # the metric losses on the card against the CPU, fp32
    rows = {}
    for D in (768, 512):
        g = torch.Generator().manual_seed(D)
        feats = torch.randn(3, B, D, generator=g)
        weight = torch.randn(C, D, generator=g)
        clabels = torch.randint(0, C, (B,), generator=g)
        pk = torch.arange(B // K).repeat_interleave(K)
        for name, fn, norm, s in METRIC_LOSSES:
            f = feats if norm is None else norm * F.normalize(feats, dim=-1)
            got, want = [], []
            for dev, store in (("cuda", got), ("cpu", want)):
                xs = [t.detach().to(dev).requires_grad_(True) for t in (f, weight)]
                with true_fp32():
                    o = fn(lm, xs[0], xs[1], clabels.to(dev), pk.to(dev), K)
                    o = o if isinstance(o, tuple) else (o,)
                    cot = [torch.randn(t.shape, generator=torch.Generator().manual_seed(1))
                           .to(dev) for t in o]
                    grads = torch.autograd.grad(sum((a * c).sum() for a, c in zip(o, cot)), xs,
                                                allow_unused=True)
                store += [t.detach().cpu() for t in o]
                store += [torch.zeros_like(x).cpu() if gr is None else gr.cpu()
                          for x, gr in zip(xs, grads)]
            atol = 1e-6 if s is None else 1e-6 + s * 2.0 ** -22
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            ok = all(torch.allclose(a, b, rtol=1e-5, atol=atol) for a, b in zip(got, want))
            rows[f"{name}_d{D}"] = {"max_abs_err": err, "atol": atol, "rtol": 1e-5}
            if not ok:
                raise SystemExit(f"metric loss {name} at D {D}: the card against the CPU "
                                 f"max abs err {err} (rtol 1e-5 + atol {atol})")
    out["metric_losses"] = rows
    log(f"[clipreid] metric losses, card vs CPU (fp32, B {B}, C {C}): "
        f"largest max abs err {max(r['max_abs_err'] for r in rows.values())} over "
        f"{len(rows)} cases")

    # a CLIP archive with both halves at their published shapes
    work = REPO / "build" / "chip_smoke_clipreid"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    src = write_clip_archive(torch, work / "ViT-B-16.pt", text=True)
    load_clip_into_clipreid(model, str(work / "ViT-B-16.pt"), tokenizer=tok)
    from signal_tpu_torch.models.vit import resize_pos_embed

    bad = [k for k, v in model.base.state_dict().items()
           if not torch.equal(v.cpu(), resize_pos_embed(src[f"visual.{k}"].float(), spec.h, spec.w)
                              if k == "positional_embedding" else src[f"visual.{k}"].float())]
    bad += [k for k, v in model.text.state_dict().items() if not torch.equal(v.cpu(),
                                                                             src[k].float())]
    emb = model.text.token_embedding.weight[model.prompt_learner.tokenized]
    if bad or not torch.equal(model.prompt_learner.token_prefix, emb[:5]):
        raise SystemExit(f"the CLIP import differs from the archive: {bad[:5]}")
    out["clip_import"] = {"archive_mb": (work / "ViT-B-16.pt").stat().st_size / 2 ** 20,
                          "tensors": len(src), "seconds": time.perf_counter() - t0}
    shutil.rmtree(work)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[clipreid] CLIP import: {json.dumps(out['clip_import'])}; phase 16 in "
        f"{out['seconds']:.1f} s")
    report["clipreid"] = out
    del model
    torch.cuda.empty_cache()
    return driven


def run_main_path(torch, report):
    """Phase 5: the test CLI end to end on the synthetic config."""
    from signal_tpu_torch.cli import test_main
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    out_dir = REPO / "chiprun_out" / "chip_smoke"
    attention_fwd_cuda.launches = 0
    t0 = time.perf_counter()
    # the synthetic split's 16 query + gallery samples as two requests of 8
    cmc, mAP = test_main(["--config_file", str(REPO / "configs/synthetic/smoke.yml"),
                          "MODEL.DEVICE", "cuda", "TEST.IMS_PER_BATCH", "8",
                          "OUTPUT_DIR", str(out_dir)])
    torch.cuda.synchronize()
    launches = attention_fwd_cuda.launches
    e2e = {"mAP": float(mAP), "rank1": float(cmc[0]), "rank5": float(cmc[4]),
           "seconds": time.perf_counter() - t0, "attention_launches": launches}
    log(f"[e2e] test_main synthetic: {json.dumps(e2e)}")
    if not (math.isfinite(e2e["mAP"]) and all(math.isfinite(float(c)) for c in cmc)):
        raise SystemExit(f"non-finite metrics: {e2e}")
    if launches == 0:
        raise SystemExit("the main path launched no attention kernel")
    report["e2e"] = e2e
    return launches


def main() -> int:
    if not (REPO / "signal_tpu_torch").is_dir():
        print("chip_smoke.py runs from a checkout of the repository "
              "(signal_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py measures the port on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    report = {"device": name, "nvidia_smi": smi, "torch": torch.__version__}

    from signal_tpu_torch.utils.flops import peaks_for

    check_build(torch, report)
    peaks = peaks_for(name)
    rows = check_attention(torch, report, peaks)
    bwd = check_attention_bwd(torch, report, peaks)
    check_slice(torch, report)
    eval_launches = run_main_path(torch, report)
    check_train_step(torch, report)
    train_launches = run_train_path(torch, report)
    recipe_launches = run_recipe_path(torch, report)
    check_accumulation(torch, report)
    check_remat_policies(torch, report)
    check_reranking(torch, report)
    artifact, artifact_ms, serving_launches = check_serving(torch, report)
    check_host_data(torch, report, artifact, artifact_ms)
    variant_launches = check_variants(torch, report)
    backbone_launches = check_backbones(torch, report)
    backbone_e2e = run_backbone_entry_points(torch, report)
    clipreid_launches = check_clipreid(torch, report)

    def entry(kernel, source, replaces, rows, launches):
        bf16, fp32 = rows["main-bf16"], rows["main-fp32"]
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": bf16["max_abs_err"],
                "max_abs_err_bf16": bf16["max_abs_err"], "max_abs_err_fp32": fp32["max_abs_err"],
                "ms": bf16["ms"], "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
                "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
                "tflops": bf16["tflops"], "shape": bf16["shape"], "ms_fp32": fp32["ms"],
                "bound_ms_fp32": fp32["bound_ms"], "library_ms_fp32": fp32["library_ms"]}

    fwd = entry("attention_fwd", "signal_tpu_torch/csrc/attention_fwd.cu",
                "signal_tpu/ops/flash_attention.py:50", rows, train_launches["attention_fwd"])
    fwd.update(launches_eval=eval_launches, launches_recipe=recipe_launches["attention_fwd"],
               launches_serving=serving_launches,
               ms_train_shape=rows["train-bf16"]["ms"],
               bound_ms_train_shape=rows["train-bf16"]["bound_ms"])
    bwd_entry = entry("attention_bwd", "signal_tpu_torch/csrc/attention_bwd.cu",
                      "signal_tpu/ops/flash_attention.py:123", bwd,
                      train_launches["attention_bwd"])
    fwd["launches_variants"] = variant_launches["attention_fwd"]
    fwd.update({f"ms_len{L}": rows[f"len{L}-bf16"]["ms"] for L in LONG_LENGTHS})
    fwd.update({f"bound_ms_len{L}": rows[f"len{L}-bf16"]["bound_ms"] for L in LONG_LENGTHS})
    fwd.update({f"library_ms_len{L}": rows[f"len{L}-bf16"]["library_ms"] for L in LONG_LENGTHS})
    fwd["library_ms_train_shape"] = rows["train-bf16"]["library_ms"]
    bwd_entry["launches_recipe"] = recipe_launches["attention_bwd"]
    bwd_entry["launches_variants"] = variant_launches["attention_bwd"]
    # phase 15: the other backbones' driven paths and their entry points
    fwd["launches_backbones"] = backbone_launches["attention_fwd"]
    fwd["launches_backbones_e2e"] = backbone_e2e["attention_fwd"]
    bwd_entry["launches_backbones"] = backbone_launches["attention_bwd"]
    bwd_entry["launches_backbones_e2e"] = backbone_e2e["attention_bwd"]
    # phase 16: CLIP-ReID's driven eval and train step, and its shapes
    fwd["launches_clipreid"] = clipreid_launches["attention_fwd"]
    bwd_entry["launches_clipreid"] = clipreid_launches["attention_bwd"]
    for kernel_rows, entry_ in ((rows, fwd), (bwd, bwd_entry)):
        for n in [n for n in kernel_rows if n.startswith(("d384", "clipreid"))]:
            tag = n.removesuffix("-bf16").replace("-", "_")
            for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
                        "tflops", "shape"):
                entry_[f"{key}_{tag}"] = kernel_rows[n][key]
    long_rows = {n: r for n, r in bwd.items()
                 if r["dtype"] == "bfloat16" and max(r["shape"][1:3]) > 160}
    bwd_entry["max_abs_err_long_route"] = max(r["max_abs_err"] for r in long_rows.values())
    for n in ("long211-bf16", "long193-bf16"):
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "tflops", "shape"):
            bwd_entry[f"{key}_{n.removesuffix('-bf16')}"] = bwd[n][key]
    # the long route past 160 tokens (two kernels a launch), at STRIDE_SIZE
    # 12's shape; its launches are those of phase 14's driven paths
    long211, long193 = bwd["long211-bf16"], bwd["long193-bf16"]
    long_entry = {
        "name": "attention_bwd_long_route", "route": "cuda",
        "source": "signal_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "signal_tpu/ops/flash_attention.py:123",
        "kernels": ["attention_bwd_stats_mma_kernel", "attention_bwd_long_mma_kernel"],
        "launches": variant_launches["attention_bwd_long"],
        "launches_backbones": backbone_launches["attention_bwd_long"],
        "max_abs_err": bwd_entry["max_abs_err_long_route"],
        **{key: long211[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "tflops", "shape")},
        **{f"{key}_long193": long193[key] for key in ("ms", "plain_ms", "bound_ms",
                                                      "library_ms", "tflops", "shape")},
        "repeat_bit_identical": long211["repeat_bit_identical"],
        "ptxas": {short: report["build"][short] for short in report["build"]
                  if "stats_mma" in short or "long_mma" in short},
    }
    kernels = [fwd, bwd_entry, long_entry]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
