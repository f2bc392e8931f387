#!/usr/bin/env python3
"""Drive the PyTorch port (signal_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card, nvcc

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port from ``signal_tpu_torch/csrc``,
     one nvcc per source, all started together;
  3. kernels vs plain: each kernel's wrapper (attention forward and
     backward) against its plain PyTorch version on the card, at the main
     paths' shapes and at odd ones, with the tolerance stated; kernel,
     plain and library times (CUDA events);
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
     bf16 loss and per-tensor gradient cosines), 24 forward and 12
     backward kernel launches per step, ms/step, samples/s, peak memory;
  7. train end to end: ``signal_tpu_torch.cli.train_main`` on
     configs/synthetic/smoke.yml at full width, two epochs and an eval →
     finite loss and mAP.
Phases 5 and 7 are the main paths: every launch count is zeroed just
before each and read just after. Then the script prints the kernel table
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

# published peaks by card (NVIDIA data sheets, dense): bytes/s of device
# memory, FLOP/s for bf16 on the tensor cores and for fp32 outside them
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100": (3.35e12, 989e12, 67e12),       # SXM (HBM3)
    "H200": (4.8e12, 989e12, 67e12),
}

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


def peaks_for(name: str):
    for key, vals in PEAKS.items():
        if key in name:
            return vals
    raise SystemExit(f"no published peaks for {name!r}; add them to PEAKS")


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
    ]
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
        if name.startswith(("main", "train")):
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
        rows[name] = row
        log(f"[kernel] attention_fwd {name}: {json.dumps(row)}")
        if not ok:
            raise SystemExit(f"attention_fwd {name} disagrees with its plain version: "
                             f"max abs err {row['max_abs_err']} ({tol_text})")
        del q, k, v, got, want, err
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
    ]
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
        if name.startswith("main"):
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
            del qh, kh, vh, o, gh
        rows[name] = row
        log(f"[kernel] attention_bwd {name}: {json.dumps(row)}")
        if not ok:
            raise SystemExit(f"attention_bwd {name} disagrees with its plain version: "
                             f"max abs err {row['max_abs_err']} ({tol_text})")
        del q, k, v, g, got, want, errs
    report["attention_bwd"] = rows
    return rows


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
            patches, cls = sm._encode(model, imgs, cams)
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
                           "attention_launches_per_forward": per_fwd}
    log(f"[slice] flagship forward_eval bf16 B={B}: {json.dumps(out['bf16_forward'])}")
    if per_fwd != spec.layers:
        raise SystemExit(f"{per_fwd} attention launches per forward, want {spec.layers}")
    report["slice"] = out
    del model


def check_train_step(torch, report):
    """Phase 6: the flagship train step, kernel path vs plain-attention path."""
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
    loss_fn = make_loss(cfg, C)
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}

    def loss_and_grads(dtype: str, use_flash: bool):
        model.load_state_dict(state0)        # the BNNecks' running stats move
        model.spec = dataclasses.replace(spec, compute_dtype=dtype, use_flash=use_flash)
        fwd, bwd = attention_fwd_cuda.launches, attention_bwd_cuda.launches
        with true_fp32():
            o = sm.forward_train(model, imgs, cams)
            loss = total_train_loss(o, pids, loss_fn, gram_weight=cfg.MODEL.Gram_Loss_weight,
                                    pat_weight=cfg.MODEL.PAT_Loss_weight)
            grads = torch.autograd.grad(loss, [p for _, p in params], allow_unused=True)
        torch.cuda.synchronize()
        launched = (attention_fwd_cuda.launches - fwd, attention_bwd_cuda.launches - bwd)
        want = (2 * spec.layers, spec.layers) if use_flash else (0, 0)
        if launched != want:
            raise SystemExit(f"train {dtype} use_flash={use_flash}: (fwd, bwd) launches "
                             f"{launched}, want {want}")
        return loss.item(), {n: (torch.zeros_like(p) if g is None else g)
                             for (n, p), g in zip(params, grads)}

    # fp32: the paths differ in where the scale is applied and in summation
    # order; held per tensor by allclose(rtol 1e-3, atol 1e-4·max|g_plain|)
    loss_k, g_k = loss_and_grads("float32", True)
    loss_p, g_p = loss_and_grads("float32", False)
    worst, zero = 0.0, []
    for n in g_p:
        a, b = g_k[n], g_p[n]
        if b.norm().item() < 1e-6:
            # analytically zero (SIM's W_q/W_k feed only the top-k; a bias
            # in front of a BatchNorm): rounding noise on both paths
            zero.append(n)
            if a.norm().item() >= 1e-5:
                raise SystemExit(f"fp32 gradient of {n}: zero on the plain path, "
                                 f"norm {a.norm().item()} on the kernel path")
            continue
        scale = b.abs().max().item()
        worst = max(worst, ((a - b).norm() / b.norm()).item())
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-4 * scale):
            raise SystemExit(f"fp32 gradient of {n}: kernel path vs plain path max abs err "
                             f"{(a - b).abs().max().item()} (max |g| {scale})")
    out["fp32"] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                   "grad_max_rel_l2": worst, "n_grads": len(g_p), "zero_grads": zero}
    log(f"[train] fp32 kernel vs plain path: {json.dumps(out['fp32'])}")
    if not math.isclose(loss_k, loss_p, rel_tol=1e-5):
        raise SystemExit(f"fp32 loss: kernel path {loss_k} vs plain path {loss_p} (rtol 1e-5)")
    del g_k, g_p

    # bf16: rounding points move; loss within 1e-2 relative, and every
    # gradient that is not analytically zero at cosine > 0.99
    loss_k, g_k = loss_and_grads("bfloat16", True)
    loss_p, g_p = loss_and_grads("bfloat16", False)
    cos = {n: torch.nn.functional.cosine_similarity(g_k[n].flatten().float(),
                                                    g_p[n].flatten().float(), dim=0).item()
           for n in g_p if n not in zero}
    low = min(cos, key=cos.get)
    out["bf16"] = {"loss_kernel": loss_k, "loss_plain": loss_p, "grad_cos_min": cos[low],
                   "grad_cos_min_tensor": low, "n_grads": len(cos)}
    log(f"[train] bf16 kernel vs plain path: {json.dumps(out['bf16'])}")
    if not (math.isclose(loss_k, loss_p, rel_tol=1e-2) and cos[low] > 0.99):
        raise SystemExit(f"bf16 train step: kernel path disagrees with the plain path: "
                         f"{out['bf16']}")
    del g_k, g_p

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
        "losses": [x.item() for x in losses]}
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

    from signal_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build(["attention_fwd", "attention_bwd"])
    report["build_s"] = time.perf_counter() - t0
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {lib.name}: {line.strip()}")
    log(f"[build] {sorted(libs)} in {report['build_s']:.1f} s")

    peaks = peaks_for(name)
    rows = check_attention(torch, report, peaks)
    bwd = check_attention_bwd(torch, report, peaks)
    check_slice(torch, report)
    eval_launches = run_main_path(torch, report)
    check_train_step(torch, report)
    train_launches = run_train_path(torch, report)

    def entry(kernel, source, replaces, rows, launches):
        bf16, fp32 = rows["main-bf16"], rows["main-fp32"]
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": bf16["max_abs_err"],
                "max_abs_err_bf16": bf16["max_abs_err"], "max_abs_err_fp32": fp32["max_abs_err"],
                "ms": bf16["ms"], "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
                "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
                "shape": bf16["shape"], "ms_fp32": fp32["ms"], "bound_ms_fp32": fp32["bound_ms"]}

    fwd = entry("attention_fwd", "signal_tpu_torch/csrc/attention_fwd.cu",
                "signal_tpu/ops/flash_attention.py:50", rows, train_launches["attention_fwd"])
    fwd.update(launches_eval=eval_launches, ms_train_shape=rows["train-bf16"]["ms"],
               bound_ms_train_shape=rows["train-bf16"]["bound_ms"])
    kernels = [fwd, entry("attention_bwd", "signal_tpu_torch/csrc/attention_bwd.cu",
                          "signal_tpu/ops/flash_attention.py:123", bwd,
                          train_launches["attention_bwd"])]
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
