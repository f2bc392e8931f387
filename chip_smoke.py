#!/usr/bin/env python3
"""Drive the PyTorch port (signal_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card, nvcc

Phases (any failure exits non-zero; nothing is caught):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port from ``signal_tpu_torch/csrc``,
     one nvcc per source, all started together;
  3. kernels vs plain: each kernel's wrapper against its plain PyTorch
     version on the card, at the main path's shapes and at odd ones, with
     the tolerance stated; kernel, plain and library times (CUDA events);
  4. slice: ``forward_eval`` of the flagship RGBNT201 model (CLIP ViT-B/16,
     width 768, 12 heads, 256×128, SIE, SIM TOPK 80; random weights from a
     seed) on B=128 random packed uint8 images, kernel path against the
     plain-attention path (fp32 features; bf16 ViT-output cosines and SIM
     mask agreement), 12 kernel launches per forward, ms/batch;
  5. end to end: ``signal_tpu_torch.cli.test_main`` on
     configs/synthetic/smoke.yml at full width → mAP/CMC. This is the
     main path: every launch count is zeroed just before it and read
     just after.
Then it prints the kernel table as one JSON line, and as its last line
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
        if name.startswith("main"):
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
    libs = _build.build(["attention_fwd"])
    report["build_s"] = time.perf_counter() - t0
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {lib.name}: {line.strip()}")
    log(f"[build] {sorted(libs)} in {report['build_s']:.1f} s")

    rows = check_attention(torch, report, peaks_for(name))
    check_slice(torch, report)
    launches = run_main_path(torch, report)

    main_bf16, main_fp32 = rows["main-bf16"], rows["main-fp32"]
    kernels = [{
        "name": "attention_fwd", "route": "cuda",
        "source": "signal_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "signal_tpu/ops/flash_attention.py:50",
        "launches": launches,
        "max_abs_err": main_bf16["max_abs_err"],
        "max_abs_err_bf16": main_bf16["max_abs_err"],
        "max_abs_err_fp32": main_fp32["max_abs_err"],
        "ms": main_bf16["ms"], "plain_ms": main_bf16["plain_ms"],
        "bound_ms": main_bf16["bound_ms"], "bound_by": main_bf16["bound_by"],
        "library_ms": main_bf16["library_ms"],
    }]
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
