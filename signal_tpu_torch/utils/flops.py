"""FLOP counts and the card's published peaks (port of
`signal_tpu/utils/flops.py`).

* :func:`cost_analysis` counts what a call runs with
  ``torch.utils.flop_counter.FlopCounterMode``: the products and
  convolutions in its table, per launch. Like XLA's cost model in the JAX
  package it cannot see inside a custom kernel: the attention operator
  (``signal_tpu_torch::attention_fwd``) counts zero, and
  :func:`flash_attention_flops` adds it by hand.
* :func:`signal_analytic_flops` is the MFU numerator: the matmul and conv
  FLOPs (2·MACs) of one Signal forward, or of one train step, with the
  JAX package's arithmetic for the CLIP ViT-B/16 backbone that the port's
  ``ModelSpec`` supports (the other backbones raise, ROADMAP Queue 1
  item 4).
* :data:`PEAKS` holds the published dense peaks of the cards the port
  runs on (NVIDIA's data sheets): the one table the bounds and MFU lines
  of ``chip_smoke.py`` and the profile scripts read.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

# published peaks by card (NVIDIA data sheets, dense): bytes/s of device
# memory, FLOP/s for bf16 on the tensor cores and for fp32 outside them.
# Matched by substring of the CUDA device name, in this order.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100": (3.35e12, 989e12, 67e12),       # SXM (HBM3)
    "H200": (4.8e12, 989e12, 67e12),
}


def peaks_for(name: Optional[str] = None) -> Tuple[float, float, float]:
    """(bytes/s, bf16 FLOP/s, fp32 FLOP/s) of the named card (default:
    CUDA device 0); raises for a card the table does not hold."""
    name = name if name is not None else torch.cuda.get_device_name(0)
    for key, vals in PEAKS.items():
        if key in name:
            return vals
    raise ValueError(f"no published peaks for {name!r}; add them to PEAKS")


def peak_flops_per_chip(name: Optional[str] = None) -> float:
    """Peak dense bf16 FLOP/s of the named card (default: CUDA device 0),
    the MFU denominator."""
    return peaks_for(name)[1]


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` under ``FlopCounterMode`` → {'flops': total,
    'by_op': {op name: flops}}. A custom kernel's operator counts zero."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    by_op = {str(op): float(n) for op, n in counter.get_flop_counts()["Global"].items()}
    return {"flops": float(counter.get_total_flops()), "by_op": by_op}


def _require_clip(spec) -> None:
    if spec.backbone != "clip":
        raise NotImplementedError(
            f"backbone {spec.backbone!r}: only the CLIP ViT-B-16 tower is ported "
            f"(ROADMAP Queue 1 item 4, the other backbones)")


def flash_attention_flops(spec, batch_size: int, *, train: bool = False,
                          hardware: bool = False) -> float:
    """Analytic FLOPs of the fused attention kernels in one Signal forward
    (and backward when ``train``); a FLOP counter is blind to them.

    Per ViT layer over R = 3·B token rows of length L = h·w+1, width D:
      forward kernel  = 2 matmuls (QKᵀ, PV)              = 4·R·L²·D
      backward kernel = 4 gradient matmuls (dV, dP, dQ, dK) = 8·R·L²·D,
      plus an in-kernel S recompute (2·R·L²·D) that is hardware work,
      not model work.

    ``train`` counts model FLOPs (MFU numerator: fwd + useful bwd = 3×fwd).
    ``hardware`` adds recomputation: the in-kernel S replay and, under
    remat, the per-block forward replay (the HFU numerator)."""
    _require_clip(spec)
    if not spec.use_flash:
        return 0.0
    R = 3 * batch_size
    L = spec.h * spec.w + 1
    D = spec.width
    fwd = 4.0 * R * L * L * D * spec.layers
    if not train:
        return fwd
    total = 3.0 * fwd                       # fwd + 4 useful bwd matmuls
    if hardware:
        total += 0.5 * fwd                  # in-kernel S recompute
        if spec.remat:
            # per-block remat replay (same policy factors as
            # ``signal_analytic_flops``; partial-save policies → 0)
            total += {"full": 1.0, "half": 0.5}.get(spec.remat_policy, 0.0) * fwd
    return total


def signal_analytic_flops(spec, batch_size: int, *, train: bool = False,
                          hardware: bool = False) -> float:
    """Analytic matmul/conv FLOPs (2·MACs) of one Signal forward, and of
    one train step when ``train``: forward + backward = 3× forward, the
    MFU numerator (remat recomputation is hardware work and is counted
    only with ``hardware=True``, the HFU numerator: 'full' replays every
    block's forward, 'half' half of them, the save-something policies are
    not modelled and count none).

    CLIP ViT-B/16 (mlp ratio 4, output projection), SIE, and SIM when
    ``spec.use_a``. Cross-check: ViT-B/16 ≈ 17.6 GMACs at 197 tokens ⇒
    24·W²·T·12 here."""
    _require_clip(spec)
    mlp_ratio = 4.0
    replay = ({"full": 1.0, "half": 0.5}.get(spec.remat_policy, 0.0)
              if (train and hardware and spec.remat) else 0.0)
    W, D, depth = spec.width, spec.feat_dim, spec.layers
    L = spec.h * spec.w
    T = L + 1
    R = 3 * batch_size                                  # encoder rows
    conv = 2.0 * (spec.patch_size ** 2 * 3) * W * L     # patch embed conv
    # qkv+out (8·W²·T) + MLP fc+proj (4·mlp_ratio·W²·T); = 24·W²·T at r=4
    per_layer = (8.0 + 4.0 * mlp_ratio) * W * W * T
    attn = 4.0 * T * T * W                              # QKᵀ + PV
    proj = 2.0 * W * D * T                              # ln_post @ proj
    fwd = R * (conv + depth * (per_layer + attn) + proj)
    if spec.use_a:
        # SIM: W_q/W_k projections, selection scores, MHCA (3 q × 3L kv), FFN
        fwd += batch_size * (
            2.0 * D * D * (3 + 3 * L)                    # W_q + W_k
            + 2.0 * 3 * (3 * L) * D                      # selection scores
            + 2.0 * D * 3 * D * (3 + 3 * L)              # MHCA qkv proj
            + 4.0 * 3 * (3 * L) * D                      # MHCA attn matmuls
            + 2.0 * D * D * 3                            # MHCA out proj
            + 2.0 * 3 * (2 * D * 2 * D))                 # FFN 2 linears
    if not train:
        return fwd
    return fwd * (3.0 + replay)


def model_flops(model, batch_size: int = 1) -> float:
    """FLOPs of one eval forward of ``model`` (a ``Signal``) on zero
    images on its device: the counted products and convolutions plus the
    analytic count of the attention kernel the counter cannot see."""
    from signal_tpu_torch.models.signal_model import MODALITIES, forward_eval

    spec = model.spec
    p = next(model.parameters())
    H, W = (spec.h - 1) * spec.stride_size + spec.patch_size, \
        (spec.w - 1) * spec.stride_size + spec.patch_size
    imgs = {m: torch.zeros(batch_size, 3, H, W, device=p.device) for m in MODALITIES}
    cams = torch.zeros(batch_size, dtype=torch.int64, device=p.device)
    with torch.inference_mode():
        counted = cost_analysis(forward_eval, model, imgs, cams)["flops"]
    return counted + flash_attention_flops(spec, batch_size)


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
