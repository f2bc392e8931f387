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
  JAX package's arithmetic for every backbone: the CLIP and ImageNet ViTs,
  T2T (:func:`_t2t_stage_flops`), ResNet (:func:`_resnet_analytic_flops`)
  and OSNet (:func:`_osnet_analytic_flops`).
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
    remat, the per-block forward replay (the HFU numerator).

    It counts whenever MODEL.USE_PALLAS_ATTENTION is set, whatever the
    backbone, as JAX's does; :func:`model_flops` adds it only where the
    kernel runs (``ModelSpec.attention_kernel``)."""
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


def _resnet_analytic_flops(spec, batch_size: int) -> float:
    """Conv FLOPs (2·MACs) of one 3-modal bottleneck-ResNet eval forward
    (last stride 1), at ``spec.img_h`` × ``spec.img_w``. Cross-check:
    resnet50 at 224×224 with standard strides ≈ 4.09 GMACs."""
    from signal_tpu_torch.models.resnet import EXPANSION, RESNET_BLOCK_COUNTS, WIDTHS

    counts = RESNET_BLOCK_COUNTS[spec.layers]
    H, W = spec.img_h, spec.img_w
    fl = 2.0 * (7 * 7 * 3) * 64 * (H // 2) * (W // 2)    # stem
    h, w = H // 4, W // 4                                 # after the max-pool
    cin = 64
    for si, (wd, n) in enumerate(zip(WIDTHS, counts)):
        stride = 1 if si in (0, 3) else 2                 # last stride 1
        for bi in range(n):
            s = stride if bi == 0 else 1
            ho, wo = h // s, w // s
            fl += 2.0 * cin * wd * h * w                  # conv1 1×1 (before the stride)
            fl += 2.0 * 9 * wd * wd * ho * wo             # conv2 3×3
            fl += 2.0 * wd * (wd * EXPANSION) * ho * wo   # conv3 1×1
            if bi == 0:
                fl += 2.0 * cin * (wd * EXPANSION) * ho * wo  # downsample
            cin = wd * EXPANSION
            h, w = ho, wo
    return 3 * batch_size * fl


def _osnet_analytic_flops(spec, batch_size: int) -> float:
    """Conv FLOPs (2·MACs) of one 3-modal OSNet eval forward.
    Cross-check: osnet_x1_0 at 256×128 ≈ 0.98 GMACs an image."""
    from signal_tpu_torch.models.osnet import GATE_REDUCTION, OSNET_BY_FEAT_DIM, OSNET_LAYERS

    channels = OSNET_BY_FEAT_DIM[spec.feat_dim]
    H, W = spec.image_size
    fl = 2.0 * (7 * 7 * 3) * channels[0] * (H // 2) * (W // 2)   # stem
    h, w = H // 4, W // 4                                        # after the max-pool
    cin = channels[0]
    for si, cout in enumerate(channels[1:]):
        mid = cout // 4
        for _ in range(OSNET_LAYERS[si]):
            hw = h * w
            fl += 2.0 * cin * mid * hw                   # conv1 1×1
            # the 10 lite convs of the four branches (1+2+3+4): pw + dw
            fl += 10.0 * (2.0 * mid * mid + 2.0 * 9 * mid) * hw
            fl += 4.0 * 2.0 * 2 * mid * (mid // GATE_REDUCTION)  # the shared gate ×4
            fl += 2.0 * mid * cout * hw                  # conv3 1×1
            if cin != cout:
                fl += 2.0 * cin * cout * hw              # downsample 1×1
            cin = cout
        if si < 2:                                       # the transition
            fl += 2.0 * cout * cout * h * w
            h, w = h // 2, w // 2
    fl += 2.0 * channels[3] * channels[3] * h * w        # conv5 1×1
    return 3 * batch_size * fl


def _t2t_stage_flops(spec) -> float:
    """Matmul FLOPs of T2T's soft-split stages and projection for ONE image
    (`signal_tpu/models/t2t.py:125-146`). Stage tokens: L0 = (H/4)(W/4) at
    dim 147, L1 = (H/8)(W/8) at dim 576, L2 = (H/16)(W/16) projected
    576 → embed; a token transformer (dim → 3·64 qkv, one head, 64×64
    proj, 64 → 64 → 64 MLP)."""
    from signal_tpu_torch.models.t2t import TOKEN_DIM as td

    H, Wd = spec.image_size

    def token_tf(L, dim):
        return (2.0 * L * dim * 3 * td        # qkv
                + 4.0 * L * L * td            # QKᵀ + PV (one head)
                + 2.0 * L * td * td           # proj
                + 4.0 * L * td * td)          # MLP fc1 + fc2 (hidden 64)

    L0, L1, L2 = (H // 4) * (Wd // 4), (H // 8) * (Wd // 8), (H // 16) * (Wd // 16)
    fl = token_tf(L0, 3 * 49) + token_tf(L1, td * 9)
    return fl + 2.0 * L2 * (td * 9) * spec.width    # project 576 → embed


def signal_analytic_flops(spec, batch_size: int, *, train: bool = False,
                          hardware: bool = False) -> float:
    """Analytic matmul/conv FLOPs (2·MACs) of one Signal forward, and of
    one train step when ``train``: forward + backward = 3× forward, the
    MFU numerator (remat recomputation is hardware work and is counted
    only with ``hardware=True``, the HFU numerator: 'full' replays every
    block's forward, 'half' half of them, the save-something policies are
    not modelled and count none; the CNNs have no remat).

    Every backbone, as JAX's (`signal_tpu/utils/flops.py:144-210`): the
    CLIP ViT (mlp ratio 4, output projection), the ImageNet ViT (no output
    projection, the spec's mlp ratio, an overlapping stride's tokens
    through h and w), T2T (its soft-split stages instead of the patch
    conv), ResNet and OSNet; SIE; and SIM when ``spec.use_a``.
    Cross-check: ViT-B/16 ≈ 17.6 GMACs at 197 tokens ⇒ 24·W²·T·12 here."""
    replay = ({"full": 1.0, "half": 0.5}.get(spec.remat_policy, 0.0)
              if (train and hardware and spec.remat) else 0.0)
    if spec.backbone in ("resnet", "osnet"):
        fwd = (_resnet_analytic_flops(spec, batch_size) if spec.backbone == "resnet"
               else _osnet_analytic_flops(spec, batch_size))
        return fwd if not train else fwd * 3.0
    W, D, depth = spec.width, spec.feat_dim, spec.layers
    L = spec.h * spec.w
    T = L + 1
    R = 3 * batch_size                                  # encoder rows
    if spec.backbone == "t2t":
        conv = _t2t_stage_flops(spec)                   # the soft-split stages
    else:
        conv = 2.0 * (spec.patch_size ** 2 * 3) * W * L     # patch embed conv
    # qkv+out (8·W²·T) + MLP fc+proj (4·mlp_ratio·W²·T); = 24·W²·T at r=4
    per_layer = (8.0 + 4.0 * spec.mlp_ratio) * W * W * T
    attn = 4.0 * T * T * W                              # QKᵀ + PV
    # only the CLIP tower projects its output (ln_post @ proj)
    proj = 2.0 * W * D * T if spec.backbone == "clip" else 0.0
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
    analytic count of the attention kernel the counter cannot see, where
    the backbone runs it."""
    from signal_tpu_torch.models.signal_model import MODALITIES, forward_eval

    spec = model.spec
    p = next(model.parameters())
    H, W = spec.image_size
    imgs = {m: torch.zeros(batch_size, 3, H, W, device=p.device) for m in MODALITIES}
    cams = torch.zeros(batch_size, dtype=torch.int64, device=p.device)
    with torch.inference_mode():
        counted = cost_analysis(forward_eval, model, imgs, cams)["flops"]
    kernel = flash_attention_flops(spec, batch_size) if spec.attention_kernel else 0.0
    return counted + kernel


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
