"""Optimizer and LR schedules (port of `signal_tpu/solver.py`, the
reference's `solver/make_optimizer.py`, `cosine_lr.py`, `scheduler.py` and
`lr_scheduler310.py` in maxingan2412/Signal).

* Per-parameter (lr, weight decay, trainable) from the reference's rules,
  applied in its order over the port's reference-named parameters:
    1. a bias → lr × BIAS_LR_FACTOR, wd = WEIGHT_DECAY_BIAS;
    2. the backbone (``clip_vision_encoder.base.*``, or ``base.*`` for
       the others) but its adapter and prompt parameters (``adapter*``
       names) → lr 5e-6 for the CLIP tower (MODEL.TRANSFORMER_TYPE
       'ViT-B-16'), 0.8 × BASE_LR for the others, unless MODEL.FROZEN; the
       CLIP tower's SIE table ``cv_embed`` sits outside it, as in the JAX
       tree (the ImageNet and T2T towers' ``sie_embed`` inside);
    3. MSVR310: a classifier → lr × 100, wd = WEIGHT_DECAY_BIAS;
    4. LARGE_FC_LR: a classifier → lr × 2;
  the BNNeck biases, SIM's unused ``W_v`` and T2T's sinusoid
  ``base.pos_embed`` do not train; under MODEL.FROZEN neither does the
  backbone, but its adapters and LoRA factors (``lora_*``), which train at
  BASE_LR. The LoRA scale is a buffer and never trains. The groups equal
  the JAX package's ``build_param_groups`` leaf for leaf.
* ``torch.optim`` Adam (L2 decay into the gradient), AdamW (decoupled) or
  SGD with momentum, with one parameter group per (lr, wd). Each group
  keeps its ``base_lr``; the schedules give (a, b) per epoch and a group's
  lr is a + b·base_lr (both the timm cosine schedule and the warmup
  multistep one are affine in the group's base lr).
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Tuple

import torch
from torch import nn

# the backbone's parameters: the CLIP tower's, or any other backbone's
BACKBONE_PREFIXES = ("clip_vision_encoder.base.", "base.")


def param_rule(name: str, cfg) -> Tuple[float, float, bool]:
    """(lr, weight decay, trainable) of the parameter called ``name``."""
    base_lr = cfg.SOLVER.BASE_LR
    ttype = cfg.MODEL.TRANSFORMER_TYPE
    lr, wd, trainable = base_lr, cfg.SOLVER.WEIGHT_DECAY, True
    if "bias" in name:
        lr = base_lr * cfg.SOLVER.BIAS_LR_FACTOR
        wd = cfg.SOLVER.WEIGHT_DECAY_BIAS
    backbone = name.startswith(BACKBONE_PREFIXES) and "adapter" not in name
    if backbone and not cfg.MODEL.FROZEN:
        lr = 0.000005 if ttype == "ViT-B-16" else base_lr * 0.8
    if cfg.DATASETS.NAMES == "MSVR310" and "classifier" in name:
        lr = base_lr * 100
        wd = cfg.SOLVER.WEIGHT_DECAY_BIAS
    if cfg.SOLVER.LARGE_FC_LR and "classifier" in name:
        lr = base_lr * 2
    if "bottleneck" in name and name.endswith("bias"):
        trainable = False
    if "W_v" in name:
        trainable = False
    if ttype.startswith("t2t") and name == "base.pos_embed":
        trainable = False
    if backbone and cfg.MODEL.FROZEN and "lora" not in name:
        trainable = False
    return lr, wd, trainable


def build_param_groups(model: nn.Module, cfg) -> List[Dict]:
    """One ``torch.optim`` group per (lr, wd) over the trainable parameters,
    each with its ``base_lr``. A frozen parameter gets
    ``requires_grad=False``."""
    groups: Dict[Tuple[float, float], List[nn.Parameter]] = {}
    for name, p in model.named_parameters():
        lr, wd, trainable = param_rule(name, cfg)
        if not trainable:
            p.requires_grad_(False)
            continue
        groups.setdefault((lr, wd), []).append(p)
    return [{"params": ps, "lr": lr, "base_lr": lr, "weight_decay": wd}
            for (lr, wd), ps in groups.items()]


def make_optimizer(model: nn.Module, cfg) -> torch.optim.Optimizer:
    """SOLVER.OPTIMIZER_NAME: 'Adam' (torch Adam, L2 decay into the
    gradient), 'AdamW' or 'SGD' (momentum SOLVER.MOMENTUM)."""
    groups = build_param_groups(model, cfg)
    name = cfg.SOLVER.OPTIMIZER_NAME
    if name == "Adam":
        return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    if name == "AdamW":
        return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
    if name == "SGD":
        return torch.optim.SGD(groups, momentum=cfg.SOLVER.MOMENTUM)
    raise ValueError(f"SOLVER.OPTIMIZER_NAME={name!r}: the port takes Adam, AdamW or SGD")


def set_lr(optimizer: torch.optim.Optimizer, a: float, b: float) -> None:
    """Each group's lr = a + b·base_lr."""
    for group in optimizer.param_groups:
        group["lr"] = a + b * group["base_lr"]


def _lr_noise(epoch: int, seed: int = 42, pct: float = 0.67) -> float:
    """Truncated-normal LR noise (`solver/scheduler.py:93-104`): standard
    normals from a generator seeded with seed + epoch, redrawn until
    |noise| < pct."""
    g = torch.Generator()
    g.manual_seed(seed + epoch)
    while True:
        noise = torch.randn(1, generator=g).item()
        if abs(noise) < pct:
            return noise


def cosine_schedule_coeffs(epoch: int, *, max_epochs: int, base_lr: float, warmup_t: int,
                           noise: bool = True, noise_seed: int = 42) -> Tuple[float, float]:
    """timm CosineLRScheduler with the reference factory's defaults:
    lr_min = 0.001·BASE_LR, warmup_lr_init = 0.1·BASE_LR, one cycle,
    per-epoch noise over the whole run. → (a, b)."""
    lr_min = 0.001 * base_lr
    warmup_lr_init = 0.1 * base_lr
    if warmup_t and epoch < warmup_t:
        frac = epoch / warmup_t
        a, b = warmup_lr_init * (1.0 - frac), frac
    elif epoch < max_epochs:
        c = 0.5 * (1.0 + math.cos(math.pi * epoch / max_epochs))
        a, b = lr_min * (1.0 - c), c
    else:
        a, b = lr_min, 0.0
    if noise and 0 <= epoch < max_epochs:
        nz = 1.0 + _lr_noise(epoch, noise_seed)
        a, b = a * nz, b * nz
    return a, b


def multistep_schedule_coeffs(epoch: int, *, steps, gamma: float, warmup_factor: float,
                              warmup_iters: int, warmup_method: str = "linear"
                              ) -> Tuple[float, float]:
    """WarmupMultiStepLR (`solver/lr_scheduler310.py:43-56`), MSVR310."""
    wf = 1.0
    if epoch < warmup_iters:
        if warmup_method == "constant":
            wf = warmup_factor
        else:
            alpha = epoch / warmup_iters
            wf = warmup_factor * (1 - alpha) + alpha
    return 0.0, wf * gamma ** bisect.bisect_right(list(steps), epoch)


def schedule_coeffs(cfg, epoch: int) -> Tuple[float, float]:
    """1-based epoch (`processor.py:135`) → (a, b)."""
    if cfg.DATASETS.NAMES == "MSVR310":
        return multistep_schedule_coeffs(
            epoch, steps=cfg.SOLVER.STEPS, gamma=cfg.SOLVER.GAMMA,
            warmup_factor=cfg.SOLVER.WARMUP_FACTOR, warmup_iters=cfg.SOLVER.WARMUP_ITERS,
            warmup_method=cfg.SOLVER.WARMUP_METHOD)
    return cosine_schedule_coeffs(epoch, max_epochs=cfg.SOLVER.MAX_EPOCHS,
                                  base_lr=cfg.SOLVER.BASE_LR, warmup_t=cfg.SOLVER.WARMUP_ITERS)


def current_lr(cfg, epoch: int) -> float:
    """The base group's lr, for the log line."""
    a, b = schedule_coeffs(cfg, epoch)
    return a + b * cfg.SOLVER.BASE_LR
