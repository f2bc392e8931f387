"""The reference's recipe around the model: the normalisation and device
augmentation (flip, pad + crop, erase, each modality with its own draws),
the train step (the model's loss, Adam with the recipe's parameter
groups) and the gallery features, in plain PyTorch.

The augmentation's draws come from a ``torch.Generator`` on the batch's
device seeded as the benchmark seeded the port's, and are drawn in the
recipe's order (per modality in sorted name order: flip, crop offsets,
the erase geometry and noise), so that both sides augment alike; the
rest of the arithmetic is worked out here again.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference import model as ref

BETAS, EPS = (0.9, 0.999), 1e-8
# maxingan2412/Signal `solver/make_optimizer.py`: the CLIP tower fine-tunes at 5e-6
CLIP_TOWER_LR = 0.000005


def normalize(imgs_u8, mean, std):
    """uint8 [B, 3, 3, H, W] → (x/255 − mean)/std, channel axis 2."""
    m = torch.tensor(mean, device=imgs_u8.device).reshape(1, 1, 3, 1, 1)
    s = torch.tensor(std, device=imgs_u8.device).reshape(1, 1, 3, 1, 1)
    return (imgs_u8.float() / 255.0 - m) / s


def _augment_one(gen, x, hp, fill):
    """One modality [B, 3, H, W]: flip, pad + crop, pixel erase (the first
    of ten candidate rectangles that fits, filled with the drawn noise)."""
    B, C, H, W = x.shape
    dev = x.device
    u = torch.empty(B, device=dev).uniform_(0.0, 1.0, generator=gen)
    x = torch.where((u < hp["flip_prob"])[:, None, None, None], x.flip(-1), x)
    pad = hp["padding"]
    if pad > 0:
        ty = torch.randint(0, 2 * pad + 1, (B,), generator=gen, device=dev)
        tx = torch.randint(0, 2 * pad + 1, (B,), generator=gen, device=dev)
        f = fill[None, :, None, None]
        xp = F.pad(x - f, (pad, pad, pad, pad)) + f
        iy = ty[:, None] + torch.arange(H, device=dev)
        ix = tx[:, None] + torch.arange(W, device=dev)
        b = torch.arange(B, device=dev)[:, None, None]
        x = xp.permute(0, 2, 3, 1)[b, iy[:, :, None], ix[:, None, :]].permute(0, 3, 1, 2)
    if hp["re_prob"] > 0:
        area = torch.empty(B, 10, device=dev).uniform_(0.02, 1 / 3, generator=gen)
        aspect = torch.exp(torch.empty(B, 10, device=dev).uniform_(
            math.log(0.3), math.log(1 / 0.3), generator=gen))
        u_top = torch.empty(B, device=dev).uniform_(0.0, 1.0, generator=gen)
        u_left = torch.empty(B, device=dev).uniform_(0.0, 1.0, generator=gen)
        u_do = torch.empty(B, device=dev).uniform_(0.0, 1.0, generator=gen)
        noise = torch.randn((B, C, H, W), generator=gen, device=dev)
        target = area * float(H * W)
        hs = torch.round(torch.sqrt(target * aspect)).to(torch.int32)
        ws = torch.round(torch.sqrt(target / aspect)).to(torch.int32)
        valid = (hs < H) & (ws < W) & (hs > 0) & (ws > 0)
        pick = valid.int().argmax(dim=1, keepdim=True)
        h, w = hs.gather(1, pick)[:, 0], ws.gather(1, pick)[:, 0]
        top = torch.floor(u_top * (H - h + 1).float()).to(torch.int32)
        left = torch.floor(u_left * (W - w + 1).float()).to(torch.int32)
        rows, cols = torch.arange(H, device=dev)[None], torch.arange(W, device=dev)[None]
        rmask = (rows >= top[:, None]) & (rows < (top + h)[:, None])
        cmask = (cols >= left[:, None]) & (cols < (left + w)[:, None])
        do = (u_do < hp["re_prob"]) & valid.any(dim=1)
        region = rmask[:, None, :, None] & cmask[:, None, None, :] & do[:, None, None, None]
        x = torch.where(region, noise, x)
    return x


def augment(gen, x, hp):
    """x [B, 3 modalities, 3, H, W] normalised → augmented, modalities drawn
    in sorted name order (NI, RGB, TI) and returned as RGB, NI, TI."""
    fill = torch.tensor([(0.0 - m) / s for m, s in zip(hp["mean"], hp["std"])],
                        device=x.device)
    mods = {"RGB": x[:, 0], "NI": x[:, 1], "TI": x[:, 2]}
    out = {name: _augment_one(gen, mods[name], hp, fill) for name in sorted(mods)}
    return torch.stack([out["RGB"], out["NI"], out["TI"]], dim=1)


def param_rule(name: str, hp: dict):
    """(lr, weight decay, trainable) of one parameter, the recipe's rules
    (maxingan2412/Signal `solver/make_optimizer.py`)."""
    lr, wd = hp["base_lr"], hp["weight_decay"]
    if "bias" in name:
        lr, wd = hp["base_lr"] * hp["bias_lr_factor"], hp["weight_decay_bias"]
    if name.startswith("clip_vision_encoder.base.") and "adapter" not in name:
        lr = CLIP_TOWER_LR
    if hp["dataset"] == "MSVR310" and "classifier" in name:
        lr, wd = hp["base_lr"] * 100, hp["weight_decay_bias"]
    if hp["large_fc_lr"] and "classifier" in name:
        lr = hp["base_lr"] * 2
    trainable = not (("bottleneck" in name and name.endswith("bias")) or "W_v" in name
                     or ref.is_statistic(name))
    return lr, wd, trainable


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names])
    return dict(zip(names, norms.tolist()))


def train_steps(weights: Dict[str, torch.Tensor], arch: dict, hp: dict, batches: List,
                aug_seed: int, precision: str = "fp32") -> dict:
    """Run the recipe's first ``len(batches)`` steps from ``weights``.
    ``batches``: (uint8 images [B, 3, 3, H, W], pids [B], cams [B]) on the
    device. → {'losses': [...], 'grad': {leaf: norm of the first step's
    gradient as Adam takes it (weight decay included)}, 'change': {leaf:
    norm of the parameters' change after the steps}}."""
    ar = ref.Arith(precision)
    dev = batches[0][0].device
    gen = torch.Generator(device=dev).manual_seed(aug_seed)
    rules = {n: param_rule(n, hp) for n in weights}
    train = [n for n in weights if rules[n][2]]
    P = {n: t.detach().clone().float().requires_grad_(n in train) for n, t in weights.items()}
    m = {n: torch.zeros_like(P[n]) for n in train}
    v = {n: torch.zeros_like(P[n]) for n in train}
    out = {"losses": []}
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for t, (imgs, pids, cams) in enumerate(batches, start=1):
            x = augment(gen, normalize(imgs, hp["mean"], hp["std"]), hp)
            loss = ref.train_loss(ar, P, arch, hp, x, pids, cams)
            # SIM's selection projections reach the loss through a top-k
            # only: no gradient, and Adam leaves a leaf without one alone
            grads = torch.autograd.grad(loss, [P[n] for n in train], allow_unused=True)
            out["losses"].append(float(loss.detach()))
            with torch.no_grad():
                b1, b2 = BETAS
                for n, g in zip(train, grads):
                    if g is None:
                        continue
                    lr, wd, _ = rules[n]
                    g = g + wd * P[n]
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(EPS)
                    P[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                if t == 1:
                    out["grad"] = leaf_norms({n: m[n] / (1 - b1) for n, g in zip(train, grads)
                                              if g is not None})
            del loss, grads
        with torch.no_grad():
            out["change"] = leaf_norms({n: P[n] - weights[n].float() for n in train})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, conv
    return out


def gallery_features(weights: Dict[str, torch.Tensor], arch: dict, hp: dict, imgs_u8, cams,
                     precision: str = "fp32", rows: int = 32) -> torch.Tensor:
    """The reference's gallery features of a uint8 batch, ``rows`` samples
    at a time."""
    ar = ref.Arith(precision)
    P = {n: t.float() for n, t in weights.items()}
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            outs = [ref.features(ar, P, arch, normalize(imgs_u8[i:i + rows], hp["mean"],
                                                        hp["std"]), cams[i:i + rows])
                    for i in range(0, imgs_u8.shape[0], rows)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, conv
    return torch.cat(outs)
