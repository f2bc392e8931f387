"""The Signal model in plain PyTorch: the reference the benchmark holds the
port to.

It follows the published model (maxingan2412/Signal: the CLIP ViT-B/16
tower with the SIE camera embedding, SIM's token selection and
cross-attention fusion, the BNNeck heads, GAM and LAM) in float32, with
no kernel, no remat policy and no batching trick of the port. It imports
nothing of the port and takes no weight the port made: its parameters
are a dict of tensors the benchmark makes from the seed, under the
reference state dict's names, which the port loads as they are.

The products that the configuration runs in its compute dtype (bfloat16:
the tower's patch embedding, projections, MLP and attention core, its
output projection, and SIM's cross-attention and FFN) go through
:class:`Arith`, in float32 (``"fp32"``) or, for the control that shows
the comparison can fail, in float8 (``"fp8"``: E4M3 operands, E5M2
gradients, one scale a tensor). The products the port runs in float32
(SIM's selection scores, the distances, DAS's convolutions, the
classifiers) stay float32 in both.

Departures: the patch convolution is the product of unfolded patches (the
same sums for a stride equal to the patch); BNNeck running statistics are
not kept (the train loss normalises by the batch's).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _quantize(x: torch.Tensor, dtype: torch.dtype, vmax: float) -> torch.Tensor:
    """Round to float8 ``dtype`` with one scale for the tensor (its largest
    magnitude maps to the format's largest value), back in float32."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / vmax
    return (x.float() / scale).to(dtype).float() * scale


class _Fp8Product(torch.autograd.Function):
    """a @ b with both operands in E4M3; the backward's products take the
    output gradient in E5M2 (the usual float8 training recipe)."""

    @staticmethod
    def forward(ctx, a, b):
        qa = _quantize(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _quantize(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _quantize(g, torch.float8_e5m2, E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Arith:
    """The compute-dtype products: ``"fp32"`` (the reference) or ``"fp8"``
    (the control)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision {mode!r}: fp32 or fp8")
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., M, K] @ b [..., K, N], batch dims equal."""
        if self.mode == "fp32":
            return a @ b
        return _Fp8Product.apply(a, b)


# ---------------------------------------------------------------- parameters

def param_shapes(arch: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter and statistic of the model, under the reference
    state dict's names, in a fixed order."""
    W, D, C = arch["width"], arch["feat_dim"], arch["num_classes"]
    p, T = arch["patch"], arch["h"] * arch["w"] + 1
    base = "clip_vision_encoder.base."
    out = [("clip_vision_encoder.cv_embed", (arch["camera_num"], 1, W))] if arch["sie_camera"] \
        else []
    out += [(base + "class_embedding", (W,)), (base + "positional_embedding", (T, W)),
            (base + "proj", (W, D)), (base + "conv1.weight", (W, 3, p, p)),
            (base + "ln_pre.weight", (W,)), (base + "ln_pre.bias", (W,))]
    hidden = int(arch["mlp_ratio"] * W)
    for i in range(arch["layers"]):
        b = f"{base}transformer.resblocks.{i}."
        out += [(b + "ln_1.weight", (W,)), (b + "ln_1.bias", (W,)),
                (b + "attn.in_proj_weight", (3 * W, W)), (b + "attn.in_proj_bias", (3 * W,)),
                (b + "attn.out_proj.weight", (W, W)), (b + "attn.out_proj.bias", (W,)),
                (b + "ln_2.weight", (W,)), (b + "ln_2.bias", (W,)),
                (b + "mlp.c_fc.weight", (hidden, W)), (b + "mlp.c_fc.bias", (hidden,)),
                (b + "mlp.c_proj.weight", (W, hidden)), (b + "mlp.c_proj.bias", (W,))]
    out += [(base + "ln_post.weight", (W,)), (base + "ln_post.bias", (W,))]

    def neck(name: str, dim: int):
        return [(f"{name}.{k}", (dim,)) for k in ("weight", "bias", "running_mean",
                                                  "running_var")]

    if arch["direct"]:
        out += neck("bottleneck", 3 * D) + [("classifier.weight", (C, 3 * D))]
    else:
        for m in "rnt":
            out += neck(f"bottleneck_{m}", D) + [(f"classifier_{m}.weight", (C, D))]
    if arch["use_a"]:
        s = "SIM."
        for lin in ("W_q", "W_k", "W_v"):
            out += [(f"{s}token_selection.{lin}.weight", (D, D)),
                    (f"{s}token_selection.{lin}.bias", (D,))]
        mi = s + "modal_interactive."
        out += [(mi + "cross_attn.in_proj_weight", (3 * D, D)),
                (mi + "cross_attn.in_proj_bias", (3 * D,)),
                (mi + "cross_attn.out_proj.weight", (D, D)),
                (mi + "cross_attn.out_proj.bias", (D,)),
                (mi + "ffn.0.weight", (2 * D, D)), (mi + "ffn.0.bias", (2 * D,)),
                (mi + "ffn.2.weight", (D, 2 * D)), (mi + "ffn.2.bias", (D,)),
                (mi + "norm1.weight", (D,)), (mi + "norm1.bias", (D,)),
                (mi + "norm2.weight", (D,)), (mi + "norm2.bias", (D,))]
        out += neck("bottleneck_var", 3 * D) + [("classifier_var.weight", (C, 3 * D))]
    if arch["use_b"]:
        out += [("AlignM.contra_temp", ())]
        for m in "rnt":
            d = f"AlignM.DAS_{m}."
            out += [(d + "proj_q.weight", (D, D, 1, 1)), (d + "proj_q.bias", (D,)),
                    (d + "conv_offset.0.weight", (D, D, 1, 1)), (d + "conv_offset.0.bias", (D,)),
                    (d + "conv_offset.2.weight", (D, 1, 4, 4)), (d + "conv_offset.2.bias", (D,)),
                    (d + "conv_offset.4.weight", (1, D, 1, 1))]
    return out


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


# ------------------------------------------------------------------- layers

def layer_norm(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], 1e-5)


def linear(ar: Arith, x, weight, bias=None):
    y = ar.mm(x.reshape(-1, x.shape[-1]), weight.t()).reshape(*x.shape[:-1], weight.shape[0])
    return y if bias is None else y + bias


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def attention(ar: Arith, P, name: str, q_in, kv_in, heads: int):
    """Multi-head attention from a packed [3D, D] q|k|v projection."""
    wq, wk, wv = P[name + ".in_proj_weight"].chunk(3, dim=0)
    bq, bk, bv = P[name + ".in_proj_bias"].chunk(3, dim=0)
    B, Lq, D = q_in.shape
    Lk, hd = kv_in.shape[1], D // heads

    def split(x, L):
        return x.reshape(B, L, heads, hd).transpose(1, 2)

    q = split(linear(ar, q_in, wq, bq), Lq)
    k = split(linear(ar, kv_in, wk, bk), Lk)
    v = split(linear(ar, kv_in, wv, bv), Lk)
    p = torch.softmax(ar.mm(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    out = ar.mm(p, v).transpose(1, 2).reshape(B, Lq, D)
    return linear(ar, out, P[name + ".out_proj.weight"], P[name + ".out_proj.bias"])


def _block(ar: Arith, P, prefix: str, heads: int, x):
    ln = layer_norm(x, P, prefix + "ln_1")
    x = x + attention(ar, P, prefix + "attn", ln, ln, heads)
    h = quick_gelu(linear(ar, layer_norm(x, P, prefix + "ln_2"), P[prefix + "mlp.c_fc.weight"],
                          P[prefix + "mlp.c_fc.bias"]))
    return x + linear(ar, h, P[prefix + "mlp.c_proj.weight"], P[prefix + "mlp.c_proj.bias"])


def tower(ar: Arith, P, arch: dict, images, cams, checkpoint: bool):
    """images [N, 3, H, W] (normalised), cams [N] or None → [N, 1 + L, feat_dim]."""
    if arch["stride"] != arch["patch"]:
        raise ValueError("the reference unfolds patches: stride must equal the patch")
    base, W, p = "clip_vision_encoder.base.", arch["width"], arch["patch"]
    N, h, w = images.shape[0], arch["h"], arch["w"]
    patches = images.reshape(N, 3, h, p, w, p).permute(0, 2, 4, 1, 3, 5).reshape(N, h * w, -1)
    x = linear(ar, patches, P[base + "conv1.weight"].reshape(W, -1))
    cls = P[base + "class_embedding"].expand(N, 1, W)
    if cams is not None and arch["sie_camera"]:
        cls = cls + arch["sie_coe"] * P["clip_vision_encoder.cv_embed"][cams, 0][:, None]
    x = torch.cat([cls, x], dim=1) + P[base + "positional_embedding"][None]
    x = layer_norm(x, P, base + "ln_pre")
    for i in range(arch["layers"]):
        fn = lambda t, i=i: _block(ar, P, f"{base}transformer.resblocks.{i}.",  # noqa: E731
                                   arch["heads"], t)
        x = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False) if checkpoint \
            else fn(x)
    x = layer_norm(x, P, base + "ln_post")
    return linear(ar, x, P[base + "proj"].t())


def encode(ar: Arith, P, arch: dict, imgs, cams, checkpoint: bool = False):
    """imgs [B, 3 modalities (RGB, NI, TI), 3, H, W] → (patches [B, 3, L, D],
    cls [B, 3, D]); the modalities ride as sample-major rows."""
    B = imgs.shape[0]
    out = tower(ar, P, arch, imgs.reshape(B * 3, *imgs.shape[2:]),
                cams.repeat_interleave(3) if cams is not None else None, checkpoint)
    L, D = out.shape[1] - 1, out.shape[2]
    return out[:, 1:].reshape(B, 3, L, D), out[:, 0].reshape(B, 3, D)


# ---------------------------------------------------------------------- SIM

def _topk_mask(scores, k):
    """[R, L] → 1 at the k largest of each row, ties to the lowest index."""
    k = min(k, scores.shape[-1])
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.zeros_like(scores).scatter_(1, idx, 1.0)


def sim(ar: Arith, P, arch: dict, patches, cls):
    """SIM: intra- and inter-modal top-k selection, the selected patches
    fused into the CLS stack by cross-attention and an FFN → [B, 3·D]."""
    B, M, L, D = patches.shape
    k, s = arch["topk"], "SIM."
    intra = torch.softmax(torch.einsum("bmd,bmld->bml", cls, patches) / math.sqrt(D), -1)
    intra = _topk_mask(intra.reshape(B * M, L), min(k, L)).reshape(B, M, L)
    q = cls @ P[s + "token_selection.W_q.weight"].t() + P[s + "token_selection.W_q.bias"]
    kk = (patches.reshape(B, M * L, D) @ P[s + "token_selection.W_k.weight"].t()
          + P[s + "token_selection.W_k.bias"])
    scores = torch.softmax(torch.einsum("bmd,bnd->bmn", q, kk) / math.sqrt(D), dim=-1)
    votes = torch.zeros(B, M, L, device=patches.device)
    for m, (a, b) in enumerate(([1, 2], [0, 2], [0, 1])):
        cross = torch.cat([scores[:, m, a * L:(a + 1) * L], scores[:, m, b * L:(b + 1) * L]], -1)
        flat = _topk_mask(cross, min(2 * k, 2 * L))
        votes[:, a] = torch.maximum(votes[:, a], flat[:, :L])
        votes[:, b] = torch.maximum(votes[:, b], flat[:, L:])
    masks = ((votes + intra) > 0).float()
    kv = (patches * masks[..., None]).reshape(B, M * L, D)
    mi = s + "modal_interactive."
    x = layer_norm(cls + attention(ar, P, mi + "cross_attn", cls, kv, arch["sim_heads"]), P,
                   mi + "norm1")
    h = F.gelu(linear(ar, x, P[mi + "ffn.0.weight"], P[mi + "ffn.0.bias"]))
    x = layer_norm(x + linear(ar, h, P[mi + "ffn.2.weight"], P[mi + "ffn.2.bias"]), P,
                   mi + "norm2")
    return x.reshape(B, M * D)


def features(ar: Arith, P, arch: dict, imgs, cams):
    """The gallery features, taken before the BNNecks: [B, 3·D] of CLS, and
    SIM's [B, 3·D] after them where the model has SIM."""
    patches, cls = encode(ar, P, arch, imgs, cams)
    ori = cls.reshape(cls.shape[0], -1)
    return torch.cat([ori, sim(ar, P, arch, patches, cls)], -1) if arch["use_a"] else ori


# ------------------------------------------------------------ GAM and LAM

def gam(P, patches):
    f = patches.mean(dim=2)
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)
    a, b, c = f[:, 0], f[:, 1], f[:, 2]
    # the 3×3 Gram determinant of (a_i, b_j, c_j), expanded
    aa, bb, cc = (a * a).sum(-1)[:, None], (b * b).sum(-1)[None], (c * c).sum(-1)[None]
    ab, ac, bc = a @ b.T, a @ c.T, (b * c).sum(-1)[None]
    det = aa * (bb * cc - bc * bc) - ab * (ab * cc - bc * ac) + ac * (ab * bc - bb * ac)
    v = torch.sqrt(det.abs() + 1e-12) / P["AlignM.contra_temp"]

    def smooth_ce(logits, eps=0.1):
        logp = torch.log_softmax(logits, dim=-1)
        return (-(1.0 - eps) * logp.diagonal() - eps * logp.mean(dim=-1)).mean()

    return 0.5 * (smooth_ce(-v) + smooth_ce(-v.T))


def _das(P, name, x):
    """x [B, C, H, W] → x sampled at one learnt offset a 4×4 cell."""
    C = x.shape[1]
    d = f"AlignM.DAS_{name}."
    q = F.conv2d(x, P[d + "proj_q.weight"], P[d + "proj_q.bias"])
    hmap = F.gelu(F.conv2d(q, P[d + "conv_offset.0.weight"], P[d + "conv_offset.0.bias"]))
    hmap = F.gelu(F.conv2d(hmap, P[d + "conv_offset.2.weight"], P[d + "conv_offset.2.bias"],
                           stride=4, groups=C))
    off = F.conv2d(hmap, P[d + "conv_offset.4.weight"])
    hk, wk = off.shape[2], off.shape[3]
    rng = torch.tensor([1.0 / max(hk - 1.0, 1.0), 1.0 / max(wk - 1.0, 1.0)], device=x.device)
    off = (torch.tanh(off) * rng[None, :, None, None] * 2.0).permute(0, 2, 3, 1)
    ys = (torch.arange(hk, device=x.device) + 0.5) / max(hk - 1.0, 1.0) * 2.0 - 1.0
    xs = (torch.arange(wk, device=x.device) + 0.5) / max(wk - 1.0, 1.0) * 2.0 - 1.0
    ref = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    pos = torch.clamp(off + ref[None], -1.0, 1.0)
    return F.grid_sample(x, pos.flip(-1), mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def lam(P, arch, patches):
    B, M, L, D = patches.shape
    grids = patches.reshape(B, M, arch["h"], arch["w"], D).permute(0, 1, 4, 2, 3)
    r, n, t = (_das(P, m, grids[:, i]) for i, m in enumerate("rnt"))
    mse = lambda a, b: ((a - b) ** 2).mean()  # noqa: E731
    return (mse(n, r) + mse(t, r) + mse(t, n)) / 3.0


# -------------------------------------------------------------------- losses

def _xent(logits, target, num_classes, smooth: bool):
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(target, num_classes).float()
    if smooth:
        return (-((1.0 - 0.1) * onehot + 0.1 / num_classes) * logp).mean(dim=0).sum()
    return -(onehot * logp).sum(-1).mean()


def _triplet(feat, labels, margin):
    """Batch-hard triplet over Euclidean distances (clamped at 1e-12)."""
    sq = (feat * feat).sum(1)
    dist = torch.sqrt(torch.clamp(sq[:, None] + sq[None] - 2.0 * feat @ feat.T, min=1e-12))
    pos = labels[:, None] == labels[None]
    ap = torch.where(pos, dist, torch.finfo(dist.dtype).min).amax(1)
    an = torch.where(pos, torch.finfo(dist.dtype).max, dist).amin(1)
    if margin is None:
        return F.softplus(-(an - ap)).mean()
    return F.relu(ap - an + margin).mean()


def _bnneck(x, weight, bias):
    mean, var = x.mean(0), x.var(0, unbiased=False)
    return (x - mean) / torch.sqrt(var + 1e-5) * weight + bias


def train_loss(ar: Arith, P, arch: dict, hp: dict, imgs, pids, cams):
    """The train step's loss for a normalised, augmented batch: each
    (score, feature) head's label-smoothed ID loss and triplet, plus the
    GAM and LAM terms with the recipe's weights."""
    patches, cls = encode(ar, P, arch, imgs, cams, checkpoint=True)
    heads = []
    B, C = cls.shape[0], arch["num_classes"]
    if arch["direct"]:
        heads.append(("bottleneck", "classifier", cls.reshape(B, -1)))
    else:
        heads += [(f"bottleneck_{m}", f"classifier_{m}", cls[:, i]) for i, m in enumerate("rnt")]
    if arch["use_a"]:
        heads.append(("bottleneck_var", "classifier_var", sim(ar, P, arch, patches, cls)))
    margin = None if hp["no_margin"] else hp["margin"]
    loss = 0.0
    for bn, clf, feat in heads:
        score = _bnneck(feat, P[bn + ".weight"], P[bn + ".bias"]) @ P[clf + ".weight"].t()
        loss = loss + hp["id_w"] * _xent(score, pids, C, hp["label_smooth"]) \
            + hp["tri_w"] * _triplet(feat, pids, margin)
    if arch["use_b"]:
        loss = loss + hp["gram_w"] * gam(P, patches)
        if arch["stage"] != "CLS":
            loss = loss + hp["pat_w"] * lam(P, arch, patches)
    return loss
