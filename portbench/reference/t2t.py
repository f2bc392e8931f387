"""Signal on the T2T-ViT-t-14 tower in plain PyTorch: the reference the
benchmark's T2T cell holds the port to.

The tower follows Yuan et al., "Tokens-to-Token ViT" (ICCV 2021) and
yitu-opensource/T2T-ViT ``models/t2t_vit.py`` (``t2t_vit_t_14``: the
'transformer' tokens type, embed 384, depth 14, 6 heads, mlp ratio 3,
token_dim 64), as Signal builds it for MODEL.TRANSFORMER_TYPE
t2t_vit_t_14 (maxingan2412/Signal ``modeling/make_model.py:294-301``).
At an H×W image:

1. soft split 1: unfold k7, s4, p2 → (H/4)(W/4) tokens of 3·7·7 = 147;
2. token transformer 1 (147 → 64, one head): h = LN(x); q, k, v = h·W_qkv
   (no bias); A = softmax(q·kᵀ·147^-1/2), the INPUT dim's scale as
   published; x = v + (A·v)·W_o + b_o, the v-skip; x += MLP(LN x), MLP
   64 → 64 → 64 with GELU;
3. soft split 2 (k3, s2, p1) → (H/8)(W/8) tokens of 576; token
   transformer 2 (576 → 64, scale 576^-1/2);
4. soft split 3 → (H/16)(W/16) tokens; Linear 576 → 384; [CLS]; the fixed
   sinusoid table; SIE (the camera's row × SIE_COE) on every token;
5. 14 pre-LN blocks (6 heads × 64, MLP 1152 with GELU) and a last
   LayerNorm; no output projection (the features are 384 wide).

Signal's SIM, BNNecks, GAM and LAM then run as ``reference/model.py``
has them, its functions used as they are. Everything is float32 with TF32
off. The token transformers are float32 in the port too, whatever the
compute dtype; the products the configuration runs in its compute dtype
(the projection 576 → 384, the blocks' projections, attention core and
MLP) go through :class:`model.Arith`, so that its float8 control applies.

Departures: a soft split's tokens fold back to the image's grid (H/4 ×
W/4, H/8 × W/8) where the published module assumes a square image
(Signal's change for 256×128 crops); the blocks' qkv projection has a
bias and their LayerNorms (and the last) take eps 1e-6, as the port and
the JAX package's mirror of Signal's backbone have them (the published
``T2T_ViT`` defaults to ``qkv_bias=False`` and eps 1e-5); drop-path and
dropout are left out (their published rates are 0 here).

Parameters are a dict under the names the port's ``Signal`` loads with
``strict=True`` (:func:`param_shapes`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench import spec
from portbench.reference import model as ref
from portbench.reference.recipe import normalize

TOWER = "base."
T2T = TOWER + "tokens_to_token."


def reference_arch(config: dict, *, train: bool) -> Dict:
    """``spec.reference_arch`` with the tokens-to-token width."""
    return {**spec.reference_arch(config, train=train),
            "token_dim": config["architecture"]["token_dim"]}


def sinusoid_table(n: int, d: int) -> torch.Tensor:
    """T2T-ViT's ``get_sinusoid_encoding``: [n, d], sin on even columns and
    cos on odd ones of pos / 10000^(2⌊j/2⌋/d)."""
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    j = torch.arange(d, dtype=torch.float64)[None]
    angle = pos / torch.pow(10000.0, 2 * torch.div(j, 2, rounding_mode="floor") / d)
    table = torch.where(j.long() % 2 == 0, torch.sin(angle), torch.cos(angle))
    return table.float()


# ---------------------------------------------------------------- parameters

def param_shapes(arch: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter and statistic of the model, under the port's names,
    in a fixed order: the T2T tower, then Signal's heads as
    ``model.param_shapes`` lists them."""
    W, td = arch["width"], arch["token_dim"]
    T = arch["h"] * arch["w"] + 1
    out = []
    for i, dim in ((1, 3 * 7 * 7), (2, td * 3 * 3)):
        t = f"{T2T}attention{i}."
        out += [(t + "norm1.weight", (dim,)), (t + "norm1.bias", (dim,)),
                (t + "attn.qkv.weight", (3 * td, dim)),
                (t + "attn.proj.weight", (td, td)), (t + "attn.proj.bias", (td,)),
                (t + "norm2.weight", (td,)), (t + "norm2.bias", (td,)),
                (t + "mlp.fc1.weight", (td, td)), (t + "mlp.fc1.bias", (td,)),
                (t + "mlp.fc2.weight", (td, td)), (t + "mlp.fc2.bias", (td,))]
    out += [(T2T + "project.weight", (W, td * 3 * 3)), (T2T + "project.bias", (W,)),
            (TOWER + "cls_token", (1, 1, W)), (TOWER + "pos_embed", (1, T, W))]
    if arch["sie_camera"] and arch["camera_num"] > 1:
        out += [(TOWER + "sie_embed", (arch["camera_num"], 1, W))]
    hidden = int(arch["mlp_ratio"] * W)
    for i in range(arch["layers"]):
        b = f"{TOWER}blocks.{i}."
        out += [(b + "norm1.weight", (W,)), (b + "norm1.bias", (W,)),
                (b + "attn.qkv.weight", (3 * W, W)), (b + "attn.qkv.bias", (3 * W,)),
                (b + "attn.proj.weight", (W, W)), (b + "attn.proj.bias", (W,)),
                (b + "norm2.weight", (W,)), (b + "norm2.bias", (W,)),
                (b + "mlp.fc1.weight", (hidden, W)), (b + "mlp.fc1.bias", (hidden,)),
                (b + "mlp.fc2.weight", (W, hidden)), (b + "mlp.fc2.bias", (W,))]
    out += [(TOWER + "norm.weight", (W,)), (TOWER + "norm.bias", (W,))]
    return out + [(n, s) for n, s in ref.param_shapes(arch)
                  if not n.startswith("clip_vision_encoder.")]


# --------------------------------------------------------------------- tower

def _ln(x, P, name, eps):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], eps)


def token_transformer(P, name: str, x):
    """One token transformer, float32: x [N, L, dim] → [N, L, token_dim]."""
    dim = x.shape[-1]
    h = _ln(x, P, name + ".norm1", 1e-5)
    q, k, v = (h @ P[name + ".attn.qkv.weight"].t()).chunk(3, dim=-1)
    a = torch.softmax((q @ k.transpose(-1, -2)) * dim ** -0.5, dim=-1)
    x = v + (a @ v) @ P[name + ".attn.proj.weight"].t() + P[name + ".attn.proj.bias"]
    h = F.gelu(_ln(x, P, name + ".norm2", 1e-5) @ P[name + ".mlp.fc1.weight"].t()
               + P[name + ".mlp.fc1.bias"])
    return x + h @ P[name + ".mlp.fc2.weight"].t() + P[name + ".mlp.fc2.bias"]


def _block(ar: ref.Arith, P, prefix: str, heads: int, x):
    N, L, W = x.shape
    hd = W // heads
    h = _ln(x, P, prefix + "norm1", 1e-6)
    qkv = ref.linear(ar, h, P[prefix + "attn.qkv.weight"], P[prefix + "attn.qkv.bias"])
    q, k, v = (t.reshape(N, L, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    p = torch.softmax(ar.mm(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    o = ar.mm(p, v).transpose(1, 2).reshape(N, L, W)
    x = x + ref.linear(ar, o, P[prefix + "attn.proj.weight"], P[prefix + "attn.proj.bias"])
    h = F.gelu(ref.linear(ar, _ln(x, P, prefix + "norm2", 1e-6), P[prefix + "mlp.fc1.weight"],
                          P[prefix + "mlp.fc1.bias"]))
    return x + ref.linear(ar, h, P[prefix + "mlp.fc2.weight"], P[prefix + "mlp.fc2.bias"])


def token_map(P, arch: dict, images):
    """Soft splits 1 and 2 and their token transformers, float32: images
    [N, 3, H, W] (normalised) → [N, token_dim, H/8, W/8]."""
    N, _, H, W = images.shape
    td = arch["token_dim"]
    x = token_transformer(P, T2T + "attention1", F.unfold(images, 7, padding=2, stride=4)
                          .transpose(1, 2))
    x = x.transpose(1, 2).reshape(N, td, H // 4, W // 4)
    x = token_transformer(P, T2T + "attention2", F.unfold(x, 3, padding=1, stride=2)
                          .transpose(1, 2))
    return x.transpose(1, 2).reshape(N, td, H // 8, W // 8)


def tower(ar: ref.Arith, P, arch: dict, images, cams, checkpoint: bool = False):
    """images [N, 3, H, W] (normalised), cams [N] or None → [N, 1 + L, width]."""
    N = images.shape[0]
    x = ref.linear(ar, F.unfold(token_map(P, arch, images), 3, padding=1, stride=2)
                   .transpose(1, 2),
                   P[T2T + "project.weight"], P[T2T + "project.bias"])
    x = torch.cat([P[TOWER + "cls_token"].expand(N, 1, -1), x], dim=1) + P[TOWER + "pos_embed"]
    if cams is not None and TOWER + "sie_embed" in P:
        x = x + arch["sie_coe"] * P[TOWER + "sie_embed"][cams]
    for i in range(arch["layers"]):
        fn = lambda t, i=i: _block(ar, P, f"{TOWER}blocks.{i}.", arch["heads"], t)  # noqa: E731
        x = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False) if checkpoint \
            else fn(x)
    return _ln(x, P, TOWER + "norm", 1e-6)


def encode(ar: ref.Arith, P, arch: dict, imgs, cams, checkpoint: bool = False):
    """imgs [B, 3 modalities, 3, H, W] → (patches [B, 3, L, D], cls [B, 3, D])."""
    B = imgs.shape[0]
    out = tower(ar, P, arch, imgs.reshape(B * 3, *imgs.shape[2:]),
                cams.repeat_interleave(3) if cams is not None else None, checkpoint)
    L, D = out.shape[1] - 1, out.shape[2]
    return out[:, 1:].reshape(B, 3, L, D), out[:, 0].reshape(B, 3, D)


def features(ar: ref.Arith, P, arch: dict, imgs, cams):
    """The gallery features, before the BNNecks: [B, 3·D] of CLS, and SIM's
    [B, 3·D] after them where the model has SIM."""
    patches, cls = encode(ar, P, arch, imgs, cams)
    ori = cls.reshape(cls.shape[0], -1)
    return torch.cat([ori, ref.sim(ar, P, arch, patches, cls)], -1) if arch["use_a"] else ori


def train_loss(ar: ref.Arith, P, arch: dict, hp: dict, imgs, pids, cams):
    """The train step's loss, as ``model.train_loss`` takes it from the
    CLIP tower's outputs: each head's ID loss and triplet, GAM and LAM."""
    patches, cls = encode(ar, P, arch, imgs, cams, checkpoint=True)
    B, C = cls.shape[0], arch["num_classes"]
    if arch["direct"]:
        heads = [("bottleneck", "classifier", cls.reshape(B, -1))]
    else:
        heads = [(f"bottleneck_{m}", f"classifier_{m}", cls[:, i]) for i, m in enumerate("rnt")]
    if arch["use_a"]:
        heads.append(("bottleneck_var", "classifier_var", ref.sim(ar, P, arch, patches, cls)))
    margin = None if hp["no_margin"] else hp["margin"]
    loss = 0.0
    for bn, clf, feat in heads:
        score = ref._bnneck(feat, P[bn + ".weight"], P[bn + ".bias"]) @ P[clf + ".weight"].t()
        loss = loss + hp["id_w"] * ref._xent(score, pids, C, hp["label_smooth"]) \
            + hp["tri_w"] * ref._triplet(feat, pids, margin)
    if arch["use_b"]:
        loss = loss + hp["gram_w"] * ref.gam(P, patches)
        if arch["stage"] != "CLS":
            loss = loss + hp["pat_w"] * ref.lam(P, arch, patches)
    return loss


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 in CUDA products and convolutions on or off, for the block."""
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, conv


def gallery_features(weights: Dict[str, torch.Tensor], arch: dict, hp: dict, imgs_u8, cams,
                     precision: str = "fp32", rows: int = 32) -> torch.Tensor:
    """The reference's gallery features of a uint8 batch, ``rows`` samples
    at a time (stage 1's probabilities are [3·rows, L0, L0] float32)."""
    ar = ref.Arith(precision)
    P = {n: t.float() for n, t in weights.items()}
    with _tf32(False), torch.no_grad():
        outs = [features(ar, P, arch, normalize(imgs_u8[i:i + rows], hp["mean"], hp["std"]),
                         cams[i:i + rows])
                for i in range(0, imgs_u8.shape[0], rows)]
    return torch.cat(outs)


def gallery_token_maps(weights: Dict[str, torch.Tensor], arch: dict, hp: dict, imgs_u8,
                       tf32: bool = False, rows: int = 32) -> torch.Tensor:
    """:func:`token_map` of a uint8 batch's tower rows (sample-major, the
    three modalities in turn), flattened: [3·B, token_dim·H/8·W/8], in
    float32 with TF32 off, or on where ``tf32`` (the control)."""
    P = {n: t.float() for n, t in weights.items() if n.startswith(T2T)}
    with _tf32(tf32), torch.no_grad():
        outs = [token_map(P, arch, normalize(imgs_u8[i:i + rows], hp["mean"], hp["std"])
                          .flatten(0, 1)).flatten(1)
                for i in range(0, imgs_u8.shape[0], rows)]
    return torch.cat(outs)
