"""Metric-learning heads and auxiliary losses (port of
`signal_tpu/losses_metric.py`).

Behavioral mirrors of `layers/{metric_learning,cluster_loss,range_loss,
hcloss,mutilmargin}.py` (maxingan2412/Signal), which the shipped Signal
train path does not use: plain tensor functions a loss closure can pick
up, as in the JAX package.

* The margin heads (ArcFace, CosFace, AM-Softmax, Circle) take an explicit
  weight ``{"weight": [C, D]}`` from :func:`init_margin_head`.
* The per-class losses assume the PK sampler's ordered batch,
  ``labels.reshape(P, K)`` (the reference's own fast path,
  `cluster_loss.py:46-48`, `range_loss.py:106-108`).
* Every product is true fp32 (JAX asks for ``Precision.HIGHEST``).
* Where JAX sorts (``range_loss``), the sort is stable, as ``jnp.sort``
  is, so tied distances send their gradient to the same elements; the
  max/min reductions (``amax``/``amin``) share a tie's gradient evenly,
  as JAX's do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from signal_tpu_torch.ops.attention import true_fp32
from signal_tpu_torch.ops.distmat import euclidean_distmat


def _l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(x.norm(dim=dim, keepdim=True), min=eps)


def _cosine(params: dict, feats: torch.Tensor) -> torch.Tensor:
    with true_fp32():
        return _l2norm(feats.float()) @ _l2norm(params["weight"]).T


def _onehot(labels: torch.Tensor, params: dict) -> torch.Tensor:
    return F.one_hot(labels, params["weight"].shape[0]).float()


# --------------------------------------------------------------------------
# margin-based classification heads (`metric_learning.py`)
# --------------------------------------------------------------------------

def init_margin_head(gen: torch.Generator, in_features: int, num_classes: int,
                     kind: str = "arcface") -> dict:
    """``{"weight": [num_classes, in_features]}`` drawn from ``gen`` (on
    the device the weight is wanted on) by the reference modules' laws:
    xavier-uniform for arcface and cosface (`metric_learning.py:93,141`),
    kaiming-uniform(a=√5) over fan-in for circle (l.56), xavier-normal for
    amsoftmax (l.172-174)."""
    w = torch.empty(num_classes, in_features, device=gen.device)
    if kind in ("arcface", "cosface"):
        bound = math.sqrt(6.0 / (in_features + num_classes))
        w.uniform_(-bound, bound, generator=gen)
    elif kind == "circle":
        bound = math.sqrt(6.0 / ((1 + 5) * in_features))
        w.uniform_(-bound, bound, generator=gen)
    elif kind == "amsoftmax":
        w.normal_(0.0, math.sqrt(2.0 / (in_features + num_classes)), generator=gen)
    else:
        raise ValueError(f"unknown margin head {kind!r}")
    return {"weight": w}


def arcface_logits(params: dict, feats: torch.Tensor, labels: torch.Tensor,
                   s: float = 30.0, m: float = 0.30, easy_margin: bool = False,
                   ls_eps: float = 0.0) -> torch.Tensor:
    """cos(θ + m) on the target class (`metric_learning.py:101-121`)."""
    cosine = _cosine(params, feats)
    sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 0.0, 1.0))
    phi = cosine * math.cos(m) - sine * math.sin(m)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        th = math.cos(math.pi - m)
        mm = math.sin(math.pi - m) * m
        phi = torch.where(cosine > th, phi, cosine - mm)
    onehot = _onehot(labels, params)
    if ls_eps > 0:
        onehot = (1 - ls_eps) * onehot + ls_eps / params["weight"].shape[0]
    return s * (onehot * phi + (1.0 - onehot) * cosine)


def cosface_logits(params: dict, feats: torch.Tensor, labels: torch.Tensor,
                   s: float = 30.0, m: float = 0.30) -> torch.Tensor:
    """cos(θ) − m on the target class (`metric_learning.py:143-156`)."""
    cosine = _cosine(params, feats)
    onehot = _onehot(labels, params)
    return s * (onehot * (cosine - m) + (1.0 - onehot) * cosine)


def amsoftmax_logits(params: dict, feats: torch.Tensor, labels: torch.Tensor,
                     s: float = 30.0, m: float = 0.30) -> torch.Tensor:
    """Additive-margin softmax logits (`metric_learning.py:176-189`)."""
    return s * (_cosine(params, feats) - m * _onehot(labels, params))


def circle_logits(params: dict, feats: torch.Tensor, labels: torch.Tensor,
                  s: float = 256.0, m: float = 0.25) -> torch.Tensor:
    """Circle-loss pair-weighted logits (`metric_learning.py:58-73`); α_p
    and α_n come from the detached similarities, as the reference's
    ``.detach()``."""
    sim = _cosine(params, feats)
    alpha_p = F.relu(-sim.detach() + 1 + m)
    alpha_n = F.relu(sim.detach() + m)
    s_p = s * alpha_p * (sim - (1 - m))
    s_n = s * alpha_n * (sim - m)
    onehot = _onehot(labels, params)
    return onehot * s_p + (1.0 - onehot) * s_n


# --------------------------------------------------------------------------
# pairwise contrastive loss (`metric_learning.py:9-42`)
# --------------------------------------------------------------------------

def contrastive_loss(feats: torch.Tensor, labels: torch.Tensor,
                     margin: float = 0.3) -> torch.Tensor:
    """Per anchor: Σ(1 − sim) over positives with sim < 1 (the reference's
    self-pair removal, which assumes unit-norm inputs), plus Σ sim over
    negatives with sim > margin; the mean over anchors."""
    f = feats.float()
    with true_fp32():
        sim = f @ f.T
    same = labels[:, None] == labels[None, :]
    pos = torch.where(same & (sim < 1.0), 1.0 - sim, 0.0).sum(dim=1)
    neg = torch.where(~same & (sim > margin), sim, 0.0).sum(dim=1)
    return (pos + neg).mean()


# --------------------------------------------------------------------------
# PK-structured class-centre losses
# --------------------------------------------------------------------------

def _members(feats: torch.Tensor, imgs_per_id: int) -> torch.Tensor:
    """[P·K, D] → [P, K, D] fp32 (a PK-ordered batch)."""
    f = feats.float()
    return f.reshape(f.shape[0] // imgs_per_id, imgs_per_id, -1)


def _pk_centers(feats: torch.Tensor, imgs_per_id: int) -> torch.Tensor:
    return _members(feats, imgs_per_id).mean(dim=1)


def cluster_loss(feats: torch.Tensor, imgs_per_id: int, margin: float = 10.0) -> torch.Tensor:
    """relu(max intra-centre distance − min inter-centre distance +
    margin), the mean over classes (`cluster_loss.py:33-88`)."""
    members = _members(feats, imgs_per_id)                       # [P, K, D]
    p = members.shape[0]
    centers = members.mean(dim=1)                                # [P, D]
    d_intra = torch.sqrt(torch.clamp(((members - centers[:, None, :]) ** 2).sum(dim=-1),
                                     min=1e-12))
    intra_max = d_intra.amax(dim=1)                              # [P]
    d_cc = euclidean_distmat(centers, centers)                   # [P, P]
    eye = torch.eye(p, dtype=torch.bool, device=d_cc.device)
    inter_min = torch.where(eye, torch.finfo(torch.float32).max, d_cc).amin(dim=1)
    return F.relu(intra_max - inter_min + margin).mean()


def range_loss(feats: torch.Tensor, imgs_per_id: int, k: int = 2, margin: float = 0.1,
               alpha: float = 0.5, beta: float = 0.5):
    """α·Σ_class harmonic mean(top-k intra pair distances) + β·relu(margin −
    min inter-centre distance) (`range_loss.py:38-91,152-186`). → (range,
    intra, inter), as the reference."""
    members = _members(feats, imgs_per_id)
    p = members.shape[0]
    # each class's [K, K] distances flattened and sorted; the stride of 2
    # over the tail takes the top-k distinct pairs of the symmetric matrix
    d = torch.stack([euclidean_distmat(x, x).reshape(-1) for x in members])
    topk = torch.sort(d, dim=1, stable=True).values[:, -2 * k::2]          # [P, k]
    intra = (k / (1.0 / topk).sum(dim=1)).sum()
    centers = members.mean(dim=1)
    d_cc = euclidean_distmat(centers, centers).reshape(-1)
    # the first P sorted entries are the ~zero diagonal; entry P is the
    # smallest off-diagonal one (`range_loss.py:91`)
    inter = F.relu(margin - torch.sort(d_cc, stable=True).values[p])
    return alpha * intra + beta * inter, intra, inter


def hetero_center_loss(feat1: torch.Tensor, feat2: torch.Tensor, imgs_per_id: int,
                       dist_type: str = "l2") -> torch.Tensor:
    """Σ over classes of a distance between the two modalities' class
    centres (`hcloss.py:19-39`); the reference never applies its
    ``margin`` argument, and neither does this."""
    c1, c2 = _pk_centers(feat1, imgs_per_id), _pk_centers(feat2, imgs_per_id)
    if dist_type == "l2":
        per_class = ((c1 - c2) ** 2).sum(dim=1)                  # MSE 'sum'
    elif dist_type == "l1":
        per_class = (c1 - c2).abs().mean(dim=1)                  # L1Loss 'mean'
    elif dist_type == "cos":
        per_class = F.relu(1.0 - (_l2norm(c1) * _l2norm(c2)).sum(dim=1))
    else:
        raise ValueError(f"unknown dist_type {dist_type!r}")
    return per_class.abs().sum()


def multi_modal_margin_loss(feat1: torch.Tensor, feat2: torch.Tensor, feat3: torch.Tensor,
                            imgs_per_id: int, margin: float = 3.0) -> torch.Tensor:
    """Σ over classes of the largest |margin − ‖cᵃ − cᵇ‖²| over the three
    modality pairs (`mutilmargin.py:20-41`, dist_type 'l2')."""
    c1, c2, c3 = (_pk_centers(f, imgs_per_id) for f in (feat1, feat2, feat3))
    d12 = ((c1 - c2) ** 2).sum(dim=1)
    d23 = ((c2 - c3) ** 2).sum(dim=1)
    d13 = ((c1 - c3) ** 2).sum(dim=1)
    per_class = torch.maximum(torch.maximum((margin - d12).abs(), (margin - d23).abs()),
                              (margin - d13).abs())
    return per_class.sum()
