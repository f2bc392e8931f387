"""Train losses (port of `signal_tpu/losses.py`): label-smoothed ID loss,
batch-hard triplet, center loss, and the per-head combination.

Behavioral mirrors of `layers/{make_loss,triplet_loss,softmax_loss}.py`
(maxingan2412/Signal):

* CrossEntropyLabelSmooth: ε = 0.1, the reference's
  ``(-targets · logp).mean(0).sum()``;
* TripletLoss: batch-hard mining over the true-fp32 Euclidean distance
  matrix (masked max/min); soft margin (softplus) when NO_MARGIN, else the
  margin ranking loss;
* CenterLoss: the clamped squared distance of each sample to its own
  class centre, summed and divided by the batch size. The centres are not
  a model parameter: the train step owns them and moves them by plain SGD
  (``engine/train.py``);
* make_loss: the per-head closure, and total_train_loss the
  sign-dispatched sum with the GAM and LAM weights.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from signal_tpu_torch.ops.distmat import euclidean_distmat


def cross_entropy_label_smooth(logits: torch.Tensor, targets: torch.Tensor,
                               num_classes: int, epsilon: float = 0.1) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(targets, num_classes).float()
    smoothed = (1.0 - epsilon) * onehot + epsilon / num_classes
    return (-smoothed * logp).mean(dim=0).sum()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, targets[:, None]).mean()


def hard_example_mining(dist_mat: torch.Tensor, labels: torch.Tensor):
    """For each anchor: the hardest positive (largest distance, itself
    included) and the hardest negative (smallest distance)."""
    is_pos = labels[:, None] == labels[None, :]
    finfo = torch.finfo(torch.float32)
    dist_ap = torch.where(is_pos, dist_mat, finfo.min).amax(dim=1)
    dist_an = torch.where(is_pos, finfo.max, dist_mat).amin(dim=1)
    return dist_ap, dist_an


def triplet_loss(feats: torch.Tensor, labels: torch.Tensor, margin: Optional[float] = None):
    """→ (loss, dist_ap, dist_an). ``margin=None`` → soft margin."""
    f = feats.float()
    dist = euclidean_distmat(f, f)
    dist_ap, dist_an = hard_example_mining(dist, labels)
    if margin is not None:
        # MarginRankingLoss(y=1): mean(relu(ap − an + margin))
        loss = F.relu(dist_ap - dist_an + margin).mean()
    else:
        # SoftMarginLoss(x, y=1): mean(softplus(−x)), x = an − ap
        loss = F.softplus(-(dist_an - dist_ap)).mean()
    return loss, dist_ap, dist_an


def center_loss(centers: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """centers [C, D], feats [B, D] → Σ_b clamp(‖f_b − c_{y_b}‖², 1e-12, 1e12) / B
    (`center_loss.py:31-55`), from the expanded squared distance as the JAX
    package computes it."""
    f = feats.float()
    d = ((f * f).sum(dim=1)[:, None] + (centers * centers).sum(dim=1)[None, :]
         - 2.0 * f @ centers.t())
    mask = F.one_hot(labels, centers.shape[0]).float()
    return (d.clamp(1e-12, 1e12) * mask).sum() / f.shape[0]


def make_loss(cfg, num_classes: int) -> Callable:
    """Per-head loss closure (`make_loss.py:29-193`): loss_fn(score, feat,
    target); a list of scores or feats weighs its first element 0.5 and
    the mean of the rest 0.5. A ``center`` METRIC_LOSS_TYPE adds
    :func:`center_loss` in the train step, which holds the centres."""
    id_w = cfg.MODEL.ID_LOSS_WEIGHT
    tri_w = cfg.MODEL.TRIPLET_LOSS_WEIGHT
    smooth_on = cfg.MODEL.IF_LABELSMOOTH == "on"
    margin = None if cfg.MODEL.NO_MARGIN else cfg.SOLVER.MARGIN
    sampler = cfg.DATALOADER.SAMPLER

    def xent(score, target):
        if smooth_on:
            return cross_entropy_label_smooth(score, target, num_classes)
        return cross_entropy(score, target)

    def loss_fn(score, feat, target):
        if sampler == "softmax":
            return cross_entropy(score, target)
        if isinstance(score, (list, tuple)):
            rest = sum(xent(s, target) for s in score[1:]) / max(len(score) - 1, 1)
            id_loss = 0.5 * rest + 0.5 * xent(score[0], target)
        else:
            id_loss = xent(score, target)
        if isinstance(feat, (list, tuple)):
            rest = sum(triplet_loss(f, target, margin)[0] for f in feat[1:]) / max(len(feat) - 1, 1)
            tri = 0.5 * rest + 0.5 * triplet_loss(feat[0], target, margin)[0]
        else:
            tri = triplet_loss(feat, target, margin)[0]
        return id_w * id_loss + tri_w * tri

    return loss_fn


def total_train_loss(outputs: dict, targets: torch.Tensor, loss_fn: Callable, *,
                     gram_weight: float, pat_weight: float) -> torch.Tensor:
    """Sign-dispatch loss assembly (`engine/processor.py:176-256`): one
    loss_fn term per (score, feat) head, + α·GAM + β·LAM."""
    loss = 0.0
    for score, feat in zip(outputs["scores"], outputs["feats"]):
        loss = loss + loss_fn(score, feat, targets)
    if outputs.get("gam") is not None:
        loss = loss + gram_weight * outputs["gam"]
    if outputs.get("lam") is not None:
        loss = loss + pat_weight * outputs["lam"]
    return loss
