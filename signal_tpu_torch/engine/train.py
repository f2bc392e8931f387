"""Training engine: the train step, the per-epoch schedule, in-training
eval and checkpoints (port of `signal_tpu/engine/train.py`, the
reference's `engine/processor.py:41-350`).

One step: device Normalize → device augment (flip, pad + crop, erase) →
``forward_train`` → ``total_train_loss`` → ``backward`` → optimizer step.
Loss and accuracy stay on the device until a log line needs them. The
whole step runs with TF32 off (:func:`true_fp32`): the backward of the
fp32 convolutions and GEMMs would otherwise take TF32 on the card, where
the JAX package's HIGHEST-precision transposes do not; the bf16 GEMMs do
not change.

Not ported yet (ROADMAP Queue 1 item 8): gradient accumulation
(SOLVER.ACCUM_ITER > 1), center loss and the SIGTERM preemption save.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Optional

import torch

from signal_tpu_torch.data.augment import augment_batch, normalize_images
from signal_tpu_torch.data.prefetch import prefetch
from signal_tpu_torch.losses import make_loss, total_train_loss
from signal_tpu_torch.metrics import R1mAPEvaluator
from signal_tpu_torch.models.signal_model import Signal, forward_train
from signal_tpu_torch.ops.attention import true_fp32
from signal_tpu_torch.solver import current_lr, make_optimizer, schedule_coeffs, set_lr
from signal_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from signal_tpu_torch.utils.meter import AverageMeter

logger = logging.getLogger("signal_tpu_torch.train")


@dataclasses.dataclass
class TrainState:
    model: Signal
    optimizer: torch.optim.Optimizer
    epoch: int = 0                    # last completed epoch
    loss: float = float("nan")        # mean loss of the last epoch
    acc: float = float("nan")
    mAP: Optional[float] = None       # of the last in-training eval
    cmc: Optional[object] = None


def make_train_step(model: Signal, cfg, num_classes: int, optimizer: torch.optim.Optimizer, *,
                    device_augment: bool = False,
                    gen: Optional[torch.Generator] = None) -> Callable:
    """→ ``train_step(imgs, pids, camids) -> (loss, acc)``, both 0-d tensors
    on the device. ``imgs``: a packed [B, 3, 3, H, W] batch (uint8, or float
    normalized on the host) or a modality dict. ``device_augment`` draws
    flip / pad + crop / erase from ``gen`` (a generator on the device).

    ``train_step.stages`` holds the four stages the step runs, in order
    (``prepare``, ``forward``, ``backward``, ``update``), so that a profiler
    can time each stage of this very step."""
    if int(cfg.SOLVER.ACCUM_ITER) > 1:
        raise NotImplementedError(
            "SOLVER.ACCUM_ITER > 1 (gradient accumulation) is not ported yet "
            "(ROADMAP Queue 1 item 8)")
    if device_augment and gen is None:
        raise ValueError("device_augment needs a torch.Generator on the batch's device")
    loss_fn = make_loss(cfg, num_classes)
    gram_w, pat_w = cfg.MODEL.Gram_Loss_weight, cfg.MODEL.PAT_Loss_weight
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    aug = dict(flip_prob=float(cfg.INPUT.PROB), re_prob=float(cfg.INPUT.RE_PROB),
               padding=int(cfg.INPUT.PADDING),
               fill=tuple((0.0 - m) / s for m, s in zip(mean, std)))

    @torch.no_grad()
    def prepare(imgs):
        imgs = normalize_images(imgs, mean, std)
        if device_augment:
            if not isinstance(imgs, dict):
                imgs = {"RGB": imgs[:, 0], "NI": imgs[:, 1], "TI": imgs[:, 2]}
            imgs = augment_batch(gen, imgs, **aug)
        return imgs

    def forward(imgs, pids, camids):
        with true_fp32():
            out = forward_train(model, imgs, camids)
            return out, total_train_loss(out, pids, loss_fn, gram_weight=gram_w,
                                         pat_weight=pat_w)

    def backward(loss):
        optimizer.zero_grad(set_to_none=True)
        with true_fp32():
            loss.backward()

    def update(out, loss, pids):
        optimizer.step()
        acc = (out["scores"][0].argmax(dim=1) == pids).float().mean()
        return loss.detach(), acc

    def train_step(imgs, pids: torch.Tensor, camids: torch.Tensor):
        out, loss = forward(prepare(imgs), pids, camids)
        backward(loss)
        return update(out, loss, pids)

    train_step.stages = (prepare, forward, backward, update)
    return train_step


def do_train(cfg, model: Signal, train_loader, val_loader, num_query: int, num_classes: int, *,
             device: torch.device, max_steps_per_epoch: Optional[int] = None,
             resume_from: Optional[str] = None) -> TrainState:
    """The training loop (`processor.py:41-350`): per epoch the schedule's
    lr, the steps with the reference's log lines, a full checkpoint every
    CHECKPOINT_PERIOD epochs, and an eval every EVAL_PERIOD epochs (with a
    ``best`` checkpoint by mAP). ``resume_from``: a checkpoint written by
    this loop; training continues at the epoch after the saved one."""
    optimizer = make_optimizer(model, cfg)
    n_total = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for g in optimizer.param_groups for p in g["params"])
    logger.info("number of parameters: %.6fM (trainable %.6fM)", n_total / 1e6, n_train / 1e6)
    device_augment = bool(getattr(train_loader, "device_augment", False))
    gen = torch.Generator(device=device).manual_seed(int(cfg.SOLVER.SEED))
    train_step = make_train_step(model, cfg, num_classes, optimizer,
                                 device_augment=device_augment, gen=gen)
    state = TrainState(model, optimizer)
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, cfg.ckpt_save_path)
    os.makedirs(ckpt_dir, exist_ok=True)
    if resume_from:
        state.epoch = load_checkpoint(resume_from, model, optimizer, gen)
        logger.info("Resumed from %s at epoch %d", resume_from, state.epoch + 1)

    evaluator = R1mAPEvaluator(num_query, feat_norm=cfg.TEST.FEAT_NORM == "yes",
                               reranking=cfg.TEST.RE_RANKING == "yes",
                               scene_aware=cfg.DATASETS.NAMES == "MSVR310")
    best = {"mAP": 0.0, "Rank-1": 0.0, "Rank-5": 0.0, "Rank-10": 0.0}
    loss_meter, acc_meter = AverageMeter(), AverageMeter()

    def put(batch):
        imgs = torch.from_numpy(batch["packed"]).to(device, non_blocking=True)
        pids = torch.from_numpy(batch["pids"]).to(device, non_blocking=True)
        camids = torch.from_numpy(batch["camids"]).to(device, non_blocking=True)
        return imgs, pids, camids

    for epoch in range(state.epoch + 1, cfg.SOLVER.MAX_EPOCHS + 1):
        t0 = time.time()
        loss_meter.reset()
        acc_meter.reset()
        set_lr(optimizer, *schedule_coeffs(cfg, epoch))
        pending = []
        n_iter = 0
        # decode + H2D of batch n+1 overlap the step on batch n
        for n_iter, (imgs, pids, camids) in enumerate(prefetch(train_loader, put)):
            loss, acc = train_step(imgs, pids, camids)
            pending.append((loss, acc, pids.shape[0]))
            if (n_iter + 1) % cfg.SOLVER.LOG_PERIOD == 0:
                for pl, pa, n in pending:
                    loss_meter.update(float(pl), n)
                    acc_meter.update(float(pa), 1)
                pending.clear()
                logger.info("Epoch[%d] Iteration[%d/%d] Loss: %.3f, Acc: %.3f, Base Lr: %.2e",
                            epoch, n_iter + 1, len(train_loader), loss_meter.avg,
                            acc_meter.avg, current_lr(cfg, epoch))
            if max_steps_per_epoch and n_iter + 1 >= max_steps_per_epoch:
                break
        for pl, pa, n in pending:
            loss_meter.update(float(pl), n)
            acc_meter.update(float(pa), 1)
        time_per_batch = (time.time() - t0) / (n_iter + 1)
        logger.info("Epoch %d done. Time per batch: %.3f[s] Speed: %.1f[samples/s]",
                    epoch, time_per_batch, cfg.SOLVER.IMS_PER_BATCH / time_per_batch)
        state.epoch, state.loss, state.acc = epoch, loss_meter.avg, acc_meter.avg

        if epoch % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
            save_checkpoint(os.path.join(ckpt_dir, f"{cfg.MODEL.NAME}_{epoch}.pth"),
                            model, optimizer, epoch, gen)
        if epoch % cfg.SOLVER.EVAL_PERIOD == 0 and val_loader is not None:
            state.mAP, state.cmc = _neat_eval(cfg, model, val_loader, evaluator, epoch, device)
            if state.mAP >= best["mAP"]:
                best.update({"mAP": state.mAP, "Rank-1": state.cmc[0],
                             "Rank-5": state.cmc[4], "Rank-10": state.cmc[9]})
                save_checkpoint(os.path.join(ckpt_dir, f"{cfg.MODEL.NAME}best.pth"), model)
            logger.info("~" * 50)
            for k in ("mAP", "Rank-1", "Rank-5", "Rank-10"):
                logger.info("Best %s: %.1f%%", k, 100 * best[k])
            logger.info("~" * 50)
    return state


def _neat_eval(cfg, model: Signal, val_loader, evaluator: R1mAPEvaluator, epoch: int,
               device: torch.device):
    """In-training eval (`training_neat_eval`, `processor.py:454-539`)."""
    from signal_tpu_torch.engine.eval import extract_features

    evaluator.reset()
    extract_features(model, val_loader, evaluator, device=device,
                     normalize=(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD))
    cmc, mAP, *_ = evaluator.compute()
    logger.info("Validation Results - Epoch: %d", epoch)
    logger.info("mAP: %.1f%%", 100 * mAP)
    for r in (1, 5, 10):
        logger.info("CMC curve, Rank-%-3d:%.1f%%", r, 100 * cmc[r - 1])
    return float(mAP), cmc
