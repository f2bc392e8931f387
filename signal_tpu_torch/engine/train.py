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

SOLVER.ACCUM_ITER, center loss and the SIGTERM preemption save follow
the JAX engine (:func:`make_train_step`, :func:`do_train`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Callable, Optional

import torch

from signal_tpu_torch.data.augment import augment_batch, normalize_images
from signal_tpu_torch.data.prefetch import prefetch
from signal_tpu_torch.losses import center_loss, make_loss, total_train_loss
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
    centers: Optional[torch.Tensor] = None   # center-loss class centres


def make_train_step(model: Signal, cfg, num_classes: int, optimizer: torch.optim.Optimizer, *,
                    device_augment: bool = False, gen: Optional[torch.Generator] = None,
                    centers: Optional[torch.Tensor] = None) -> Callable:
    """→ ``train_step(imgs, pids, camids) -> (loss, acc)``, both 0-d tensors
    on the device. ``imgs``: a packed [B, 3, 3, H, W] batch (uint8, or float
    normalized on the host) or a modality dict. ``device_augment`` draws
    flip / pad + crop / erase from ``gen`` (a generator on the device).

    ``centers`` [num_classes, dim] (a ``center`` METRIC_LOSS_TYPE needs
    them): the class centres, a leaf tensor that requires grad. The loss
    gains CENTER_LOSS_WEIGHT · :func:`center_loss` of the first head's
    features, and each step moves the centres in place by plain SGD,
    ``centers −= CENTER_LR · grad / CENTER_LOSS_WEIGHT`` (`processor.py:
    264-269`); the optimizer never sees them.

    SOLVER.ACCUM_ITER = A > 1 splits the batch into A contiguous
    microbatches (contiguous keeps the P×K identity groups whole), runs
    forward and backward on each in turn (the BNNecks' running stats move
    with each), sums the fp32 gradients, and takes one optimizer step on
    the sum × 1/A. Loss and accuracy are the means over the microbatches;
    the centres' gradient is accumulated the same way. A must divide the
    batch (``ValueError``).

    ``train_step.stages`` holds the four stages one (micro)batch runs, in
    order (``prepare``, ``forward``, ``backward``, ``update``), so that a
    profiler can time each stage of this very step."""
    accum = max(1, int(cfg.SOLVER.ACCUM_ITER))
    use_center = "center" in cfg.MODEL.METRIC_LOSS_TYPE
    if use_center and centers is None:
        raise ValueError(f"MODEL.METRIC_LOSS_TYPE={cfg.MODEL.METRIC_LOSS_TYPE!r} needs the "
                         f"class centres (make_train_step(..., centers=...))")
    if device_augment and gen is None:
        raise ValueError("device_augment needs a torch.Generator on the batch's device")
    loss_fn = make_loss(cfg, num_classes)
    gram_w, pat_w = cfg.MODEL.Gram_Loss_weight, cfg.MODEL.PAT_Loss_weight
    moe_w = float(cfg.MODEL.MoE_Loss_weight)
    center_w, center_lr = cfg.SOLVER.CENTER_LOSS_WEIGHT, cfg.SOLVER.CENTER_LR
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    aug = dict(flip_prob=float(cfg.INPUT.PROB), re_prob=float(cfg.INPUT.RE_PROB),
               padding=int(cfg.INPUT.PADDING),
               fill=tuple((0.0 - m) / s for m, s in zip(mean, std)))
    params = [p for g in optimizer.param_groups for p in g["params"]]

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
            loss = total_train_loss(out, pids, loss_fn, gram_weight=gram_w, pat_weight=pat_w,
                                    moe_weight=moe_w)
            if use_center:
                loss = loss + center_w * center_loss(centers, out["feats"][0], pids)
            return out, loss

    def backward(loss, first: bool = True):
        """``first``: the batch's first microbatch, whose gradients replace
        the last step's; the others add to them."""
        if first:
            optimizer.zero_grad(set_to_none=True)
            if use_center:
                centers.grad = None
        with true_fp32():
            loss.backward()

    def accuracy(out, pids):
        return (out["scores"][0].argmax(dim=1) == pids).float().mean()

    @torch.no_grad()
    def apply_gradients():
        if accum > 1:
            torch._foreach_mul_([p.grad for p in params if p.grad is not None], 1.0 / accum)
        optimizer.step()
        if use_center:
            g = centers.grad if accum == 1 else centers.grad * (1.0 / accum)
            centers.sub_(center_lr * (g / center_w))

    def update(out, loss, pids):
        apply_gradients()
        return loss.detach(), accuracy(out, pids)

    def split(x):
        if isinstance(x, dict):
            return [dict(zip(x, parts)) for parts in zip(*(split(v) for v in x.values()))]
        if x.shape[0] % accum:
            raise ValueError(f"SOLVER.ACCUM_ITER={accum} must divide the batch size "
                             f"({x.shape[0]})")
        return x.chunk(accum, dim=0)

    def train_step(imgs, pids: torch.Tensor, camids: torch.Tensor):
        if accum == 1:
            out, loss = forward(prepare(imgs), pids, camids)
            backward(loss)
            return update(out, loss, pids)
        loss_sum = acc_sum = 0.0
        for i, (mb_imgs, mb_pids, mb_camids) in enumerate(
                zip(split(imgs), split(pids), split(camids))):
            out, loss = forward(prepare(mb_imgs), mb_pids, mb_camids)
            backward(loss, first=i == 0)
            loss_sum = loss_sum + loss.detach()
            acc_sum = acc_sum + accuracy(out, mb_pids)
            del out, loss
        apply_gradients()
        return loss_sum * (1.0 / accum), acc_sum * (1.0 / accum)

    train_step.stages = (prepare, forward, backward, update)
    return train_step


def init_centers(cfg, spec, num_classes: int, device: torch.device) -> Optional[torch.Tensor]:
    """The class centres of a ``center`` METRIC_LOSS_TYPE: N(0, 1) of
    [num_classes, 3·feat_dim if DIRECT else feat_dim] from a generator
    seeded by SOLVER.SEED (the reference's hardcoded 2048 never matches the
    heads, `make_loss.py:59`); None without center loss."""
    if "center" not in cfg.MODEL.METRIC_LOSS_TYPE:
        return None
    dim = 3 * spec.feat_dim if spec.direct else spec.feat_dim
    gen = torch.Generator().manual_seed(int(cfg.SOLVER.SEED))
    return torch.randn(num_classes, dim, generator=gen).to(device).requires_grad_(True)


def do_train(cfg, model: Signal, train_loader, val_loader, num_query: int, num_classes: int, *,
             device: torch.device, max_steps_per_epoch: Optional[int] = None,
             resume_from: Optional[str] = None, preempt_event=None,
             step_callback: Optional[Callable[[int, int], None]] = None) -> TrainState:
    """The training loop (`processor.py:41-350`): per epoch the schedule's
    lr, the steps with the reference's log lines, a full checkpoint every
    CHECKPOINT_PERIOD epochs, and an eval every EVAL_PERIOD epochs (with a
    ``best`` checkpoint by mAP). ``resume_from``: a checkpoint written by
    this loop; training continues at the epoch after the saved one.

    Preemption: SIGTERM (a handler installed for the loop when it runs on
    the main thread; the previous one comes back on return) sets
    ``preempt_event`` (a ``threading.Event``-like; tests set it directly).
    At the next step boundary the loop writes ``<MODEL.NAME>_preempt.pth``,
    a full checkpoint whose epoch is the last completed one (mid-epoch:
    epoch − 1, so ``--resume`` reruns the interrupted epoch from its top),
    and returns. Set during the epoch-end eval or checkpoint, it is acted
    on at the epoch boundary, and that save records the epoch itself.
    ``step_callback(epoch, n_iter)`` runs after each step, before the
    check (a caller's hook, e.g. to deliver a signal at a chosen step)."""
    optimizer = make_optimizer(model, cfg)
    n_total = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for g in optimizer.param_groups for p in g["params"])
    logger.info("number of parameters: %.6fM (trainable %.6fM)", n_total / 1e6, n_train / 1e6)
    device_augment = bool(getattr(train_loader, "device_augment", False))
    gen = torch.Generator(device=device).manual_seed(int(cfg.SOLVER.SEED))
    centers = init_centers(cfg, model.spec, num_classes, device)
    train_step = make_train_step(model, cfg, num_classes, optimizer,
                                 device_augment=device_augment, gen=gen, centers=centers)
    accum = max(1, int(cfg.SOLVER.ACCUM_ITER))
    k_inst = max(1, int(cfg.DATALOADER.NUM_INSTANCE))
    if accum > 1 and (cfg.SOLVER.IMS_PER_BATCH // accum) % k_inst:
        logger.warning(
            "ACCUM_ITER=%d gives microbatches of %d — not a multiple of NUM_INSTANCE=%d, "
            "so P×K identity groups split across microbatches and triplet mining weakens",
            accum, cfg.SOLVER.IMS_PER_BATCH // accum, k_inst)
    state = TrainState(model, optimizer, centers=centers)
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, cfg.ckpt_save_path)
    os.makedirs(ckpt_dir, exist_ok=True)
    if resume_from:
        state.epoch = load_checkpoint(resume_from, model, optimizer, gen, centers)
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

    def checkpoint(path: str, epoch: int) -> None:
        save_checkpoint(path, model, optimizer, epoch, gen, centers)

    def preempt_save(epoch: int) -> None:
        path = os.path.join(ckpt_dir, f"{cfg.MODEL.NAME}_preempt.pth")
        checkpoint(path, epoch)
        logger.info("Preemption checkpoint written to %s — resume with --resume %s", path, path)

    if preempt_event is None:
        preempt_event = threading.Event()

    def on_sigterm(signum, frame):
        preempt_event.set()
        logger.info("SIGTERM received — checkpointing at the next step boundary")

    previous = None
    installed = threading.current_thread() is threading.main_thread()
    if installed:
        previous = signal.signal(signal.SIGTERM, on_sigterm)
    try:
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
                if step_callback is not None:
                    step_callback(epoch, n_iter)
                if preempt_event.is_set():
                    preempt_save(epoch - 1)
                    return state
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
                checkpoint(os.path.join(ckpt_dir, f"{cfg.MODEL.NAME}_{epoch}.pth"), epoch)
            if epoch % cfg.SOLVER.EVAL_PERIOD == 0 and val_loader is not None:
                state.mAP, state.cmc = _neat_eval(cfg, model, val_loader, evaluator, epoch,
                                                  device)
                if state.mAP >= best["mAP"]:
                    best.update({"mAP": state.mAP, "Rank-1": state.cmc[0],
                                 "Rank-5": state.cmc[4], "Rank-10": state.cmc[9]})
                    save_checkpoint(os.path.join(ckpt_dir, f"{cfg.MODEL.NAME}best.pth"), model)
                logger.info("~" * 50)
                for k in ("mAP", "Rank-1", "Rank-5", "Rank-10"):
                    logger.info("Best %s: %.1f%%", k, 100 * best[k])
                logger.info("~" * 50)
            if preempt_event.is_set() and epoch < cfg.SOLVER.MAX_EPOCHS:
                # the signal came during the epoch-end eval or checkpoint:
                # this epoch is complete, so resume starts at the next
                preempt_save(epoch)
                return state
    finally:
        if installed:
            # None: the old handler was installed from C; fall back to the
            # default disposition rather than keep ours
            signal.signal(signal.SIGTERM, previous if previous is not None else signal.SIG_DFL)
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
