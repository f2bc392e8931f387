"""Inference engine: feature extraction + retrieval evaluation (port of
`signal_tpu/engine/eval.py`)."""

from __future__ import annotations

import logging

import torch

from signal_tpu_torch.data.augment import normalize_images
from signal_tpu_torch.data.prefetch import prefetch
from signal_tpu_torch.metrics import R1mAPEvaluator
from signal_tpu_torch.models.signal_model import Signal, forward_eval

logger = logging.getLogger("signal_tpu_torch.eval")


def make_eval_step(normalize):
    """→ ``eval_step(model, imgs, camids)``: device-side Normalize of a
    uint8 batch (``normalize`` = (PIXEL_MEAN, PIXEL_STD); a float batch,
    normalized on the host, passes through), then :func:`forward_eval`
    under ``torch.inference_mode``."""
    mean, std = normalize

    def eval_step(model: Signal, imgs, camids) -> torch.Tensor:
        with torch.inference_mode():
            return forward_eval(model, normalize_images(imgs, mean, std), camids)

    return eval_step


def extract_features(model: Signal, loader, evaluator: R1mAPEvaluator, *,
                     device, normalize):
    """Stream batches through ``forward_eval`` on ``device``, feeding the
    evaluator. Each batch goes to the device as one packed
    [B, 3, 3, H, W] buffer; the next batch's decode and copy overlap this
    batch's forward."""
    eval_step = make_eval_step(normalize)

    def put(batch):
        if "global" in batch:
            raise NotImplementedError(
                "multi-process eval (sharded val loader) is not ported yet "
                "(ROADMAP Queue 1 item 6, scale-out)")
        imgs = torch.from_numpy(batch["packed"]).to(device, non_blocking=True)
        camids = torch.from_numpy(batch["camids"]).to(device, non_blocking=True)
        return imgs, camids, batch

    for imgs, camids, batch in prefetch(loader, put):
        feats = eval_step(model, imgs, camids)
        valid = batch.get("valid", feats.shape[0])
        evaluator.update(
            feats[:valid],
            batch["pids"][:valid],
            batch["camids"][:valid],
            sceneid=batch["trackids"][:valid] if evaluator.scene_aware else None,
            img_path=batch.get("names", [])[:valid] or None,
        )


def do_inference(cfg, model: Signal, val_loader, num_query: int, *, device):
    """Full test pass → (cmc, mAP)."""
    evaluator = R1mAPEvaluator(
        num_query,
        feat_norm=cfg.TEST.FEAT_NORM == "yes",
        reranking=cfg.TEST.RE_RANKING == "yes",
        scene_aware=cfg.DATASETS.NAMES == "MSVR310",
        rank_dump_path=cfg.TEST.RANK_DUMP or None,
    )
    extract_features(model, val_loader, evaluator, device=device,
                     normalize=(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD))
    cmc, mAP, *_ = evaluator.compute()
    logger.info("Validation Results ")
    logger.info("mAP: %.1f%%", 100 * mAP)
    for r in (1, 5, 10):
        logger.info("CMC curve, Rank-%-3d:%.1f%%", r, 100 * cmc[r - 1])
    return cmc, mAP
