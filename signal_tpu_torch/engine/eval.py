"""Inference engine: feature extraction + retrieval evaluation (port of
`signal_tpu/engine/eval.py`).

Under MODEL.DIST_TRAIN each rank runs the forward on its rows of each
global batch (``data.loader._ShardedValLoader``); the features are
gathered in rank order and every rank feeds the evaluator the global
rows, so all of them report the same mAP/CMC. Under PARALLEL.PIPE_AXIS the
ranks of a pipe group take the same rows and each runs its stage of the
tower (``parallel/pipeline.py``); the gather runs over the data group of
one pipe index."""

from __future__ import annotations

import logging

import torch

from signal_tpu_torch.data.augment import normalize_images
from signal_tpu_torch.data.prefetch import prefetch
from signal_tpu_torch.metrics import R1mAPEvaluator
from signal_tpu_torch.models.signal_model import Signal, forward_eval
from signal_tpu_torch.parallel.mesh import all_gather_rows
from signal_tpu_torch.utils.profiler import span

logger = logging.getLogger("signal_tpu_torch.eval")


def make_eval_step(normalize):
    """→ ``eval_step(model, imgs, camids)``: device-side Normalize of a
    uint8 batch (``normalize`` = (PIXEL_MEAN, PIXEL_STD); a float batch,
    normalized on the host, passes through), then :func:`forward_eval`
    under ``torch.inference_mode``, in an ``eval.step`` span."""
    mean, std = normalize

    def eval_step(model: Signal, imgs, camids) -> torch.Tensor:
        with span("eval.step"), torch.inference_mode():
            return forward_eval(model, normalize_images(imgs, mean, std), camids)

    return eval_step


def extract_features(model: Signal, loader, evaluator: R1mAPEvaluator, *,
                     device, normalize):
    """Stream batches through ``forward_eval`` on ``device``, feeding the
    evaluator. Each batch goes to the device as one packed
    [B, 3, 3, H, W] buffer; the next batch's decode and copy overlap this
    batch's forward. A batch of the sharded val loader (its global
    metadata in ``batch['global']``) is this rank's rows: the features are
    gathered over the data group of ``model.mesh`` and the evaluator gets
    the global batch's valid rows."""
    eval_step = make_eval_step(normalize)

    def put(batch):
        imgs = torch.from_numpy(batch["packed"]).to(device, non_blocking=True)
        camids = torch.from_numpy(batch["camids"]).to(device, non_blocking=True)
        return imgs, camids, batch

    for imgs, camids, batch in prefetch(loader, put):
        feats = eval_step(model, imgs, camids)
        meta = batch.get("global")
        if meta is not None:
            feats = all_gather_rows(feats, getattr(model, "mesh", None))
        else:
            meta = batch
        valid = meta.get("valid", feats.shape[0])
        evaluator.update(
            feats[:valid],
            meta["pids"][:valid],
            meta["camids"][:valid],
            sceneid=meta["trackids"][:valid] if evaluator.scene_aware else None,
            img_path=meta.get("names", [])[:valid] or None,
        )


def do_inference(cfg, model: Signal, val_loader, num_query: int, *, device):
    """Full test pass → (cmc, mAP). Under a mesh only rank 0 writes
    TEST.RANK_DUMP."""
    mesh = getattr(model, "mesh", None)
    writer = mesh is None or mesh.writer
    evaluator = R1mAPEvaluator(
        num_query,
        feat_norm=cfg.TEST.FEAT_NORM == "yes",
        reranking=cfg.TEST.RE_RANKING == "yes",
        scene_aware=cfg.DATASETS.NAMES == "MSVR310",
        rank_dump_path=(cfg.TEST.RANK_DUMP or None) if writer else None,
    )
    extract_features(model, val_loader, evaluator, device=device,
                     normalize=(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD))
    cmc, mAP, *_ = evaluator.compute()
    logger.info("Validation Results ")
    logger.info("mAP: %.1f%%", 100 * mAP)
    for r in (1, 5, 10):
        logger.info("CMC curve, Rank-%-3d:%.1f%%", r, 100 * cmc[r - 1])
    return cmc, mAP
