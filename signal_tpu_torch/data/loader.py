"""Batched 3-modality data loading (the port's own copy of
`signal_tpu/data/loader.py`, host-only numpy/PIL).

Mirrors `data/datasets/make_dataloader.py` + `bases.py` (maxingan2412/
Signal): per-sample decode of (RGB, NI, TI) — either three files or one
packed 768-wide jpg cropped into three panes (`bases.py:18-22`) — with the
transform applied INDEPENDENTLY per modality (each torchvision call drew
fresh randomness, `bases.py:103`), collated into {'RGB','NI','TI'} arrays
plus one packed [B, 3modal, 3ch, H, W] buffer.

* decode runs in a thread pool with double-buffered prefetch (PIL releases
  the GIL in its codecs);
* every batch takes the PIL path: the JAX package's whole-batch native
  C++ decoder (`signal_tpu/data/native_decoder.py`) is not ported yet
  (ROADMAP Queue 1 item 9);
* the train loader drops the final partial batch; the eval loader pads
  the tail batch and reports the true count so the evaluator can slice
  it off.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image

from signal_tpu_torch.data.datasets import ReIDDataset, build_dataset
from signal_tpu_torch.data.sampler import RandomIdentitySampler, shard_indices
from signal_tpu_torch.data.transforms import TrainTransform, ValTransform

PACKED_CROPS = ((0, 0, 256, 128), (256, 0, 512, 128), (512, 0, 768, 128))


def _synthetic_image(token: str, size_hw: Tuple[int, int]) -> Image.Image:
    """Deterministic pseudo-image for 'synth:pid:i:m' records: a
    pid+modality-specific base pattern mixed with per-instance noise, so
    retrieval on held-out instances is actually learnable (pure
    per-instance noise would make query/gallery unmatchable)."""
    _, pid, i, m = token.split(":")
    h, w = size_hw
    rng_id = np.random.default_rng(abs(hash((int(pid), int(m)))) % (2 ** 31))
    base = rng_id.integers(0, 255, (h, w, 3)).astype(np.float32)
    rng_inst = np.random.default_rng(
        abs(hash((int(pid), int(i), int(m)))) % (2 ** 31))
    noise = rng_inst.integers(0, 255, (h, w, 3)).astype(np.float32)
    img = np.clip(0.7 * base + 0.3 * noise, 0, 255).astype(np.uint8)
    return Image.fromarray(img)


def read_modalities(paths, size_hint=(128, 64)) -> List[Image.Image]:
    """→ [RGB, NI, TI] PIL images."""
    if isinstance(paths, str):
        if paths.startswith("synth:"):
            return [_synthetic_image(paths, size_hint)]
        img = Image.open(paths).convert("RGB")
        return [img.crop(c) for c in PACKED_CROPS]
    imgs = []
    for p in paths:
        if p.startswith("synth:"):
            imgs.append(_synthetic_image(p, size_hint))
        else:
            imgs.append(Image.open(p).convert("RGB"))
    return imgs


class _BatchLoader:
    def __init__(self, dataset_records, transform, batch_size: int,
                 index_source, *, drop_last: bool, seed: int,
                 num_threads: int = 4, include_paths: bool = False,
                 num_samples_hint: Optional[int] = None, key_offset: int = 0,
                 emit_u8: bool = False):
        self.records = dataset_records
        self.transform = transform
        self.batch_size = batch_size
        self.index_source = index_source  # callable → per-epoch index list
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.include_paths = include_paths
        self.num_samples_hint = num_samples_hint
        # multi-host: augmentation randomness is a pure function of
        # (seed, epoch, batch, GLOBAL row) — a host's shard draws exactly
        # what the unsharded run would draw for those rows, so sharded and
        # single-host training are bit-identical (no reference equivalent:
        # torchvision draws fresh per-worker randomness)
        self.key_offset = key_offset
        # ship raw uint8 pixels; normalization runs on the device (the
        # engine's eval step), quartering host→device bytes
        self.emit_u8 = emit_u8
        self._epoch = 0

    def __len__(self) -> int:
        # never call index_source() here — it would consume sampler RNG state
        n = (self.num_samples_hint if self.num_samples_hint is not None
             else len(self.records))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_one(self, index: int, rng_key: int):
        paths, pid, camid, trackid = self.records[index]
        imgs = read_modalities(paths)
        rng = np.random.default_rng(rng_key)
        if self.emit_u8 and hasattr(self.transform, "raw_u8"):
            # deterministic transforms (val / device-augment train)
            # defer Normalize to the device: 4× fewer bytes on the wire
            arrs = [self.transform.raw_u8(img) for img in imgs]
        else:
            arrs = [self.transform(img, rng) for img in imgs]
        name = (paths if isinstance(paths, str) else paths[0]).split("/")[-1]
        return arrs, pid, camid, trackid, name

    def __iter__(self) -> Iterator[Dict]:
        indices = list(self.index_source())
        self._epoch += 1
        bs = self.batch_size
        n_full = len(indices) // bs
        tail = len(indices) - n_full * bs
        batches = [indices[i * bs:(i + 1) * bs] for i in range(n_full)]
        pad_count = 0
        if tail and not self.drop_last:
            last = indices[n_full * bs:]
            pad_count = bs - tail
            last = last + last[:1] * pad_count  # pad by repeating first tail item
            batches.append(last)

        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            pending = None
            for bi, batch_idx in enumerate(batches):
                is_last = bi == len(batches) - 1
                pad = pad_count if is_last else 0
                keys = [int(np.random.SeedSequence(
                            (self.seed, self._epoch, bi,
                             self.key_offset + j)).generate_state(1)[0])
                        for j in range(len(batch_idx))]
                futs = [pool.submit(self._load_one, idx, k)
                        for idx, k in zip(batch_idx, keys)]
                if pending is not None:
                    yield self._collate(*pending)
                pending = (futs, pad)
            if pending is not None:
                yield self._collate(*pending)

    def _collate(self, futs, pad_count: int) -> Dict:
        items = [f.result() for f in futs]
        arrs = np.stack([np.stack(it[0]) for it in items])  # [B, 3modal, 3, H, W]
        batch = {
            "imgs": {"RGB": arrs[:, 0], "NI": arrs[:, 1], "TI": arrs[:, 2]},
            "packed": arrs,
            "pids": np.asarray([it[1] for it in items], np.int64),
            "camids": np.asarray([it[2] for it in items], np.int64),
            "trackids": np.asarray([it[3] for it in items], np.int64),
            "valid": len(items) - pad_count,
        }
        if self.include_paths:
            batch["names"] = [it[4] for it in items]
        return batch


class _ShardedValLoader:
    """Multi-host val loader: every host decodes ONLY its row-slice of each
    GLOBAL batch (rows [shard·mini, (shard+1)·mini) of batch j). Global
    metadata (pids/camids/…, true valid count) rides along in
    ``batch['global']`` because the evaluator sees all-gathered GLOBAL
    features, not the local shard. The port's eval engine does not gather
    across processes yet (ROADMAP Queue 1 item 12) and refuses such
    batches."""

    def __init__(self, records, transform, global_bs: int, num_shards: int,
                 shard: int, seed: int, num_threads: int,
                 emit_u8: bool = False):
        assert global_bs % num_shards == 0, (
            f"TEST.IMS_PER_BATCH={global_bs} not divisible by {num_shards} hosts")
        n = len(records)
        pad = (-n) % global_bs
        self._padded = list(range(n)) + [n - 1] * pad  # repeat last record
        self.records = records
        self.num_valid = n
        self.global_bs = global_bs
        mini = global_bs // num_shards
        local_idx = shard_indices(self._padded, num_shards, shard, global_bs)
        self._inner = _BatchLoader(
            records, transform, mini, lambda: list(local_idx),
            drop_last=True, seed=seed, num_threads=num_threads,
            include_paths=True, emit_u8=emit_u8,
            num_samples_hint=len(local_idx))

    def __len__(self) -> int:
        return len(self._padded) // self.global_bs

    def __iter__(self) -> Iterator[Dict]:
        for j, batch in enumerate(self._inner):
            rows = self._padded[j * self.global_bs:(j + 1) * self.global_bs]
            recs = [self.records[i] for i in rows]
            remaining = self.num_valid - j * self.global_bs
            batch["global"] = {
                "pids": np.asarray([r[1] for r in recs], np.int64),
                "camids": np.asarray([r[2] for r in recs], np.int64),
                "trackids": np.asarray([r[3] for r in recs], np.int64),
                "names": [(r[0] if isinstance(r[0], str) else r[0][0])
                          .split("/")[-1] for r in recs],
                "valid": min(self.global_bs, remaining),
            }
            yield batch


def make_dataloader(cfg, dataset: Optional[ReIDDataset] = None,
                    num_shards: int = 1, shard_index: int = 0):
    """→ (train_loader, train_loader_normal, val_loader, num_query,
         num_classes, cam_num, view_num) — the reference's 7-tuple
    (`make_dataloader.py:185-257`).

    ``num_shards``/``shard_index``: per-host slicing of the global PK order
    for multi-host training (replaces the reference's gloo-synced DDP
    sampler, `sampler_ddp.py:13-202` — every host derives the same global
    order from the shared seed, no collective needed)."""
    if dataset is None:
        dataset = build_dataset(cfg.DATASETS.NAMES, cfg.DATASETS.ROOT_DIR)

    # device-side augmentation: decode+bicubic-resize on the host, flip/
    # pad+crop/erase in the train step (not ported yet: ROADMAP Queue 1
    # item 9); the full host-side TrainTransform when disabled.
    device_augment = bool(getattr(cfg.DATALOADER, "DEVICE_AUGMENT", False))
    # ship uint8 over the wire, Normalize on the device (the eval step
    # handles both dtypes)
    emit_u8 = bool(getattr(cfg.DATALOADER, "DEVICE_NORMALIZE", True))
    if device_augment:
        from signal_tpu_torch.data.transforms import RawTrainDecode

        train_tf = RawTrainDecode(cfg.INPUT.SIZE_TRAIN, cfg.INPUT.PIXEL_MEAN,
                                  cfg.INPUT.PIXEL_STD)
    else:
        train_tf = TrainTransform(cfg.INPUT.SIZE_TRAIN, cfg.INPUT.PROB,
                                  cfg.INPUT.RE_PROB, cfg.INPUT.PADDING,
                                  cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
    val_tf = ValTransform(cfg.INPUT.SIZE_TEST, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)

    sampler = RandomIdentitySampler(dataset.train, cfg.SOLVER.IMS_PER_BATCH,
                                    cfg.DATALOADER.NUM_INSTANCE, cfg.SOLVER.SEED)
    nthreads = max(1, cfg.DATALOADER.NUM_WORKERS)

    if num_shards > 1:
        from signal_tpu_torch.data.sampler import shard_indices

        global_bs = cfg.SOLVER.IMS_PER_BATCH
        index_source = lambda: shard_indices(  # noqa: E731
            sampler.epoch_indices(), num_shards, shard_index, global_bs)
        local_bs = global_bs // num_shards
        hint = sampler.length // num_shards
    else:
        index_source = sampler.epoch_indices
        local_bs = cfg.SOLVER.IMS_PER_BATCH
        hint = sampler.length

    train_loader = _BatchLoader(
        dataset.train, train_tf, local_bs,
        index_source, drop_last=True, seed=cfg.SOLVER.SEED,
        num_threads=nthreads, num_samples_hint=hint,
        key_offset=shard_index * local_bs, emit_u8=emit_u8)
    # the engine reads this to fuse flip/crop/erase into the train step
    train_loader.device_augment = device_augment

    train_loader_normal = _BatchLoader(
        dataset.train, val_tf, cfg.TEST.IMS_PER_BATCH,
        lambda: list(range(len(dataset.train))), drop_last=False,
        seed=cfg.SOLVER.SEED, num_threads=nthreads, include_paths=True,
        emit_u8=emit_u8)

    val_records = dataset.query + dataset.gallery
    if num_shards > 1:
        val_loader = _ShardedValLoader(
            val_records, val_tf, cfg.TEST.IMS_PER_BATCH, num_shards,
            shard_index, cfg.SOLVER.SEED, nthreads, emit_u8=emit_u8)
    else:
        val_loader = _BatchLoader(
            val_records, val_tf, cfg.TEST.IMS_PER_BATCH,
            lambda: list(range(len(val_records))), drop_last=False,
            seed=cfg.SOLVER.SEED, num_threads=nthreads, include_paths=True,
            emit_u8=emit_u8)

    num_classes = dataset.num_train_pids
    cam_num = dataset.num_train_cams
    view_num = dataset.num_train_vids
    return (train_loader, train_loader_normal, val_loader,
            len(dataset.query), num_classes, cam_num, view_num)
