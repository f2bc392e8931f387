"""PK identity sampler (P ids × K instances per batch), seeded (the port's
own copy of `signal_tpu/data/sampler.py`).

Behavioral mirror of `data/datasets/sampler.py:8-71` (maxingan2412/Signal):
per epoch, each pid's indices are shuffled and chunked into K-sized groups
(short pids resampled with replacement up to K); batches draw
P = batch//K random pids and pop one chunk each until fewer than P pids
remain. The DDP variant (`sampler_ddp.py`) shared one seed via a gloo
all_gather and sliced per rank; here a host slices its shard
deterministically from the same global order — no collective needed
(every host draws from the same seed).
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Iterator, List, Sequence

import numpy as np


class RandomIdentitySampler:
    def __init__(self, data_source: Sequence, batch_size: int, num_instances: int, seed: int):
        self.batch_size = batch_size
        self.num_instances = num_instances
        self.num_pids_per_batch = batch_size // num_instances
        self.index_dic = defaultdict(list)
        for index, (_, pid, _, _) in enumerate(data_source):
            self.index_dic[pid].append(index)
        self.pids = list(self.index_dic.keys())
        self._rng = np.random.default_rng(seed)

        self.length = 0
        for pid in self.pids:
            num = max(len(self.index_dic[pid]), num_instances)
            self.length += num - num % num_instances

    def epoch_indices(self) -> List[int]:
        rng = self._rng
        batch_idxs_dict = defaultdict(list)
        for pid in self.pids:
            idxs = list(self.index_dic[pid])
            if len(idxs) < self.num_instances:
                idxs = rng.choice(idxs, size=self.num_instances, replace=True).tolist()
            rng.shuffle(idxs)
            for start in range(0, len(idxs) - self.num_instances + 1, self.num_instances):
                batch_idxs_dict[pid].append(idxs[start:start + self.num_instances])

        avai_pids = copy.deepcopy(self.pids)
        final: List[int] = []
        while len(avai_pids) >= self.num_pids_per_batch:
            selected = rng.choice(len(avai_pids), self.num_pids_per_batch, replace=False)
            for pid in [avai_pids[i] for i in sorted(selected)]:
                chunk = batch_idxs_dict[pid].pop(0)
                final.extend(chunk)
                if not batch_idxs_dict[pid]:
                    avai_pids.remove(pid)
        return final

    def __iter__(self) -> Iterator[int]:
        return iter(self.epoch_indices())

    def __len__(self) -> int:
        return self.length


def shard_indices(indices: List[int], num_shards: int, shard: int, batch_size: int) -> List[int]:
    """Deterministic per-host sharding of one epoch's global PK order:
    each global batch of ``batch_size`` is split into ``num_shards``
    contiguous micro-batches (the math of `sampler_ddp.py:165-175`)."""
    mini = batch_size // num_shards
    out: List[int] = []
    for start in range(0, len(indices) - batch_size + 1, batch_size):
        block = indices[start:start + batch_size]
        out.extend(block[shard * mini:(shard + 1) * mini])
    return out
