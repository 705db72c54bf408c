"""PK identity sampling — deterministic, host-side, multi-host aware.

Semantics of the reference ``datasets/sampler.py:37-63``
(``RandomIdentitySampler``): each batch holds P identities × K instances;
identities with fewer than K images are oversampled with replacement;
identities are removed from the pool once exhausted; the epoch ends when
fewer than P identities remain. Epoch length estimation matches
``sampler.py:29-35``.

Distribution: the reference's DDP variant synchronizes a random seed across
ranks with a pickled-object gloo all_gather (``sampler_ddp.py:64-109``) and
block-slices the global list per rank (``:159-168``). Here determinism comes
for free: every host derives the same epoch permutation from
``seed + epoch`` and slices its own contiguous block — no collective needed.

A copy kept in the port (ref mpreid_tpu/data/sampler.py::RandomIdentitySampler), so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Sequence

import numpy as np


class RandomIdentitySampler:
    """Deterministic PK sampler.

    Args:
      data_source: list of (img_path, pid, camid, trackid) records.
      batch_size: total images per batch (P*K).
      num_instances: K, images per identity per batch.
      seed: base RNG seed; epoch e uses seed + e.
    """

    def __init__(self, data_source: Sequence, batch_size: int, num_instances: int,
                 seed: int = 0):
        if batch_size % num_instances != 0:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by num_instances {num_instances}"
            )
        self.batch_size = batch_size
        self.num_instances = num_instances
        self.num_pids_per_batch = batch_size // num_instances
        self.seed = seed
        self.index_dic = defaultdict(list)
        for index, rec in enumerate(data_source):
            self.index_dic[rec[1]].append(index)
        self.pids = sorted(self.index_dic.keys())

        # epoch-length estimate (ref sampler.py:29-35)
        self.length = 0
        for pid in self.pids:
            num = len(self.index_dic[pid])
            num = max(num, self.num_instances)
            self.length += num - num % self.num_instances

    def epoch_indices(self, epoch: int = 0) -> np.ndarray:
        """Full epoch of sample indices (multiple of batch_size)."""
        rng = np.random.default_rng(self.seed + epoch)

        batch_idxs_dict = defaultdict(list)
        for pid in self.pids:
            idxs = list(self.index_dic[pid])
            if len(idxs) < self.num_instances:
                idxs = list(rng.choice(idxs, size=self.num_instances, replace=True))
            rng.shuffle(idxs)
            for start in range(0, len(idxs) - self.num_instances + 1, self.num_instances):
                batch_idxs_dict[pid].append(idxs[start : start + self.num_instances])

        avai_pids = list(self.pids)
        final: List[int] = []
        while len(avai_pids) >= self.num_pids_per_batch:
            selected = rng.choice(len(avai_pids), self.num_pids_per_batch, replace=False)
            # choose by position, remove after — stable under deletion
            chosen_pids = [avai_pids[i] for i in sorted(selected)]
            for pid in chosen_pids:
                final.extend(batch_idxs_dict[pid].pop(0))
                if not batch_idxs_dict[pid]:
                    avai_pids.remove(pid)
        return np.asarray(final, dtype=np.int64)

    def __len__(self) -> int:
        return self.length

    def __iter__(self):
        return iter(self.epoch_indices(0))


def shard_for_host(indices: np.ndarray, batch_size: int, num_hosts: int,
                   host_id: int) -> np.ndarray:
    """Slice a global PK index list into this host's sub-batches.

    Every global batch of ``batch_size`` is split into ``num_hosts``
    contiguous blocks (semantics of ref sampler_ddp.py:159-168) so each host
    feeds its shard of the global batch; with batch-sharded ``pjit`` inputs
    the device mesh sees the exact global PK batch.
    """
    if batch_size % num_hosts != 0:
        raise ValueError(f"batch_size {batch_size} not divisible by {num_hosts} hosts")
    mini = batch_size // num_hosts
    usable = len(indices) - len(indices) % batch_size
    blocks = indices[:usable].reshape(-1, num_hosts, mini)
    return blocks[:, host_id, :].reshape(-1)
