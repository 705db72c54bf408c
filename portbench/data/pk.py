"""The PK order of an epoch: P identities × K images a batch.

A copy of the sampling that ``mpreid_tpu_torch/data/sampler.py::
RandomIdentitySampler.epoch_indices`` does (CLIP-ReID's
``RandomIdentitySampler``): each identity's images shuffled and cut into
groups of K (an identity with fewer than K drawn with replacement), then P
identities at a time chosen at random, each giving its next group, until
fewer than P have groups left."""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def epoch_indices(pids: np.ndarray, batch: int, k: int, seed: int, epoch: int) -> np.ndarray:
    rng = np.random.default_rng(seed + epoch)
    index = defaultdict(list)
    for i, pid in enumerate(pids.tolist()):
        index[pid].append(i)
    ids = sorted(index)
    groups = defaultdict(list)
    for pid in ids:
        idxs = list(index[pid])
        if len(idxs) < k:
            idxs = list(rng.choice(idxs, size=k, replace=True))
        rng.shuffle(idxs)
        for start in range(0, len(idxs) - k + 1, k):
            groups[pid].append(idxs[start:start + k])
    left = list(ids)
    out = []
    p = batch // k
    while len(left) >= p:
        chosen = [left[i] for i in sorted(rng.choice(len(left), p, replace=False))]
        for pid in chosen:
            out.extend(groups[pid].pop(0))
            if not groups[pid]:
                left.remove(pid)
    out = np.asarray(out, dtype=np.int64)
    return out[:len(out) - len(out) % batch].reshape(-1, batch)


class Rows:
    """The epochs' batch rows one after another, ``take(n)`` at a time (a
    take never crosses an epoch's end)."""

    def __init__(self, pids: np.ndarray, batch: int, k: int, seed: int):
        self.pids, self.batch, self.k, self.seed = pids, batch, k, seed
        self.epoch, self.rows, self.at = 0, epoch_indices(pids, batch, k, seed, 0), 0

    def take(self, n: int) -> np.ndarray:
        if self.at >= len(self.rows):
            self.epoch += 1
            self.rows, self.at = epoch_indices(self.pids, self.batch, self.k, self.seed,
                                               self.epoch), 0
        out = self.rows[self.at:self.at + n]
        self.at += len(out)
        return out
