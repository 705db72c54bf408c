"""The image sets and the stage-1 bank.

The train set stands for Market-1501's (12,936 images of 751 identities):
identity ``i`` holds ``n // ids`` images, one more for the first ``n % ids``
(the same layout for every seed), uint8 noise on the device. The
evaluation set holds ``n_query`` + ``n_gallery`` images of ``ids``
identities, each image its identity's base image plus normal noise, so that
an identity's images lie together; it is made on the device and kept in
host memory, where a loader keeps decoded images."""

from __future__ import annotations

import numpy as np
import torch


def identity_layout(n: int, ids: int) -> np.ndarray:
    """(n,) int32 identity of each image, in blocks."""
    counts = np.full(ids, n // ids)
    counts[: n % ids] += 1
    return np.repeat(np.arange(ids, dtype=np.int32), counts)


def train_set(n: int, ids: int, hw, seed: int, device):
    """(uint8 images (n, H, W, 3), int32 pids, camids, trackids) on ``device``."""
    h, w = hw
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, generator=gen, device=device)
    pids = torch.from_numpy(identity_layout(n, ids)).to(device)
    camids = (torch.arange(n, device=device) % 6).to(torch.int32)
    trackids = torch.zeros(n, dtype=torch.int32, device=device)
    return images, pids, camids, trackids


def bank(n: int, ids: int, dim: int, dtype, seed: int, device, scale: float = 0.05):
    """(features (n, dim) in ``dtype``, int64 labels) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = (torch.randn((n, dim), generator=gen, device=device) * scale).to(dtype)
    return feats, torch.from_numpy(identity_layout(n, ids)).to(device).long()


def eval_set(n_query: int, n_gallery: int, ids: int, hw, seed: int, device,
             noise: float = 48.0):
    """(uint8 images (n, H, W, 3) numpy, int32 pids, int32 camids): queries
    first, identities dealt round the query and the gallery alike, query
    cameras 0–2 and gallery cameras 3–5."""
    h, w = hw
    n = n_query + n_gallery
    pids = np.concatenate([np.arange(n_query) % ids, np.arange(n_gallery) % ids]).astype(np.int32)
    camids = np.concatenate([np.arange(n_query) % 3, 3 + np.arange(n_gallery) % 3]).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randint(0, 256, (ids, h, w, 3), dtype=torch.uint8, generator=gen, device=device)
    out = np.empty((n, h, w, 3), np.uint8)
    block = 1024
    p = torch.from_numpy(pids).to(device).long()
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        z = torch.randn((hi - lo, h, w, 3), generator=gen, device=device)
        img = (base[p[lo:hi]].float() + noise * z).round().clamp(0, 255).to(torch.uint8)
        out[lo:hi] = img.cpu().numpy()
    return out, pids, camids


class EvalLoader:
    """An in-memory loader of decoded images in batches (the port's val
    loader interface: ``iter_sequential()`` of dicts with uint8 ``images``,
    ``pids``, ``camids``, ``trackids``, ``count``), the last batch padded to
    full width with its first image."""

    def __init__(self, images: np.ndarray, pids: np.ndarray, camids: np.ndarray, batch: int):
        self.batches = []
        n = len(images)
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            count = hi - lo
            sel = np.concatenate([np.arange(lo, hi), np.full(batch - count, lo)])
            self.batches.append({"images": images[sel] if count < batch else images[lo:hi],
                                 "pids": pids[sel], "camids": camids[sel],
                                 "trackids": np.zeros(batch, np.int32),
                                 "paths": [""] * batch, "count": count})

    def iter_sequential(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)
