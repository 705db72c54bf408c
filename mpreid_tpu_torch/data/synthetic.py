"""Synthetic Market-1501 fixture for tests and smoke runs.

ref mpreid_tpu/data/synthetic.py::make_market1501. The same files, byte for
byte, from the same seeds, so both packages read one tree. Pillow is
imported only when a file is written.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np


def _write_img(path: str, seed: int, size=(32, 16), identity: int | None = None):
    from PIL import Image

    os.makedirs(osp.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    if identity is None:
        arr = rng.randint(0, 255, (size[0], size[1], 3), dtype=np.uint8)
    else:
        # learnable signal: a per-identity base pattern + per-image noise
        base_rng = np.random.RandomState(10_000 + identity)
        base = base_rng.randint(40, 215, (size[0], size[1], 3)).astype(np.int16)
        noise = rng.randint(-40, 41, base.shape)
        arr = np.clip(base + noise, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def make_market1501(root: str, n_ids: int = 6, imgs_per_id: int = 4, n_cams: int = 6,
                    identity_signal: bool = False, size=(32, 16)):
    """Market-1501 layout: {root}/Market-1501-v15.09.15/{split}/{pid}_c{cam}s1_{i}.jpg"""
    base = osp.join(root, "Market-1501-v15.09.15")
    seed = 0
    for split, ids in (
        ("bounding_box_train", range(1, n_ids + 1)),
        ("query", range(n_ids + 1, n_ids * 2 + 1)),
        ("bounding_box_test", range(n_ids + 1, n_ids * 2 + 1)),
    ):
        for pid in ids:
            for i in range(imgs_per_id):
                cam = (i % n_cams) + 1
                _write_img(
                    osp.join(base, split, f"{pid:04d}_c{cam}s1_{i:06d}_00.jpg"), seed,
                    size=size, identity=pid if identity_signal else None,
                )
                seed += 1
    return base
