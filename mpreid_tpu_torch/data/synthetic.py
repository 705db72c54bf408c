"""Synthetic Market-1501 and MMMP fixtures, and seeded CLIP files, for tests
and smoke runs.

ref mpreid_tpu/data/synthetic.py::make_market1501, ::make_mmmp. The same
files, byte for byte, from the same seeds, so both packages read one tree.
Pillow is imported only when a file is written.

``make_clip_file`` writes what an OpenAI CLIP ``.pt`` holds (the OpenAI key
layout, square position grids, ``logit_scale`` and the archive's meta
entries) with seeded random weights, as a plain state_dict or as a
TorchScript archive: the real files are not in the repository and nothing
is downloaded.
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


def make_mmmp(root: str, exp_settings=("exp_cctv_ir_cctv_rgb", "exp_rgb"),
              n_train_ids: int = 4, n_test_ids: int = 3, imgs_per_cam: int = 2):
    """MMMP layout: {root}/{cam}/{pid}/{cam:02d}_{pid:04d}_{i:04d}.jpg over
    cameras 01-14, and {root}/{exp_setting}/{train,val,test}_id.txt."""
    cams = [f"{i:02d}" for i in range(1, 15)]
    train_ids = list(range(1, n_train_ids + 1))
    val_ids = [n_train_ids + 1]
    test_ids = list(range(n_train_ids + 2, n_train_ids + 2 + n_test_ids))

    seed = 100
    for cam in cams:
        for pid in train_ids + val_ids + test_ids:
            for i in range(imgs_per_cam):
                name = f"{cam}_{pid:04d}_{i:04d}.jpg"
                _write_img(osp.join(root, cam, f"{pid:04d}", name), seed)
                seed += 1

    for exp_setting in exp_settings:
        exp_dir = osp.join(root, exp_setting)
        os.makedirs(exp_dir, exist_ok=True)
        for fname, ids in (
            ("train_id.txt", train_ids),
            ("val_id.txt", val_ids),
            ("test_id.txt", test_ids),
        ):
            with open(osp.join(exp_dir, fname), "w") as f:
                f.write(",".join(str(i) for i in ids) + "\n")
    return root


def _scripted_state(sd):
    """A TorchScript module whose ``state_dict()`` is ``sd`` (dotted keys
    become nested submodules holding buffers)."""
    import torch

    root = torch.nn.Module()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        node = root
        for part in path:
            if not hasattr(node, part):
                node.add_module(part, torch.nn.Module())
            node = getattr(node, part)
        node.register_buffer(leaf, value)
    return torch.jit.script(root)


def make_clip_file(path: str, clip_config, grid: int, seed: int = 0, jit: bool = False,
                   half: bool = False) -> str:
    """Write a seeded OpenAI-layout CLIP file for ``clip_config``'s towers
    with a ``grid`` × ``grid`` position grid (ViT-B/16 at 224: 14; RN50's
    attention pool: 7) → ``path``. Weights follow the port's init from
    ``seed``; RN50 BatchNorms get random running statistics (variance in
    [0.5, 1.5]) and modest scales (in [0.5, 1]), so eval mode depends on
    them and activations stay finite through the full-width tower. ``half``
    stores the floating tensors in fp16, as OpenAI's archives do."""
    import dataclasses

    import torch

    from mpreid_tpu_torch.models.clip_model import make_text_tower, make_visual_tower

    cfg = dataclasses.replace(clip_config, h_resolution=grid, w_resolution=grid)
    gen = torch.Generator().manual_seed(seed)
    visual, text = make_visual_tower(cfg), make_text_tower(cfg)
    visual.init_(gen)
    text.init_(gen)
    sd = {f"visual.{k}": v for k, v in visual.state_dict().items()}
    sd.update(text.state_dict())  # the text keys sit at the root
    sd = {k: v.detach().clone() for k, v in sd.items()}
    sd.update(logit_scale=torch.tensor(float(np.log(1 / 0.07))),
              input_resolution=torch.tensor(grid * (clip_config.vision_patch_size or 32)),
              context_length=torch.tensor(cfg.context_length),
              vocab_size=torch.tensor(cfg.vocab_size))
    draws = {"weight": (torch.Tensor.uniform_, 0.5, 1.0), "bias": (torch.Tensor.normal_, 0.0, 0.1),
             "running_mean": (torch.Tensor.normal_, 0.0, 0.1),
             "running_var": (torch.Tensor.uniform_, 0.5, 1.5)}
    with torch.no_grad():
        for bn in sorted(k[:-len(".running_var")] for k in sd if k.endswith(".running_var")):
            for name, (draw, a, b) in draws.items():
                draw(sd[f"{bn}.{name}"], a, b, generator=gen)
    if half:
        sd = {k: v.half() if v.is_floating_point() else v for k, v in sd.items()}
    if jit:
        torch.jit.save(_scripted_state(sd), path)
    else:
        torch.save(sd, path)
    return path
