"""Host-side image loading feeding the device pipeline.

ref mpreid_tpu/data/loader.py::ImageBatcher, ::make_dataloader. Each batch
is decoded and bicubically resized into uint8 numpy arrays on the host, and
all augmentation and normalisation run on the device. Two decoders give the
same bytes: a thread pool over Pillow (``decode_resize``), and the native
OpenMP batch decoder (``native/imageio.py``), one C call a batch, which
``DATALOADER.NATIVE_DECODE`` chooses: ``'auto'`` takes it when it builds
and passes its byte-for-byte self-check against Pillow, True asks for it
(a warning, then Pillow, where it cannot), False keeps Pillow. A row the
native decoder fails on is decoded by Pillow alone. Pillow is imported only
inside the decoders, so the package imports without it. The factory keeps
the reference's loader contract:

    make_dataloader(cfg) → (train_loader_stage2, train_loader_stage1,
                            val_loader, num_query, num_classes,
                            camera_num, view_num)

Batch layout: dicts of numpy arrays — ``images`` uint8 (B,H,W,3), ``pids``,
``camids``, ``trackids`` int32, ``paths`` list, plus ``count`` (valid rows;
the final batch is zero-padded to the full batch size).
"""

from __future__ import annotations

import copy
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from mpreid_tpu_torch.utils.tracing import span

from .base import ReIDDataset, Record
from .datasets import build_dataset
from .sampler import RandomIdentitySampler, shard_for_host

logger = logging.getLogger("mpreid_tpu_torch.data")


def decode_resize(path: str, size_hw) -> np.ndarray:
    """PIL decode + bicubic resize to (h, w) → uint8 (h, w, 3).

    Bicubic matches the reference's ``T.Resize(..., interpolation=3)``.
    A corrupt or missing file logs once and yields a black image.
    """
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    h, w = size_hw
    try:
        img = Image.open(path).convert("RGB")
        img = img.resize((w, h), Image.BICUBIC)
        return np.asarray(img, dtype=np.uint8)
    except (OSError, ValueError) as e:
        logger.warning("Failed to read %s (%s); substituting zeros", path, e)
        return np.zeros((h, w, 3), np.uint8)


def use_native_decode(native) -> bool:
    """Whether a batcher takes the native decoder (``DATALOADER.NATIVE_DECODE``):
    ``'auto'`` when it builds and self-checks on this host; True the same,
    with a warning where it cannot; False never."""
    if native != "auto" and not native:
        return False
    from mpreid_tpu_torch.native.imageio import native_imageio_available, why_unavailable

    if native_imageio_available():
        return True
    if native != "auto":
        logger.warning("DATALOADER.NATIVE_DECODE requested but the native imageio library is "
                       "unavailable (%s); using the PIL path", why_unavailable())
    return False


class ImageBatcher:
    """Threaded (or native batch) decode of record batches into fixed-size
    numpy batches."""

    def __init__(self, records: Sequence[Record], size_hw, batch_size: int,
                 num_workers: int = 8, cache=False, native="auto"):
        self.records = list(records)
        self.size_hw = tuple(size_hw)
        self.batch_size = batch_size
        self.native = use_native_decode(native)
        self._num_workers = max(1, num_workers)
        self._pool: Optional[ThreadPoolExecutor] = None  # made on first use: native never does
        # a dedicated prefetch thread assembles batches; decode tasks go to
        # the worker pool (one shared pool would deadlock)
        self.prefetcher = ThreadPoolExecutor(max_workers=1)
        # optional decoded-uint8 cache, keyed by (path, size); pass a dict to
        # share it between batchers (and decoders) over the same records
        if isinstance(cache, dict):
            self._cache: Optional[dict] = cache
        else:
            self._cache = {} if cache else None

    def _decode(self, rec: Record) -> np.ndarray:
        key = (rec[0], self.size_hw)
        if self._cache is not None and key in self._cache:
            return self._cache[key]
        img = decode_resize(rec[0], self.size_hw)
        if self._cache is not None:
            self._cache[key] = img
        return img

    def _decode_batch_native(self, recs: Sequence[Record]) -> list:
        """One native call for the records the cache lacks; a row it fails
        on is decoded by Pillow."""
        from mpreid_tpu_torch.native.imageio import decode_resize_batch_native

        images: list = [None] * len(recs)
        miss = []
        for i, r in enumerate(recs):
            hit = None if self._cache is None else self._cache.get((r[0], self.size_hw))
            if hit is None:
                miss.append(i)
            else:
                images[i] = hit
        if miss:
            batch, status = decode_resize_batch_native([recs[i][0] for i in miss], self.size_hw)
            for j, i in enumerate(miss):
                if status[j] == 0:
                    # a cached row is copied out: a view would pin the whole
                    # batch buffer and share writable memory with the batch
                    img = np.array(batch[j]) if self._cache is not None else batch[j]
                else:
                    img = decode_resize(recs[i][0], self.size_hw)
                images[i] = img
                if self._cache is not None:
                    self._cache[(recs[i][0], self.size_hw)] = img
        return images

    def __len__(self):
        return (len(self.records) + self.batch_size - 1) // self.batch_size

    @property
    def pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self._num_workers)
        return self._pool

    def decode_records(self, recs: Sequence[Record]) -> list:
        """Decode any records through the active path (native batch call or
        Pillow thread pool): the one entry point for callers outside."""
        if self.native:
            return self._decode_batch_native(recs)
        return list(self.pool.map(self._decode, recs))

    def _load_batch(self, indices: Sequence[int]) -> Dict:
        """One batch decoded and stacked: the span ``loader.batch``, on the
        prefetch thread."""
        with span("loader.batch"):
            recs = [self.records[i] for i in indices]
            images = self.decode_records(recs)
            count = len(recs)
            pad = self.batch_size - count
            if pad:
                images.extend([np.zeros((*self.size_hw, 3), np.uint8)] * pad)
                recs = recs + [recs[-1]] * pad
            return {
                "images": np.stack(images),
                "pids": np.asarray([r[1] for r in recs], np.int32),
                "camids": np.asarray([r[2] for r in recs], np.int32),
                "trackids": np.asarray([r[3] for r in recs], np.int32),
                "paths": [r[0] for r in recs],
                "count": count,
            }

    def iter_indices(self, order: Sequence[int], drop_last: bool = False) -> Iterator[Dict]:
        n = len(order)
        stop = n - n % self.batch_size if drop_last else n
        starts = list(range(0, stop, self.batch_size))
        if not starts:
            return
        # one-batch-ahead prefetch on the dedicated thread
        future = self.prefetcher.submit(
            self._load_batch, order[starts[0]: starts[0] + self.batch_size]
        )
        for i in range(len(starts)):
            current = future
            if i + 1 < len(starts):
                s2 = starts[i + 1]
                future = self.prefetcher.submit(
                    self._load_batch, order[s2: s2 + self.batch_size]
                )
            yield current.result()

    def iter_sequential(self, drop_last: bool = False) -> Iterator[Dict]:
        return self.iter_indices(np.arange(len(self.records)), drop_last)

    def iter_shuffled(self, seed: int, epoch: int, drop_last: bool = True) -> Iterator[Dict]:
        rng = np.random.default_rng(seed + epoch)
        return self.iter_indices(rng.permutation(len(self.records)), drop_last)


class TrainLoader:
    """PK-sampled epoch iterator (train_loader_stage2 equivalent)."""

    def __init__(self, batcher: ImageBatcher, sampler: RandomIdentitySampler):
        self.batcher = batcher
        self.sampler = sampler

    def epoch(self, epoch_idx: int) -> Iterator[Dict]:
        return self.batcher.iter_indices(self.sampler.epoch_indices(epoch_idx), drop_last=True)

    def __len__(self):
        return len(self.sampler) // self.batcher.batch_size


class ShuffledLoader:
    """Shuffled full-dataset iterator (train_loader_stage1 equivalent)."""

    def __init__(self, batcher: ImageBatcher, seed: int):
        self.batcher = batcher
        self.seed = seed

    def epoch(self, epoch_idx: int, drop_last: bool = False) -> Iterator[Dict]:
        return self.batcher.iter_shuffled(self.seed, epoch_idx, drop_last)

    def __len__(self):
        return len(self.batcher)


class ShardedLoader:
    """One rank's block of every global batch of ``loader`` (a
    ``TrainLoader`` or ``ShuffledLoader`` whose batch is the global one,
    ``SOLVER.IMS_PER_BATCH``): the epoch's global order cut by
    ``shard_for_host`` into ``num_shards`` contiguous blocks per batch, as
    the JAX package's hosts feed theirs (tests/_mp_worker.py). Every rank
    draws the same global order from the same seed, so together the ranks
    see each global batch exactly once; full batches only (a
    ``ShuffledLoader``'s partial last batch is dropped). It decodes through
    a copy of the loader's batcher at the block size, sharing its cache."""

    def __init__(self, loader, num_shards: int, shard_id: int):
        src = loader.batcher
        if src.batch_size % num_shards:
            raise ValueError(f"SOLVER.IMS_PER_BATCH {src.batch_size} does not split over "
                             f"{num_shards} ranks")
        self.loader = loader
        self.num_shards, self.shard_id = num_shards, shard_id
        self.global_batch = src.batch_size
        self.batcher = copy.copy(src)  # the same decoder (and cache) at the block size
        self.batcher.batch_size = src.batch_size // num_shards
        self.batcher.prefetcher = ThreadPoolExecutor(max_workers=1)
        self.batcher._pool = None

    def epoch_order(self, epoch_idx: int) -> np.ndarray:
        if isinstance(self.loader, TrainLoader):
            return np.asarray(self.loader.sampler.epoch_indices(epoch_idx))
        rng = np.random.default_rng(self.loader.seed + epoch_idx)
        return rng.permutation(len(self.loader.batcher.records))

    def epoch(self, epoch_idx: int) -> Iterator[Dict]:
        block = shard_for_host(self.epoch_order(epoch_idx), self.global_batch,
                               self.num_shards, self.shard_id)
        return self.batcher.iter_indices(block, drop_last=True)

    def __len__(self):
        return len(self.loader)


def make_dataloader(cfg, dataset: Optional[ReIDDataset] = None):
    """Reference make_dataloader contract (make_dataloader_uniprompt.py:52-118)."""
    if dataset is None:
        kwargs = {}
        name = cfg.DATASETS.NAMES
        if name in ("mmmp", "sysu", "regdb", "agreidv2"):
            kwargs["exp_setting"] = cfg.DATASETS.EXP_SETTING
        # deterministic eval splits: the seed is threaded explicitly
        if name == "mmmp":
            kwargs["split_seed"] = cfg.SOLVER.SEED
        if name == "VehicleID":
            kwargs["seed"] = cfg.SOLVER.SEED
        dataset = build_dataset(name, cfg.DATASETS.ROOT_DIR, **kwargs)

    num_workers = cfg.DATALOADER.NUM_WORKERS
    size_train = tuple(cfg.INPUT.SIZE_TRAIN)
    size_test = tuple(cfg.INPUT.SIZE_TEST)
    stage2_bs = cfg.SOLVER.STAGE2.IMS_PER_BATCH
    stage1_bs = cfg.SOLVER.STAGE1.IMS_PER_BATCH

    # one shared decode cache for both train batchers (same records/size)
    cache = {} if cfg.DATALOADER.CACHE_IMAGES else False
    native = cfg.DATALOADER.NATIVE_DECODE
    train_batcher = ImageBatcher(dataset.train, size_train, stage2_bs, num_workers,
                                 cache=cache, native=native)
    if "triplet" in cfg.DATALOADER.SAMPLER:
        sampler = RandomIdentitySampler(
            dataset.train, stage2_bs, cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED
        )
        train_loader_stage2 = TrainLoader(train_batcher, sampler)
    elif cfg.DATALOADER.SAMPLER == "softmax":
        train_loader_stage2 = ShuffledLoader(train_batcher, cfg.SOLVER.SEED)
    else:
        raise ValueError(f"unsupported sampler {cfg.DATALOADER.SAMPLER!r}")

    stage1_batcher = ImageBatcher(dataset.train, size_train, stage1_bs, num_workers,
                                  cache=cache, native=native)
    train_loader_stage1 = ShuffledLoader(stage1_batcher, cfg.SOLVER.SEED)

    val_records = list(dataset.query) + list(dataset.gallery)
    val_loader = ImageBatcher(val_records, size_test, cfg.TEST.IMS_PER_BATCH,
                              num_workers, cache=cache, native=native)

    return (
        train_loader_stage2,
        train_loader_stage1,
        val_loader,
        len(dataset.query),
        dataset.num_train_pids,
        dataset.num_train_cams,
        dataset.num_train_vids,
    )
