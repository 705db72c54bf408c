from .base import ReIDDataset, Record, imagedata_info
from .datasets import DATASET_REGISTRY, VehicleID, build_dataset
from .loader import (
    ImageBatcher, ShardedLoader, ShuffledLoader, TrainLoader, decode_resize, make_dataloader,
)
from .sampler import RandomIdentitySampler, shard_for_host

__all__ = [
    "DATASET_REGISTRY", "ImageBatcher", "RandomIdentitySampler", "ReIDDataset",
    "Record", "ShardedLoader", "ShuffledLoader", "TrainLoader", "VehicleID", "build_dataset",
    "decode_resize", "imagedata_info", "make_dataloader", "shard_for_host",
]
