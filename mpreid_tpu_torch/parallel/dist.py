"""The process group, from torchrun's environment.

ref mpreid_tpu/parallel/mesh.py::init_distributed. The JAX package joins
hosts with ``jax.distributed.initialize`` and is a no-op for one process;
the port joins ranks with ``torch.distributed.init_process_group`` when
torchrun's variables (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) are set, and without them is rank 0 of a
world of 1 with no group. Under torchrun the group is made even for a world
of 1, so ``torchrun --nproc_per_node=1`` runs the collectives for real.

The backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU unless
the caller asks for another (two ranks sharing one card take ``gloo``: NCCL
refuses two ranks on one device). Nothing falls back: ``nccl`` without a
card raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

LAUNCH_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True when torchrun's variables are set."""
    return all(k in os.environ for k in LAUNCH_ENV)


def rank_device(device) -> torch.device:
    """The device this rank runs on: a CUDA device without an index becomes
    ``cuda:LOCAL_RANK`` under torchrun; anything else is kept as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and launched():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def init_distributed(backend: Optional[str] = None, device=None) -> int:
    """Join the process group that torchrun's environment describes → this
    process's rank (0 without that environment, where no group is made).

    ``device`` (default: ``cuda:LOCAL_RANK`` when a card is present, else the
    CPU) picks the backend when ``backend`` is None and, for a CUDA device,
    becomes the current device."""
    if dist.is_initialized():
        return dist.get_rank()
    if not launched():
        return 0
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = rank_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(f"backend nccl needs a CUDA device; this rank's is {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend, init_method=address, world_size=world, rank=rank)
    return rank


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, the one that logs metrics and writes files."""
    return rank() == 0

