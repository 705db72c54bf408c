"""Baseline training entry point: ``python -m mpreid_tpu_torch.train``.

ref train.py (the JAX package's entry script): the same CLI,

    python -m mpreid_tpu_torch.train --config_file configs/person/vit_base.yml \
        DATASETS.ROOT_DIR ../data

It runs on the CUDA card; ``MODEL.DEVICE cpu`` asks for the CPU. The
weights start random from ``SOLVER.SEED``; ``MODEL.PRETRAIN_PATH <file>``
replaces the towers with the OpenAI CLIP weights of a local file
(``ViT-B-16.pt``, ``RN50.pt``). Nothing is downloaded: ``MODEL.PRETRAIN_AUTO``
without a path raises. With ``MODEL.MOE.ENABLED`` the model has the MoE
vision tower from the start, as the JAX package's ``make_model`` builds it.

Under torchrun it trains data parallel over the ranks, one card each
(``cuda:LOCAL_RANK``, NCCL; ``MODEL.DEVICE cpu``: gloo), with
``SOLVER.IMS_PER_BATCH`` the global batch:

    torchrun --nproc_per_node=N -m mpreid_tpu_torch.train \
        --config_file configs/person/vit_base.yml DATASETS.ROOT_DIR ../data

Without torchrun's environment it runs on one device as before.
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np
import torch

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import make_dataloader
from mpreid_tpu_torch.engine import do_train
from mpreid_tpu_torch.engine.processor import log_inert_keys
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import load_pretrained, make_model, pretrain_path
from mpreid_tpu_torch.parallel import init_distributed, is_main, rank_device
from mpreid_tpu_torch.solver import make_optimizer, make_scheduler
from mpreid_tpu_torch.utils import device_from_cfg, setup_logger


def set_seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def start(cfg, log_dir: str, if_train: bool):
    """The entry points' common start: this rank's device, the process
    group when torchrun launched the run (``parallel.init_distributed``), and
    the logger (rank 0 logs to stdout and ``log_dir``, the other ranks
    warnings only), which then names the keys of ``cfg`` that do nothing in
    the port (``log_inert_keys``) → (device, logger)."""
    device = rank_device(device_from_cfg(cfg))
    init_distributed(device=device)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    logger = setup_logger("mpreid_tpu_torch", log_dir if is_main() else "", if_train=if_train)
    if not is_main():
        logger.setLevel(logging.WARNING)
    log_inert_keys(cfg, logger)
    return device, logger


def main(argv=None):
    parser = argparse.ArgumentParser(description="ReID Baseline Training")
    parser.add_argument("--config_file", default="", type=str, help="path to config file")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options from the command line")
    args = parser.parse_args(argv)

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    # the baseline uses the flat SOLVER block for loaders built on stage fields
    cfg.SOLVER.STAGE2.IMS_PER_BATCH = cfg.SOLVER.IMS_PER_BATCH
    cfg.freeze()

    device, logger = start(cfg, cfg.OUTPUT_DIR, if_train=True)
    clip_file = pretrain_path(cfg)
    set_seed(cfg.SOLVER.SEED)
    logger.info(f"Saving model in the path :{cfg.OUTPUT_DIR}")
    if args.config_file:
        logger.info(f"Loaded configuration file {args.config_file}")
    logger.info(f"Running on {device} with config:\n{cfg}")

    (train_loader, _, val_loader, num_query, num_classes,
     camera_num, view_num) = make_dataloader(cfg)
    model = make_model(cfg, num_class=num_classes, camera_num=camera_num,
                       view_num=view_num, device=device)
    if clip_file:
        load_pretrained(model, cfg)
        logger.info(f"Loaded CLIP weights from {clip_file}")

    loss_fn, (center_init, _) = make_loss(cfg, num_classes=num_classes)
    centers = None
    if "center" in cfg.MODEL.METRIC_LOSS_TYPE:
        centers = center_init(torch.Generator().manual_seed(cfg.SOLVER.SEED + 1)).to(device)

    optimizer = make_optimizer(cfg.SOLVER, model, stage="baseline")
    scheduler = make_scheduler(cfg.SOLVER, "multistep")
    return do_train(cfg, model, train_loader, val_loader, optimizer, scheduler, loss_fn,
                    num_query, centers=centers)


if __name__ == "__main__":
    main()
