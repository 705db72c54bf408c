"""Baseline evaluation entry point: ``python -m mpreid_tpu_torch.test``.

ref test.py (the JAX package's entry script): the same CLI,

    python -m mpreid_tpu_torch.test --config_file configs/person/vit_base.yml \
        TEST.WEIGHT path/to/model.pth DATASETS.ROOT_DIR ../data

including the VehicleID 10-trial averaging protocol (ref test.py:46-63).
It runs on the CUDA card; ``MODEL.DEVICE cpu`` asks for the CPU.
``TEST.WEIGHT`` takes a reference-layout ``.pth`` (``.pt``); without one the
weights are random from ``SOLVER.SEED``.
"""

from __future__ import annotations

import argparse

import numpy as np

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import ImageBatcher, build_dataset, make_dataloader
from mpreid_tpu_torch.engine import do_inference, run_validation
from mpreid_tpu_torch.models import load_param, make_model
from mpreid_tpu_torch.train import start


def is_torch_weight(path: str) -> bool:
    return str(path).endswith((".pth", ".pt"))


def main(argv=None):
    parser = argparse.ArgumentParser(description="ReID Baseline Testing")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()

    device, logger = start(cfg, cfg.OUTPUT_DIR, if_train=False)
    logger.info(f"Running on {device} with config:\n{cfg}")
    if cfg.TEST.WEIGHT and not is_torch_weight(cfg.TEST.WEIGHT):
        raise ValueError(
            f"TEST.WEIGHT {cfg.TEST.WEIGHT!r} is not a .pth/.pt file; the port reads "
            "reference-layout torch state_dicts only (export a JAX checkpoint with "
            "mpreid_tpu.models.convert.save_param first)"
        )

    if cfg.DATASETS.NAMES == "VehicleID":
        dataset = build_dataset("VehicleID", cfg.DATASETS.ROOT_DIR, seed=cfg.SOLVER.SEED)
        (_, _, val_loader, num_query, num_classes,
         camera_num, view_num) = make_dataloader(cfg, dataset=dataset)
    else:
        dataset = None
        (_, _, val_loader, num_query, num_classes,
         camera_num, view_num) = make_dataloader(cfg)

    model = make_model(cfg, num_class=num_classes, camera_num=camera_num,
                       view_num=view_num, device=device)
    if cfg.TEST.WEIGHT:
        load_param(cfg.TEST.WEIGHT, model)
        logger.info(f"Loading pretrained model from {cfg.TEST.WEIGHT}")

    if cfg.DATASETS.NAMES != "VehicleID":
        return do_inference(cfg, model, val_loader, num_query)
    return vehicleid_trials(cfg, model, dataset, logger)


def vehicleid_trials(cfg, model, dataset, logger):
    """10 random gallery trials, averaged (ref test.py:46-63) → (rank-1, rank-5)."""
    all_r1, all_r5, all_map = [], [], []
    for trial in range(10):
        dataset.resample()
        records = list(dataset.query) + list(dataset.gallery)
        val_loader = ImageBatcher(records, tuple(cfg.INPUT.SIZE_TEST),
                                  cfg.TEST.IMS_PER_BATCH, cfg.DATALOADER.NUM_WORKERS)
        cmc, mAP = run_validation(cfg, model, val_loader, len(dataset.query), logger)
        logger.info(f"Trial {trial}: Rank-1 {cmc[0]:.1%} Rank-5 {cmc[4]:.1%} mAP {mAP:.1%}")
        all_r1.append(float(cmc[0]))
        all_r5.append(float(cmc[4]))
        all_map.append(float(mAP))
    logger.info(
        f"Averaged over 10 trials: Rank-1 {np.mean(all_r1):.1%} "
        f"Rank-5 {np.mean(all_r5):.1%} mAP {np.mean(all_map):.1%}"
    )
    return float(np.mean(all_r1)), float(np.mean(all_r5))


if __name__ == "__main__":
    main()
