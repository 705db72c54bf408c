"""Uni-Prompt evaluation entry point: ``python -m mpreid_tpu_torch.test_uniprompt``.

ref test_uniprompt.py (the JAX package's entry script): the same CLI,

    python -m mpreid_tpu_torch.test_uniprompt \\
        --config_file configs/ours/cctv_ir_cctv_rgb.yml \\
        TEST.WEIGHT output_uniprompt/exp_cctv_ir_cctv_rgb/ViT-B-16_60.pth

and its eval branches in its order: the VehicleID 10-trial averaging protocol as
``python -m mpreid_tpu_torch.test`` runs it; else, with
``TEST.TTPT.ENABLED`` or ``TEST.TTA_ENABLED``, the TTA / TTPT eval modes
(``engine/ttpt.py::do_inference_ttpt``); else plain inference. Each returns
(rank-1, rank-5). It runs on the CUDA card; ``MODEL.DEVICE cpu`` asks for
the CPU. ``TEST.WEIGHT`` takes a training checkpoint of the port or a
reference-layout Uni-Prompt ``.pth`` (``models/convert.py::load_param``);
without one the weights are random from ``SOLVER.SEED``. With
``MODEL.MOE.ENABLED`` the model is the MoE one (``switch_to_moe`` before the
weights load, as the JAX script does).
"""

from __future__ import annotations

import argparse

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import build_dataset, make_dataloader
from mpreid_tpu_torch.engine import do_inference, do_inference_ttpt
from mpreid_tpu_torch.models import load_param, make_model_uniprompt, switch_to_moe
from mpreid_tpu_torch.test import is_torch_weight, vehicleid_trials
from mpreid_tpu_torch.train import start


def main(argv=None):
    parser = argparse.ArgumentParser(description="Uni-Prompt ReID Testing")
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
            "reference-layout torch state_dicts and its own checkpoints only"
        )

    dataset = None
    if cfg.DATASETS.NAMES == "VehicleID":
        dataset = build_dataset("VehicleID", cfg.DATASETS.ROOT_DIR, seed=cfg.SOLVER.SEED)
    (_, _, val_loader, num_query, num_classes,
     camera_num, view_num) = make_dataloader(cfg, dataset=dataset)

    model = make_model_uniprompt(cfg, num_class=num_classes, camera_num=camera_num,
                                 view_num=view_num, device=device)
    model = switch_to_moe(cfg, model)
    if cfg.TEST.WEIGHT:
        load_param(cfg.TEST.WEIGHT, model)
        logger.info(f"Loading pretrained model from {cfg.TEST.WEIGHT}")

    if dataset is not None:
        return vehicleid_trials(cfg, model, dataset, logger)
    if cfg.TEST.TTPT.ENABLED or cfg.TEST.TTA_ENABLED:
        return do_inference_ttpt(cfg, model, val_loader, num_query)
    return do_inference(cfg, model, val_loader, num_query)


if __name__ == "__main__":
    main()
