"""Uni-Prompt training entry point: ``python -m mpreid_tpu_torch.train_uniprompt``.

ref train_uniprompt.py (the JAX package's entry script): the same CLI and
the same four phases, stage 1a → 1b → 2a → 2b, then inference,

    python -m mpreid_tpu_torch.train_uniprompt \\
        --config_file configs/ours/cctv_ir_cctv_rgb.yml DATASETS.ROOT_DIR ../data

It runs on the CUDA card; ``MODEL.DEVICE cpu`` asks for the CPU. The
weights start random from ``SOLVER.SEED``; ``MODEL.PRETRAIN_PATH <file>``
replaces both towers with the OpenAI CLIP weights of a local file, loaded
through the dense stage-1 config (nothing is downloaded: ``MODEL.PRETRAIN_AUTO``
without a path raises). Stage 1 trains the dense model; with
``MODEL.MOE.ENABLED`` it is upcycled to the MoE vision tower after stage 1b
(``models.switch_to_moe``), and stages 2a and 2b train that. Under
torchrun stage 2 trains data parallel over the ranks (stage 1 runs alike on
every rank), as ``python -m mpreid_tpu_torch.train`` does.
"""

from __future__ import annotations

import argparse
import os

import torch

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import make_dataloader
from mpreid_tpu_torch.engine import (
    build_image_bank, do_inference, do_train_stage1, do_train_stage2,
)
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import (
    load_pretrained, make_model_uniprompt, pretrain_path, switch_to_moe,
)
from mpreid_tpu_torch.solver import make_optimizer, make_scheduler
from mpreid_tpu_torch.train import set_seed, start


def main(argv=None):
    parser = argparse.ArgumentParser(description="Uni-Prompt ReID Training")
    parser.add_argument("--config_file", default="configs/ours/cctv_ir_cctv_rgb.yml", type=str)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()

    output_dir = cfg.OUTPUT_DIR and os.path.join(cfg.OUTPUT_DIR, cfg.DATASETS.EXP_SETTING)
    device, logger = start(cfg, output_dir, if_train=True)
    clip_file = pretrain_path(cfg)
    set_seed(cfg.SOLVER.SEED)
    logger.info(f"Saving model in the path :{cfg.OUTPUT_DIR}")
    logger.info(f"Running on {device} with config:\n{cfg}")

    (train_loader_stage2, train_loader_stage1, val_loader, num_query,
     num_classes, camera_num, view_num) = make_dataloader(cfg)

    # stage 1 trains the dense model; the MoE switch comes after it
    stage1_cfg = cfg.clone()
    stage1_cfg.MODEL.MOE.ENABLED = False
    stage1_cfg.freeze()
    model = make_model_uniprompt(stage1_cfg, num_class=num_classes, camera_num=camera_num,
                                 view_num=view_num, device=device)
    if clip_file:
        # the dense stage-1 config: the model grafted is the dense one
        load_pretrained(model, stage1_cfg)
        logger.info(f"Loaded CLIP weights from {clip_file}")

    loss_fn, (center_init, _) = make_loss(cfg, num_classes=num_classes)
    centers = None
    if "center" in cfg.MODEL.METRIC_LOSS_TYPE:
        centers = center_init(torch.Generator().manual_seed(cfg.SOLVER.SEED + 1)).to(device)

    logger.info("===== Configuring and starting Stage 1a training =====")
    bank = build_image_bank(cfg, model, train_loader_stage1)
    opt_1a = make_optimizer(cfg.SOLVER.STAGE1A, model, stage="stage1a")
    do_train_stage1(cfg, model, train_loader_stage1, opt_1a,
                    make_scheduler(cfg.SOLVER.STAGE1A, "cosine"), is_stage1b=False, bank=bank,
                    stage_cfg=cfg.SOLVER.STAGE1A)

    logger.info("===== Configuring and starting Stage 1b training =====")
    opt_1b = make_optimizer(cfg.SOLVER.STAGE1B, model, stage="stage1b")
    do_train_stage1(cfg, model, train_loader_stage1, opt_1b,
                    make_scheduler(cfg.SOLVER.STAGE1B, "cosine"), is_stage1b=True, bank=bank,
                    stage_cfg=cfg.SOLVER.STAGE1B)
    del bank

    if cfg.MODEL.MOE.ENABLED:
        logger.info("Switching to MoE vision transformer")
        model = switch_to_moe(cfg, model)

    logger.info("2a stage, train parameters marked as trainable...")
    opt_2a = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    sched_2 = make_scheduler(cfg.SOLVER.STAGE2, "multistep")
    do_train_stage2(cfg, model, train_loader_stage2, val_loader, opt_2a, sched_2, loss_fn,
                    num_query, num_classes, centers=centers)

    logger.info("2b stage, train gate and image_encoder mlp (except experts)")
    opt_2b = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2b")
    do_train_stage2(cfg, model, train_loader_stage2, val_loader, opt_2b, sched_2, loss_fn,
                    num_query, num_classes, centers=centers)

    return do_inference(cfg, model, val_loader, num_query)


if __name__ == "__main__":
    main()
