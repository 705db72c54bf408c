"""Baseline eval driver.

ref mpreid_tpu/engine/processor.py::run_validation, ::do_inference.
Extract features batch by batch, then run the evaluator. The JAX package's
eval-step cache keyed on ``id(model)`` is not carried over: building the
step is cheap in eager PyTorch. Gallery-sharded multi-device eval
(``TPU.EVAL_SHARDED``) belongs to the parallel slice. Training drivers
belong to the training slice.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from .evaluator import R1mAPEvaluator
from .steps import make_eval_step


def run_validation(cfg, model, val_loader, num_query, logger=None,
                   epoch: Optional[int] = None):
    """Shared eval loop (ref processor.py:117-158 / 187-208) → (cmc, mAP)."""
    if cfg.TPU.EVAL_SHARDED:
        raise NotImplementedError(
            "TPU.EVAL_SHARDED is not ported yet (ROADMAP.md, A11 parallel modes)"
        )
    evaluator = R1mAPEvaluator(
        num_query,
        max_rank=50,
        feat_norm=cfg.TEST.FEAT_NORM == "yes",
        reranking=cfg.TEST.RE_RANKING,
        camera_filter=cfg.TEST.CAMERA_FILTER,
        dist_metric=cfg.TEST.DIST_METRIC,
    )
    eval_step = make_eval_step(model, cfg)
    for batch in val_loader.iter_sequential():
        feat = eval_step(batch)
        n = batch["count"]
        evaluator.update((feat[:n], batch["pids"][:n], batch["camids"][:n]))
    cmc, mAP, distmat, *_ = evaluator.compute()
    if cfg.TEST.DIST_MAT and cfg.OUTPUT_DIR:
        np.save(os.path.join(cfg.OUTPUT_DIR, cfg.TEST.DIST_MAT), distmat)
    if logger:
        tag = f" - Epoch: {epoch}" if epoch is not None else " "
        logger.info(f"Validation Results{tag}")
        logger.info("mAP: {:.1%}".format(mAP))
        for r in (1, 5, 10):
            if r <= len(cmc):  # tiny galleries have fewer ranks than 10
                logger.info("CMC curve, Rank-{:<3}:{:.1%}".format(r, cmc[r - 1]))
    return cmc, mAP


def do_inference(cfg, model, val_loader, num_query: int):
    """Feature extraction + metrics (ref processor.py:166-208) → (rank-1, rank-5)."""
    logger = logging.getLogger("mpreid_tpu_torch.test")
    logger.info("Enter inferencing")
    cmc, _ = run_validation(cfg, model, val_loader, num_query, logger)
    return cmc[0], cmc[4]
