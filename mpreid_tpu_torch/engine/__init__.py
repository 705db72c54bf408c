from .evaluator import R1mAPEvaluator
from .processor import (
    build_device_dataset, cached_eval_step, do_inference, do_train, epoch_perm,
    release_eval_steps, run_validation, train_epochs,
)
from .steps import (
    loss_and_grads, make_eval_step, make_image_bank_step, make_stage1_epoch, make_stage1_step,
    make_text_step, make_train_epoch, make_train_step, stage1_loss_and_grads, trainable_params,
)
from .train_state import TrainState, initial_state
from .ttpt import (
    cached_tta_query_step, cached_ttpt_query_step, cached_ttpt_tuner, do_inference_tta,
    do_inference_ttpt, make_tta_query_step, make_ttpt_query_step, make_ttpt_tuner,
)
from .uniprompt import (
    build_image_bank, do_train_stage1, do_train_stage2, precompute_text_features,
)

__all__ = [
    "R1mAPEvaluator", "TrainState", "build_device_dataset", "build_image_bank",
    "cached_eval_step", "cached_tta_query_step", "cached_ttpt_query_step", "cached_ttpt_tuner",
    "do_inference", "do_inference_tta", "do_inference_ttpt", "do_train", "do_train_stage1",
    "do_train_stage2", "epoch_perm",
    "initial_state", "loss_and_grads", "make_eval_step", "make_image_bank_step",
    "make_stage1_epoch", "make_stage1_step", "make_text_step", "make_train_epoch",
    "make_train_step", "make_tta_query_step", "make_ttpt_query_step", "make_ttpt_tuner",
    "precompute_text_features", "release_eval_steps",
    "run_validation", "stage1_loss_and_grads", "train_epochs", "trainable_params",
]
