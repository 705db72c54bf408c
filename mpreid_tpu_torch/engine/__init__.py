from .evaluator import R1mAPEvaluator
from .processor import do_inference, do_train, run_validation
from .steps import loss_and_grads, make_eval_step, make_train_step
from .train_state import TrainState, initial_state

__all__ = ["R1mAPEvaluator", "TrainState", "do_inference", "do_train", "initial_state",
           "loss_and_grads", "make_eval_step", "make_train_step", "run_validation"]
