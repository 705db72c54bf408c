from .evaluator import R1mAPEvaluator
from .processor import do_inference, run_validation
from .steps import make_eval_step

__all__ = ["R1mAPEvaluator", "do_inference", "make_eval_step", "run_validation"]
