from .optim import (
    CenterOptimizer,
    OptState,
    Optimizer,
    group_trees,
    make_optimizer,
    stage_trainable,
)
from .schedules import make_scheduler, warmup_cosine, warmup_multistep, with_lr_noise

__all__ = [
    "CenterOptimizer", "OptState", "Optimizer", "group_trees", "make_optimizer",
    "make_scheduler", "stage_trainable", "warmup_cosine", "warmup_multistep",
    "with_lr_noise",
]
