from .adam import adam_leaf_plain, fused_adam_leaf
from .attention import (
    FusedAttention, attention_bwd_plain, attention_plain, fused_attention, fused_attention_bwd,
    head_major_perm, head_major_perm_inverse,
)
from .augment import eval_preprocess, normalize, train_augment, train_augment_with_draws
from .distmat import cosine_distmat, euclidean_squared_distmat
from .metrics import cmc_map

__all__ = [
    "FusedAttention", "adam_leaf_plain", "attention_bwd_plain", "attention_plain", "cmc_map",
    "cosine_distmat", "euclidean_squared_distmat", "eval_preprocess", "fused_adam_leaf",
    "fused_attention", "fused_attention_bwd", "head_major_perm", "head_major_perm_inverse",
    "normalize", "train_augment", "train_augment_with_draws",
]
