from .adam import adam_leaf_plain, adam_leaves, fused_adam_leaf
from .attention import (
    FusedAttention, attention_bwd_plain, attention_plain, fused_attention, fused_attention_bwd,
    head_major_perm, head_major_perm_inverse,
)
from .augment import eval_preprocess, normalize, train_augment, train_augment_with_draws
from .batch_hard import (
    batch_hard_mining, batch_hard_plain, batch_hard_triplet_loss, fused_batch_hard,
)
from .distmat import cosine_distmat, euclidean_squared_distmat
from .metrics import cmc_map
from .pairwise import l1_cross, l1_cross_plain, minsum_cross, minsum_cross_plain
from .reranking import re_ranking
from .reranking_sparse import re_ranking_sparse, re_ranking_sparse_rows

__all__ = [
    "FusedAttention", "adam_leaf_plain", "adam_leaves", "attention_bwd_plain", "attention_plain",
    "batch_hard_mining", "batch_hard_plain", "batch_hard_triplet_loss", "cmc_map",
    "cosine_distmat", "euclidean_squared_distmat", "eval_preprocess", "fused_adam_leaf",
    "fused_attention", "fused_attention_bwd", "fused_batch_hard", "head_major_perm",
    "head_major_perm_inverse",
    "l1_cross", "l1_cross_plain", "minsum_cross", "minsum_cross_plain", "normalize",
    "re_ranking", "re_ranking_sparse", "re_ranking_sparse_rows", "train_augment",
    "train_augment_with_draws",
]
