from .attention import attention_plain, fused_attention, head_major_perm, head_major_perm_inverse
from .augment import eval_preprocess, normalize
from .distmat import cosine_distmat, euclidean_squared_distmat
from .metrics import cmc_map

__all__ = [
    "attention_plain", "cmc_map", "cosine_distmat", "euclidean_squared_distmat",
    "eval_preprocess", "fused_attention", "head_major_perm", "head_major_perm_inverse",
    "normalize",
]
