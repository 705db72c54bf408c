from .center import center_loss, init_centers
from .factory import make_loss
from .margin import (
    amsoftmax_logits, arcface_logits, circle_logits, contrastive_loss, cosface_logits,
)
from .softmax import cross_entropy, cross_entropy_label_smooth
from .supcon import supcon_loss
from .triplet import euclidean_dist, hard_example_mining, normalize, triplet_loss

__all__ = [
    "amsoftmax_logits", "arcface_logits", "center_loss", "circle_logits", "contrastive_loss",
    "cosface_logits", "cross_entropy", "cross_entropy_label_smooth", "euclidean_dist",
    "hard_example_mining", "init_centers", "make_loss", "normalize", "supcon_loss",
    "triplet_loss",
]
