from .center import center_loss, init_centers
from .factory import make_loss
from .softmax import cross_entropy, cross_entropy_label_smooth
from .supcon import supcon_loss
from .triplet import euclidean_dist, hard_example_mining, triplet_loss

__all__ = [
    "center_loss", "cross_entropy", "cross_entropy_label_smooth", "euclidean_dist",
    "hard_example_mining", "init_centers", "make_loss", "supcon_loss", "triplet_loss",
]
