"""Loss factory.

ref mpreid_tpu/losses/factory.py::make_loss. Builds
``loss_fn(score, feat, target, target_cam=None, i2tscore=None, class_split=None)``:

    ID_LOSS_WEIGHT · Σ xent(scoreᵢ) + TRIPLET_LOSS_WEIGHT · Σ triplet(featᵢ)
    [+ I2T_LOSS_WEIGHT · xent(i2tscore)]

with label smoothing per ``MODEL.IF_LABELSMOOTH`` and the soft-margin
triplet per ``MODEL.NO_MARGIN``. The center criterion comes back as an
``(init_fn, loss_fn)`` pair (feat_dim 2048, as in the reference).
``class_split``: the classifiers' ``Split`` over a model axis, when the
scores are this rank's columns (``models/layers.py::class_split``); the
i2t scores are always whole.
"""

from __future__ import annotations

from .center import center_loss, init_centers
from .softmax import cross_entropy, cross_entropy_label_smooth
from .triplet import triplet_loss

CENTER_FEAT_DIM = 2048


def make_loss(cfg, num_classes: int):
    sampler = cfg.DATALOADER.SAMPLER
    margin = None if cfg.MODEL.NO_MARGIN else cfg.SOLVER.MARGIN
    id_w = cfg.MODEL.ID_LOSS_WEIGHT
    tri_w = cfg.MODEL.TRIPLET_LOSS_WEIGHT
    i2t_w = cfg.MODEL.I2T_LOSS_WEIGHT
    metric_type = cfg.MODEL.METRIC_LOSS_TYPE

    if cfg.MODEL.IF_LABELSMOOTH == "on":
        def xent(logits, target, split=None):
            return cross_entropy_label_smooth(logits, target, num_classes, split=split)
    else:
        xent = cross_entropy

    if sampler == "softmax":
        def loss_func(score, feat, target, target_cam=None, i2tscore=None, class_split=None):
            if isinstance(score, (list, tuple)):
                score = score[0]
            return cross_entropy(score, target, class_split)

    elif sampler == "softmax_triplet":
        if "triplet" not in metric_type:
            raise ValueError(
                f"expected METRIC_LOSS_TYPE to contain 'triplet' but got {metric_type}"
            )

        def loss_func(score, feat, target, target_cam=None, i2tscore=None, class_split=None):
            scores = score if isinstance(score, (list, tuple)) else [score]
            feats = feat if isinstance(feat, (list, tuple)) else [feat]
            id_loss = sum(xent(s, target, class_split) for s in scores)
            tri_loss = sum(triplet_loss(f, target, margin=margin)[0] for f in feats)
            loss = id_w * id_loss + tri_w * tri_loss
            if i2tscore is not None:
                loss = loss + i2t_w * xent(i2tscore, target)
            return loss

    else:
        raise ValueError(
            f"expected sampler to be softmax or softmax_triplet but got {sampler}"
        )

    def center_init(gen):
        return init_centers(gen, num_classes, CENTER_FEAT_DIM)

    return loss_func, (center_init, center_loss)
