"""The reference's training steps: from the benchmark's initial weights,
over the same batches and the same augmentation draws as the port, it
follows the port's first steps and reports what the comparison reads:
each step's loss, each trained leaf's norm of the first gradient as Adam
takes it (the loss's gradient plus decay × weight) and of its change over
the steps.

Which leaves train, per the recipe:
- ``stage2a``: everything but the text tower, the prompt learner, MoE
  experts and the BNNecks' shifts (CLIP-ReID keeps them at zero);
- ``baseline``: everything but the BNNecks' shifts;
- ``stage1a``: the identities' generic prompt contexts alone."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from . import augment, losses, models
from .adam import Adam
from .precision import Precision


def trains(name: str, stage: str) -> bool:
    parts = name.split(".")
    if parts[0] in ("bottleneck", "bottleneck_proj") and parts[-1] == "bias":
        return False
    if stage == "baseline":
        return True
    if stage == "stage2a":
        return parts[0] not in ("text_encoder", "prompt_learner") and "expert" not in name
    if stage == "stage1a":
        return name == "prompt_learner.ctx_generic"
    raise ValueError(f"unknown stage {stage!r}")


def text_features(W, classes: int, prec: Precision, block: int = 128):
    """Every identity's stage-2 text feature (no view labels), no gradient."""
    device = W["text_encoder.ln_final.weight"].device
    with torch.no_grad():
        out = []
        for lo in range(0, classes, block):
            labels = torch.arange(lo, min(lo + block, classes), device=device)
            out.append(models.text(models.prompts(W, labels, "2"), W, prec))
        return torch.cat(out)


def _kept(x, labels, keep: float):
    """The first ``keep`` of the batch's rows (1: all; less plants the fault
    of a batch partly left out, for the readings of ``tools/readings.py``)."""
    n = max(1, int(round(len(labels) * keep)))
    return x[:n], labels[:n]


def stage2_loss(cfg: dict, classes: int, text: torch.Tensor, prec: Precision,
                keep: float = 1.0):
    """Uni-Prompt stage 2a: ID on the class token's BN feature, the
    triplet on the class token, image-to-text cross entropy on the
    projected token against every identity's text feature."""
    m, inp = cfg["MODEL"], cfg["INPUT"]

    def loss(W, images, labels, gen):
        x = augment.augment(images, gen, inp["PIXEL_MEAN"], inp["PIXEL_STD"], inp["PROB"],
                            inp["RE_PROB"], inp["PADDING"])
        x, labels = _kept(x, labels, keep)
        _, feat, proj = models.vision(x, W, prec)
        heads = models.reid_heads(feat, proj, W, prec)
        i2t = prec.mm(proj, text.t())
        return (m["ID_LOSS_WEIGHT"] * losses.ce_smooth(heads["score"], labels, classes)
                + m["TRIPLET_LOSS_WEIGHT"] * losses.triplet(feat, labels, cfg["SOLVER"]["MARGIN"])
                + m["I2T_LOSS_WEIGHT"] * losses.ce_smooth(i2t, labels, classes))

    return loss


def baseline_loss(cfg: dict, classes: int, prec: Precision, keep: float = 1.0):
    """CLIP-ReID's baseline: ID on both BN features, the triplet on the
    three features (layer3's, layer4's, the projected)."""
    m, inp = cfg["MODEL"], cfg["INPUT"]

    def loss(W, images, labels, gen):
        x = augment.augment(images, gen, inp["PIXEL_MEAN"], inp["PIXEL_STD"], inp["PROB"],
                            inp["RE_PROB"], inp["PADDING"])
        x, labels = _kept(x, labels, keep)
        last, feat, proj = models.tower(x, W, prec)
        heads = models.reid_heads(feat, proj, W, prec)
        ids = losses.ce_smooth(heads["score"], labels, classes) \
            + losses.ce_smooth(heads["score_proj"], labels, classes)
        margin = cfg["SOLVER"]["MARGIN"]
        tri = sum(losses.triplet(f, labels, margin) for f in (last, feat, proj))
        return m["ID_LOSS_WEIGHT"] * ids + m["TRIPLET_LOSS_WEIGHT"] * tri

    return loss


def stage1_loss(prec: Precision, keep: float = 1.0):
    """Stage 1a: SupCon image → text plus text → image between the bank's
    rows and their identities' prompted text features."""

    def loss(W, feats, labels, gen):
        feats, labels = _kept(feats, labels, keep)
        text = models.text(models.prompts(W, labels, "1a"), W, prec)
        img = feats.float()
        return losses.supcon(img, text, labels, labels) + losses.supcon(text, img, labels, labels)

    return loss


def follow(W0: Dict[str, torch.Tensor], stage: str, solver: dict, lr: float,
           batches: List[tuple], loss: Callable, gen=None) -> dict:
    """Steps from ``W0`` over ``batches`` ((inputs, labels) each) →
    {"losses", "grad_norms" (first step, as Adam takes it), "loss_grads"
    (first step, the loss's alone), "params" (the trained leaves after the
    last step)}."""
    W = {k: v.clone() for k, v in W0.items()}
    train = {k: W[k].requires_grad_(True) for k in W if trains(k, stage)}
    opt = Adam(train, solver)
    out = {"losses": [], "grad_norms": {}}
    for step, (inputs, labels) in enumerate(batches):
        value = loss(W, inputs, labels.long(), gen)
        grads = torch.autograd.grad(value, list(train.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(train.items(), grads)}
        if step == 0:
            out["grad_norms"] = {k: float(torch.linalg.norm(
                opt.effective_grad(k, p.detach(), grads[k]).double())) for k, p in train.items()}
            out["loss_grads"] = grads
        opt.step({k: p.detach() for k, p in train.items()}, grads, lr)
        out["losses"].append(float(value.detach()))
    out["params"] = {k: p.detach() for k, p in train.items()}
    return out
