"""Test-time augmentation and test-time prompt tuning eval modes.

ref mpreid_tpu/engine/ttpt.py::tta_views, ::tta_aggregate, ::do_inference_tta,
::_log_and_return_ranks, ::_make_ttpt_tuner_cached, ::do_inference_ttpt
(reference ``processor_uniprompt_stage2.py:269-693``, against the current
``PromptLearner``, whose tuned context is ``ctx_generic``).

* Option A (``do_inference_tta``, ``TEST.TTA_ENABLED``): each query
  feature is the mean over four views of its image: the original, the
  h-flip, pseudo-IR (the channel mean) and pseudo-RGB (channel 0, both
  broadcast over the three channels). Gallery rows keep the plain feature,
  also in a batch that straddles the query/gallery split.
* Option B (``do_inference_ttpt``, ``TEST.TTPT.ENABLED``): for each query
  batch a copy of ``ctx_generic`` takes ``TEST.TTPT.STEPS`` AdamW steps of
  entropy minimisation over softmax(image · textᵀ / T) against every
  class's text feature; the tuned text feature of the most similar class is
  the query, ranked against the gallery's projected features with the
  same-pid same-camera filter (``camera_filter=True``, as the reference's
  TTPT paths do).

The tuner never writes into the model: the tuned context is a tensor of its
own, passed to ``get_text`` as ``ctx_generic``, and differentiated with
``torch.autograd.grad``; the model's parameters take no gradient while it
runs (their ``requires_grad`` flags are restored after).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, List, Tuple

import numpy as np
import torch

from mpreid_tpu_torch.ops import cmc_map
from mpreid_tpu_torch.ops.augment import eval_preprocess

from .evaluator import R1mAPEvaluator
from .steps import _device_of, _to, labels_for


def tta_views(x: torch.Tensor) -> List[torch.Tensor]:
    """The four pseudo-modality views of a preprocessed NHWC batch:
    original, h-flip, pseudo-IR, pseudo-RGB."""
    gray = x.sum(dim=-1, keepdim=True) * (1.0 / x.shape[-1])  # XLA's mean rounds so
    return [x, x.flip(2), gray.expand(x.shape), x[..., 0:1].expand(x.shape)]


def tta_aggregate(fwd: Callable, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean feature over the TTA views, plain-view feature)."""
    feats = [fwd(v) for v in tta_views(x)]
    return torch.stack(feats, dim=0).mean(dim=0), feats[0]


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def _batches(cfg, model, val_loader):
    """(preprocessed images, camera and view labels on the device, batch)
    of each eval batch in order."""
    device = _device_of(model)
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    for batch in val_loader.iter_sequential():
        x = eval_preprocess(_to(device, batch["images"]), mean=mean, std=std)
        cam, view = (_to(device, a) for a in labels_for(cfg, batch))
        yield x, cam, view, batch


@torch.no_grad()
def do_inference_tta(cfg, model, val_loader, num_query: int):
    """Option A → (rank-1, rank-5): TTA-aggregated query features, plain
    gallery features, through ``R1mAPEvaluator`` (``TEST.RE_RANKING`` and
    ``TEST.CAMERA_FILTER`` as the config says)."""
    logger = logging.getLogger("mpreid_tpu_torch.test_tta")
    logger.info("Enter inferencing with TTA (Option A - Image Feature Evaluation)")
    feat_norm = cfg.TEST.FEAT_NORM == "yes"
    evaluator = R1mAPEvaluator(num_query, feat_norm=feat_norm, reranking=cfg.TEST.RE_RANKING,
                               camera_filter=cfg.TEST.CAMERA_FILTER, device=_device_of(model))
    processed = 0
    for x, cam, view, batch in _batches(cfg, model, val_loader):
        n = batch["count"]
        # rows [0, boundary) are queries, the rest gallery
        boundary = int(np.clip(num_query - processed, 0, n))
        if boundary > 0:
            agg, plain = tta_aggregate(lambda v: model.forward_eval(v, cam, view), x)
            rows = torch.arange(agg.shape[0], device=agg.device)[:, None]
            feat = torch.where(rows < boundary, agg, plain)
        else:
            feat = model.forward_eval(x, cam, view)
        if feat_norm:
            feat = _l2(feat)
        evaluator.update((feat[:n], batch["pids"][:n], batch["camids"][:n]))
        processed += n
    cmc, mAP, *_ = evaluator.compute()
    logger.info("Validation Results (TTA Option A - Image Features)")
    logger.info("mAP: {:.1%}".format(mAP))
    return log_and_return_ranks(logger, cmc)


def log_and_return_ranks(logger, cmc) -> Tuple[float, float]:
    """Log rank-1/5/10 and return (rank-1, rank-5). ``cmc`` has
    min(max_rank, gallery size) entries: for a gallery of fewer than 5,
    rank-5 is the last rank there is."""
    cmc = np.asarray(cmc)
    for r in (1, 5, 10):
        if r <= len(cmc):
            logger.info("CMC curve, Rank-{:<3}:{:.1%}".format(r, cmc[r - 1]))
    r5 = cmc[4] if len(cmc) > 4 else cmc[-1]
    return float(cmc[0]), float(r5)


@contextlib.contextmanager
def _no_parameter_grads(model):
    """No gradient for any parameter of ``model`` inside; the flags are
    restored after."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


@torch.no_grad()
def ttpt_query_input(model, cfg, x: torch.Tensor, cam=None, view=None) -> torch.Tensor:
    """The tuner's input for a preprocessed batch: the last
    ``in_planes_proj`` columns of the eval features, averaged with the
    h-flip's under ``TEST.TTA_ENABLED``, L2-normalised under
    ``TEST.FEAT_NORM``, fp32 (made under ``no_grad``, not ``inference_mode``:
    the tuner's autograd saves it)."""
    dim = model.in_planes_proj
    views = [x, x.flip(2)] if cfg.TEST.TTA_ENABLED else [x]
    agg = torch.stack([model.forward_eval(v, cam, view)[:, -dim:] for v in views]).mean(dim=0)
    if cfg.TEST.FEAT_NORM == "yes":
        agg = _l2(agg)
    return agg.float()


def make_ttpt_tuner(model, cfg):
    """→ ``tune(img_feat_agg) → (tuned query features, entropy trace, sim)``.

    ``img_feat_agg`` is the (B, embed_dim) fp32 query image features. Each
    of ``TEST.TTPT.STEPS`` steps takes the text features of every class
    with the current context, the mean entropy of softmax(agg · textᵀ / T)
    and its gradient with respect to the context, and an AdamW update in
    the JAX package's form (ctx − lr·(m̂/(√v̂ + eps) + wd·ctx)). The trace
    holds the entropy before each update. The class of each query is the
    argmax of ``sim``, the last step's (B, num_classes) similarities
    (before its update; the initial context's with no steps), and its
    feature is that class's L2-normalised text feature with the final
    context."""
    lr, steps, temp = cfg.TEST.TTPT.LR, cfg.TEST.TTPT.STEPS, cfg.TEST.TTPT.TEMPERATURE
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 1e-2  # torch AdamW's defaults
    ctx0 = model.prompt_learner.ctx_generic
    labels = torch.arange(ctx0.shape[0], device=ctx0.device)

    def text_all(ctx):
        return model.get_text(labels, None, "2", ctx_generic=ctx)

    def entropy_and_sim(ctx, agg):
        tf = text_all(ctx)
        sim = torch.matmul(agg, tf.float().t())
        probs = torch.softmax(sim / temp, dim=-1)
        ent = -torch.sum(probs * torch.log(probs + 1e-9), dim=-1)
        return ent.mean(), sim, tf

    def tune(img_feat_agg: torch.Tensor):
        agg = img_feat_agg.float()
        ctx = ctx0.detach().clone()
        m, v = torch.zeros_like(ctx), torch.zeros_like(ctx)
        trace, sim = [], None
        with torch.enable_grad(), _no_parameter_grads(model):
            for i in range(steps):
                ctx.requires_grad_(True)
                loss, sim, _ = entropy_and_sim(ctx, agg)
                (g,) = torch.autograd.grad(loss, ctx)
                with torch.no_grad():
                    m = b1 * m + (1 - b1) * g
                    v = b2 * v + (1 - b2) * torch.square(g)
                    t = float(i + 1)
                    mh = m / (1 - b1 ** t)
                    vh = v / (1 - b2 ** t)
                    ctx = ctx - lr * (mh / (torch.sqrt(vh) + eps) + wd * ctx)
                trace.append(loss.detach())
                sim = sim.detach()
        with torch.no_grad():
            if steps == 0:
                _, sim, final_tf = entropy_and_sim(ctx, agg)
            else:
                final_tf = text_all(ctx)
            best = torch.argmax(sim, dim=1)
            trace = torch.stack(trace) if trace else sim.new_zeros(0)
            return _l2(final_tf)[best], trace, sim

    return tune


def do_inference_ttpt(cfg, model, val_loader, num_query: int):
    """Option B → (rank-1, rank-5); Option A when ``TEST.TTPT.ENABLED`` is off.

    Query rows: ``ttpt_query_input`` of the batch, tuned (the whole batch,
    as JAX tunes it); gallery rows: the projected part of the plain
    features, normalised likewise; distance 1 − qf · gfᵀ in fp32."""
    if not cfg.TEST.TTPT.ENABLED:
        return do_inference_tta(cfg, model, val_loader, num_query)

    logger = logging.getLogger("mpreid_tpu_torch.test_ttpt")
    logger.info("Enter inferencing with TTA, TTPT (CLIP-style Evaluation - Option B)")
    logger.info(f"TTPT enabled: LR={cfg.TEST.TTPT.LR}, Steps={cfg.TEST.TTPT.STEPS}, "
                f"Temp={cfg.TEST.TTPT.TEMPERATURE}")
    feat_norm = cfg.TEST.FEAT_NORM == "yes"
    feat_dim = model.in_planes_proj
    tuner = make_ttpt_tuner(model, cfg)

    qf, q_pids, q_camids = [], [], []
    gf, g_pids, g_camids = [], [], []
    processed = 0
    for x, cam, view, batch in _batches(cfg, model, val_loader):
        n = batch["count"]
        boundary = int(np.clip(num_query - processed, 0, n))
        if boundary < n:
            with torch.no_grad():
                feat = model.forward_eval(x, cam, view)
            if feat_norm:
                feat = _l2(feat)
            gf.append(feat[boundary:n])
            g_pids.extend(batch["pids"][boundary:n])
            g_camids.extend(batch["camids"][boundary:n])
        if boundary > 0:
            query_feat, ent, _ = tuner(ttpt_query_input(model, cfg, x, cam, view))
            if len(ent) and logger.isEnabledFor(logging.INFO):
                ent_np = ent.cpu().numpy()  # one transfer
                logger.info("TTPT entropy: %.4f -> %.4f over %d steps",
                            ent_np[0], ent_np[-1], len(ent_np))
            qf.append(query_feat[:boundary])
            q_pids.extend(batch["pids"][:boundary])
            q_camids.extend(batch["camids"][:boundary])
        processed += n

    qf = torch.cat(qf)
    gf_proj = torch.cat(gf)[:, -feat_dim:]
    if feat_norm:
        gf_proj = _l2(gf_proj)
    distmat = 1.0 - torch.matmul(qf.float(), gf_proj.float().t())

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=distmat.device)

    cmc, mAP = cmc_map(distmat, dev(q_pids), dev(g_pids), dev(q_camids), dev(g_camids),
                       camera_filter=True)
    logger.info("Validation Results (TTPT CLIP-style)")
    logger.info("mAP: {:.1%}".format(float(mAP)))
    return log_and_return_ranks(logger, cmc.cpu().numpy())
