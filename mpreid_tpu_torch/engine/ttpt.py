"""Test-time augmentation and test-time prompt tuning eval modes.

ref mpreid_tpu/engine/ttpt.py::tta_views, ::tta_aggregate, ::do_inference_tta,
::_log_and_return_ranks, ::_eval_feature_step_cached, ::_tta_query_step,
::_make_ttpt_tuner_cached, ::do_inference_ttpt (reference
``processor_uniprompt_stage2.py:269-693``, against the current
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

Both run through four compiled steps (``steps.model_step`` over
``engine/compiled.py::CompiledStep``: two eager calls a key, a CUDA graph
captured at the third, replays after it), kept on the model across calls
as the JAX package's ``lru_cache``s keep its jitted programs
(``processor.cached_step``, released by ``release_eval_steps``):

- the TTA query step (``make_tta_query_step``, ref ``_tta_query_step``):
  the four view forwards, their mean, ``where(row < boundary, mean,
  plain)`` and the norm under ``TEST.FEAT_NORM``; ``boundary`` is an input
  tensor, so a batch that straddles the split replays the same graph;
- the plain features with the norm fused (``processor.cached_eval_step(
  model, cfg, feat_norm)``, ref ``_eval_feature_step_cached``): the
  gallery-only batches and the gallery rows;
- the TTPT query input (``make_ttpt_query_step``, ref ``do_inference_ttpt``
  ``:284-291``): the projected features of the plain and, under
  ``TEST.TTA_ENABLED``, the h-flipped view, their mean, the norm, fp32;
- the tuner (``make_ttpt_tuner``, ref ``_make_ttpt_tuner_cached``): every
  tuning step unrolled in one body, then the final text forward, the
  argmax and the gather.

Each body takes the uint8 batch and preprocesses it on the device. The
tuner never writes into the model: the tuned context is a tensor of its
own, passed to ``get_text`` as ``ctx_generic``, and differentiated with
``torch.autograd.grad``; the model's parameters take no gradient while it
runs (their ``requires_grad`` flags are restored after). Its graph holds
the text tower's forward and backward over every class, so its memory pool
holds about the eager tuner's peak for as long as the step is kept.
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
from .processor import cached_eval_step, cached_step, eval_key
from .steps import _device_of, labels_for, model_step


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


def _batch_inputs(cfg, batch) -> tuple:
    return (batch["images"], *labels_for(cfg, batch))


def _make_tta_query_body(model_of: Callable, cfg):
    """The TTA query step's body (ref ``_tta_query_step``): ``body(images,
    cam, view, boundary)`` → (features,), under ``inference_mode``: rows
    below ``boundary`` (a 0-dim int64 tensor) the mean over the four views,
    the rest the plain view's, L2-normalised under ``TEST.FEAT_NORM``."""
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    feat_norm = cfg.TEST.FEAT_NORM == "yes"

    @torch.inference_mode()
    def body(images, cam, view, boundary):
        model = model_of()
        x = eval_preprocess(images, mean=mean, std=std)
        agg, plain = tta_aggregate(lambda v: model.forward_eval(v, cam, view), x)
        rows = torch.arange(agg.shape[0], device=agg.device)[:, None]
        feat = torch.where(rows < boundary, agg, plain)
        return (_l2(feat) if feat_norm else feat,)

    return body


def make_tta_query_step(model, cfg, weak: bool = False):
    """→ ``step(batch, boundary)``: the features of a numpy batch whose rows
    below ``boundary`` are queries (``_make_tta_query_body``)."""
    return model_step(model, lambda model_of: _make_tta_query_body(model_of, cfg),
                      lambda batch, boundary: (*_batch_inputs(cfg, batch), np.int64(boundary)),
                      "TTA query step", weak, one=True)


def cached_tta_query_step(model, cfg):
    """``make_tta_query_step`` kept on the model (ref ``_tta_query_step``'s
    cache: the model and the norm, with the eval step's key)."""
    return cached_step(model, ("tta_query", *eval_key(cfg), cfg.TEST.FEAT_NORM == "yes"),
                       lambda: make_tta_query_step(model, cfg, weak=True))


def _make_ttpt_query_body(model_of: Callable, cfg):
    """The TTPT query input's body (ref ``do_inference_ttpt`` ``:284-291``):
    ``body(images, cam, view)`` → (the last ``in_planes_proj`` columns of the
    eval features, averaged with the h-flip's under ``TEST.TTA_ENABLED``,
    L2-normalised under ``TEST.FEAT_NORM``, fp32,). Under ``no_grad``, not
    ``inference_mode``: the tuner's autograd saves it."""
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    tta, feat_norm = cfg.TEST.TTA_ENABLED, cfg.TEST.FEAT_NORM == "yes"

    @torch.no_grad()
    def body(images, cam, view):
        model = model_of()
        x = eval_preprocess(images, mean=mean, std=std)
        dim = model.in_planes_proj
        views = [x, x.flip(2)] if tta else [x]
        agg = torch.stack([model.forward_eval(v, cam, view)[:, -dim:] for v in views]).mean(dim=0)
        return ((_l2(agg) if feat_norm else agg).float(),)

    return body


def make_ttpt_query_step(model, cfg, weak: bool = False):
    """→ ``step(batch)``: the tuner's input for a numpy batch
    (``_make_ttpt_query_body``), an ordinary tensor."""
    return model_step(model, lambda model_of: _make_ttpt_query_body(model_of, cfg),
                      lambda batch: _batch_inputs(cfg, batch), "TTPT query step", weak, one=True)


def cached_ttpt_query_step(model, cfg):
    """``make_ttpt_query_step`` kept on the model: the eval step's key, the
    norm and ``TEST.TTA_ENABLED``."""
    return cached_step(model, ("ttpt_query", *eval_key(cfg), cfg.TEST.FEAT_NORM == "yes",
                               cfg.TEST.TTA_ENABLED),
                       lambda: make_ttpt_query_step(model, cfg, weak=True))


def ttpt_query_input(model, cfg, batch) -> torch.Tensor:
    """The tuner's input for a numpy batch, as ``do_inference_ttpt`` makes it
    (``cached_ttpt_query_step``)."""
    return cached_ttpt_query_step(model, cfg)(batch)


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


def _bias_corrections(b: float, steps: int) -> torch.Tensor:
    """(steps,) fp32 CPU tensor of 1 − b^t for t = 1..steps as the JAX tuner
    forms them: fp32 ``b`` raised to an fp32 ``t``, subtracted in fp32 (in
    double 1 − 0.999^t lies up to 2e-5 relative above: fp32 cancels)."""
    base = torch.tensor(b, dtype=torch.float32)
    return torch.tensor([(1 - torch.pow(base, torch.tensor(float(t)))).item()
                         for t in range(1, steps + 1)], dtype=torch.float32)


def _make_tuner_body(model_of: Callable, cfg):
    """The tuner's body (ref ``_make_ttpt_tuner_cached``'s ``tune``):
    ``body(img_feat_agg)`` → (tuned query features, entropy trace, sim).

    ``img_feat_agg`` is the (B, embed_dim) fp32 query image features. Each
    of ``TEST.TTPT.STEPS`` steps (unrolled: on the card they are one graph)
    takes the text features of every class with the current context, the
    mean entropy of softmax(agg · textᵀ / T) and its gradient with respect
    to the context, and an AdamW update in the JAX package's form (ctx −
    lr·(m̂/(√v̂ + eps) + wd·ctx), the bias corrections fp32 constants,
    ``_bias_corrections``, copied to the model's device by the first call
    (before any capture) so that m and v are divided by a tensor: torch's
    CUDA division by a Python number multiplies by its reciprocal). The trace
    holds the entropy before each update. The class of each query is the
    argmax of ``sim``, the last step's (B, num_classes) similarities (before
    its update; the initial context's with no steps), and its feature is
    that class's L2-normalised text feature with the final context."""
    lr, steps, temp = cfg.TEST.TTPT.LR, cfg.TEST.TTPT.STEPS, cfg.TEST.TTPT.TEMPERATURE
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 1e-2  # torch AdamW's defaults
    corrections = torch.stack([_bias_corrections(b1, steps), _bias_corrections(b2, steps)])
    on_device = {}

    def body(img_feat_agg: torch.Tensor):
        model = model_of()
        ctx0 = model.prompt_learner.ctx_generic
        if ctx0.device not in on_device:
            on_device[ctx0.device] = corrections.to(ctx0.device)
        bc1, bc2 = on_device[ctx0.device]
        labels = torch.arange(ctx0.shape[0], device=ctx0.device)

        def text_all(ctx):
            return model.get_text(labels, None, "2", ctx_generic=ctx)

        def entropy_and_sim(ctx, agg):
            tf = text_all(ctx)
            sim = torch.matmul(agg, tf.float().t())
            probs = torch.softmax(sim / temp, dim=-1)
            ent = -torch.sum(probs * torch.log(probs + 1e-9), dim=-1)
            return ent.mean(), sim, tf

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
                    mh = m / bc1[i]
                    vh = v / bc2[i]
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

    return body


def make_ttpt_tuner(model, cfg, weak: bool = False):
    """→ ``tune(img_feat_agg) → (tuned query features, entropy trace, sim)``
    (``_make_tuner_body``) on a (B, embed_dim) fp32 tensor of the model's
    device. On the card the graph binds every parameter and buffer: a reload
    of the weights into new storage is a new key, captured anew."""
    return model_step(model, lambda model_of: _make_tuner_body(model_of, cfg),
                      lambda agg: (agg,), "TTPT tuner", weak)


def cached_ttpt_tuner(model, cfg):
    """``make_ttpt_tuner`` kept on the model (ref ``_make_ttpt_tuner_cached``'s
    key: the class count, ``TEST.TTPT.LR``, ``STEPS`` and ``TEMPERATURE``, with
    the eval step's key)."""
    return cached_step(model, ("ttpt_tuner", *eval_key(cfg),
                               model.prompt_learner.ctx_generic.shape[0],
                               cfg.TEST.TTPT.LR, cfg.TEST.TTPT.STEPS,
                               cfg.TEST.TTPT.TEMPERATURE),
                       lambda: make_ttpt_tuner(model, cfg, weak=True))


@torch.no_grad()
def do_inference_tta(cfg, model, val_loader, num_query: int):
    """Option A → (rank-1, rank-5): TTA-aggregated query features, plain
    gallery features, through ``R1mAPEvaluator`` (``TEST.RE_RANKING`` and
    ``TEST.CAMERA_FILTER`` as the config says). A batch with query rows
    goes through the TTA query step, a gallery-only one through the plain
    step with the norm fused."""
    logger = logging.getLogger("mpreid_tpu_torch.test_tta")
    logger.info("Enter inferencing with TTA (Option A - Image Feature Evaluation)")
    feat_norm = cfg.TEST.FEAT_NORM == "yes"
    evaluator = R1mAPEvaluator(num_query, feat_norm=feat_norm, reranking=cfg.TEST.RE_RANKING,
                               camera_filter=cfg.TEST.CAMERA_FILTER, device=_device_of(model))
    plain_step = cached_eval_step(model, cfg, feat_norm=feat_norm)
    query_step = cached_tta_query_step(model, cfg)
    processed = 0
    for batch in val_loader.iter_sequential():
        n = batch["count"]
        # rows [0, boundary) are queries, the rest gallery
        boundary = int(np.clip(num_query - processed, 0, n))
        feat = query_step(batch, boundary) if boundary > 0 else plain_step(batch)
        evaluator.update((feat[:n], batch["pids"][:n], batch["camids"][:n]))
        processed += n
    cmc, mAP, *_ = evaluator.compute()
    logger.info("Validation Results (TTA Option A - Image Features)")
    logger.info("mAP: {:.1%}".format(mAP))
    return log_and_return_ranks(logger, cmc)


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
    plain_step = cached_eval_step(model, cfg, feat_norm=feat_norm)
    query_step = cached_ttpt_query_step(model, cfg)
    tuner = cached_ttpt_tuner(model, cfg)

    qf, q_pids, q_camids = [], [], []
    gf, g_pids, g_camids = [], [], []
    processed = 0
    for batch in val_loader.iter_sequential():
        n = batch["count"]
        boundary = int(np.clip(num_query - processed, 0, n))
        if boundary < n:
            gf.append(plain_step(batch)[boundary:n])
            g_pids.extend(batch["pids"][boundary:n])
            g_camids.extend(batch["camids"][boundary:n])
        if boundary > 0:
            query_feat, ent, _ = tuner(query_step(batch))
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
