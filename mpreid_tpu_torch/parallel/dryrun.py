"""The port's multi-rank dry run: one step of every parallel mode at once.

ref __graft_entry__.py::dryrun_multichip, ::_flagship. ``dryrun_multichip(world)``
starts ``world`` ranks (``launch.spawn``; gloo, so ranks may share one card)
and runs the JAX package's three phases at its tiny shapes:

1. one Uni-Prompt stage-2 train step of the tiny MoE flagship on a
   ``(world/2) × 2`` mesh: data parallelism over ``data``; the classifiers,
   the MoE experts and, under ``TPU.TP_TOWERS``, the towers sliced over
   ``model`` (``mesh.shard_module``); the optimizer's replicated moments
   ZeRO-1-sharded over ``data``. It asserts a finite loss, that ZeRO
   sharded some moments and that the towers' ``in_proj`` moments keep the
   tensor-parallel layout (whole over ``data``, sliced over ``model``);
2. the updated model's features: gallery-sharded CMC/mAP against the dense
   evaluator's; the dense re-ranking of features gathered from the data
   axis's blocks against that of the whole features (its L1 step on the
   hand-written kernel on the card); and the gallery-sharded sparse
   re-ranking (``ops/reranking_sparse.py::re_ranking_sparse_sharded``, its
   min-sum on the kernel) against the one-rank sparse result and the dense one;
3. a 2-stage GPipe (``pipeline.pipelined_blocks``) over the trained text
   blocks, causal mask, against sequential application.

Each phase prints the JAX package's OK line from rank 0. The tiny towers are
128 wide (two heads of 64) where the JAX package's are 64 wide with one head:
GSPMD splits a single head across devices, the port keeps whole heads per
rank, and the attention kernel takes head widths of 64 and 128. The ranks
run on ``device`` ("cuda" by default: every rank on the one card, or on
``cuda:LOCAL_RANK`` under torchrun; the tests ask for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

NUM_CLASSES = 32
TINY = dict(vision_layers=2, vision_width=128, embed_dim=32, transformer_width=128,
            transformer_heads=2, transformer_layers=2, h_resolution=2, w_resolution=1)
SPARSE_KW = dict(k1=20, k2=6, block=32, g_chunk=16, width=256, width2=1024)


def flagship_cfg():
    """The tiny flagship's config (ref ``_flagship(tiny=True, moe=True)``)."""
    from mpreid_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.DATALOADER.SAMPLER = "softmax_triplet"
    cfg.MODEL.ID_LOSS_WEIGHT = 0.25
    cfg.INPUT.SIZE_TRAIN = [32, 16]
    cfg.INPUT.SIZE_TEST = [32, 16]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.MOE.ENABLED = True
    cfg.MODEL.MOE.NUM_EXPERTS = 4
    cfg.MODEL.MOE.TOP_K = 2
    cfg.MODEL.MOE.MOE_LAYERS = 1
    return cfg


def flagship_model(cfg, device, seed: int = 0):
    """The tiny MoE Uni-Prompt model, seeded, on ``device``."""
    from mpreid_tpu_torch.models import VIT_B16, UniPromptReID

    moe = cfg.MODEL.MOE
    clip = dataclasses.replace(VIT_B16, **TINY, num_experts=moe.NUM_EXPERTS, top_k=moe.TOP_K,
                               moe_layers=moe.MOE_LAYERS)
    model = UniPromptReID(clip, NUM_CLASSES, camera_num=14, view_num=1)
    model.init_(torch.Generator().manual_seed(seed))
    return model.to(device)


def _rank_device(device: str) -> torch.device:
    """``device`` for this rank: a CUDA device without an index is
    ``cuda:LOCAL_RANK`` under torchrun, else the current card (ranks that
    ``launch.spawn`` started share it)."""
    from .dist import rank_device

    dev = rank_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _dryrun_rank(world: int, device: str) -> dict:
    from mpreid_tpu_torch.engine import initial_state, make_train_step
    from mpreid_tpu_torch.losses import make_loss
    from mpreid_tpu_torch.models.layers import ResidualAttentionBlock
    from mpreid_tpu_torch.models.text import causal_mask
    from mpreid_tpu_torch.ops import cmc_map, euclidean_squared_distmat, re_ranking
    from mpreid_tpu_torch.ops.reranking_sparse import re_ranking_sparse, re_ranking_sparse_sharded
    from mpreid_tpu_torch.solver import make_optimizer

    from . import collectives as C
    from .dist import is_main
    from .mesh import full_state_dict, make_mesh, shard_batch, shard_module
    from .pipeline import pipe_mesh, pipelined_blocks
    from .sharded_eval import sharded_cmc_map
    from .zero import zero_sharded

    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    lines = []
    model_axis = 2 if world % 2 == 0 else 1
    mesh = make_mesh(data=world // model_axis, model=model_axis)
    cfg = flagship_cfg()
    model = flagship_model(cfg, dev)
    batch = mesh.data * 4
    loss_fn, _ = make_loss(cfg, NUM_CLASSES)
    shard_module(model, mesh, tp_towers=True)
    optimizer = zero_sharded(make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a"), mesh,
                             model, tp_towers=True)
    text_features = torch.zeros((NUM_CLASSES, model.clip_config.embed_dim), device=dev)
    step = make_train_step(model, cfg, loss_fn, optimizer, uniprompt=True,
                           text_features=text_features, mesh=mesh)
    state = initial_state(model, optimizer)
    rng = np.random.RandomState(0)
    batch_np = {
        "images": rng.randint(0, 255, (batch, 32, 16, 3), dtype=np.uint8),
        "pids": (np.arange(batch) % NUM_CLASSES).astype(np.int32),
        "camids": (np.arange(batch) % 14).astype(np.int32),
        "trackids": (np.arange(batch) % 14).astype(np.int32),
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    state, metrics = step(state, shard_batch(batch_np, mesh), 1e-3, gen)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    mu = state.opt_state.mu
    assert optimizer.zero_keys and all(mu[k].dim() == 1 for k in optimizer.zero_keys), \
        "ZeRO moments not sharded"
    params = dict(model.named_parameters())
    tp_mu = [k for k in mu if k.endswith("in_proj_weight")]
    assert tp_mu and all(k not in optimizer.zero_keys and mu[k].shape == params[k].shape
                         and hasattr(params[k], "model_split") for k in tp_mu), \
        f"TP tower moments not model-sharded: {tp_mu}"
    lines.append(f"dryrun_multichip OK: mesh=({mesh.data}x{mesh.model}) "
                 f"dp+tp(towers)+ep+zero1 step loss={loss:.4f}")

    # ---- phase 2: eval on the same mesh -----------------------------------
    model.eval()
    with torch.no_grad():
        images = torch.from_numpy(batch_np["images"]).to(dev).float() / 255.0
        qf = model.forward_eval(images).float()
    reps = 4
    rng2 = np.random.RandomState(1)
    qf_np = qf.cpu().numpy()
    gf_np = (np.tile(qf_np, (reps, 1))
             + 0.05 * rng2.randn(reps * qf_np.shape[0], qf_np.shape[1])).astype(np.float32)
    g_pids = np.tile(batch_np["pids"], reps)
    g_camids = (np.tile(batch_np["camids"], reps)
                + np.repeat(np.arange(reps, dtype=np.int32), batch)) % 14
    gf = torch.from_numpy(gf_np).to(dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    per = len(g_pids) // mesh.data
    block = slice(mesh.rank * per, (mesh.rank + 1) * per)
    dense = euclidean_squared_distmat(qf, gf)
    for camera_filter in (False, True):
        cmc_d, map_d = cmc_map(dense, t(batch_np["pids"]), t(g_pids), t(batch_np["camids"]),
                               t(g_camids), max_rank=10, camera_filter=camera_filter)
        cmc_s, map_s = sharded_cmc_map(qf, gf[block], t(batch_np["pids"]), t(g_pids[block]),
                                       t(batch_np["camids"]), t(g_camids[block]), mesh,
                                       max_rank=10, camera_filter=camera_filter)
        np.testing.assert_allclose(cmc_s.cpu().numpy(), cmc_d.cpu().numpy(), atol=1e-5)
        assert abs(float(map_s) - float(map_d)) < 1e-5, (float(map_s), float(map_d))

    d_dense = re_ranking(qf, gf, k1=20, k2=6)
    q_per = qf.shape[0] // mesh.data
    qs = C.all_gather(qf[mesh.rank * q_per:(mesh.rank + 1) * q_per].contiguous(), mesh.group)
    gs = C.all_gather(gf[block].contiguous(), mesh.group)
    d_shard = re_ranking(qs, gs, k1=20, k2=6)
    np.testing.assert_allclose(d_dense.cpu().numpy(), d_shard.cpu().numpy(), atol=1e-4)
    d_sp = re_ranking_sparse(qf, gf, **SPARSE_KW)
    d_sps = re_ranking_sparse_sharded(qf, gf, mesh, **SPARSE_KW)
    np.testing.assert_allclose(d_sps.cpu().numpy(), d_sp.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(d_sps.cpu().numpy(), d_dense.cpu().numpy(), atol=1e-3)
    lines.append(f"dryrun_multichip eval OK: sharded CMC/mAP == dense "
                 f"(rank1={float(cmc_s[0]):.4f} mAP={float(map_s):.4f}), sharded re-ranking == "
                 "dense, sharded SPARSE re-ranking == sparse == dense")

    # ---- phase 3: GPipe over the trained text blocks ---------------------
    ccfg = model.clip_config
    text = {k[len("text_encoder.transformer."):]: v for k, v in full_state_dict(model).items()
            if k.startswith("text_encoder.transformer.resblocks.")}
    n_stages = min(2, world, ccfg.transformer_layers)
    pipe = pipe_mesh(n_stages)
    blk = ResidualAttentionBlock(ccfg.transformer_width, ccfg.transformer_heads).to(dev)
    seq_len = 8
    xseq = torch.from_numpy(np.random.RandomState(2).randn(
        batch, seq_len, ccfg.transformer_width).astype(np.float32)).to(dev)
    mask = causal_mask(seq_len, dev)
    with torch.no_grad():
        y_pp = pipelined_blocks(blk, text, ccfg.transformer_layers, xseq, pipe,
                                microbatches=4, mask=mask)
        h = xseq
        for i in range(ccfg.transformer_layers):
            blk.load_state_dict({k[len(f"resblocks.{i}."):]: v for k, v in text.items()
                                 if k.startswith(f"resblocks.{i}.")})
            h = blk(h, mask)
    np.testing.assert_allclose(y_pp.cpu().numpy(), h.cpu().numpy(), rtol=2e-6, atol=2e-6)
    lines.append(f"dryrun_multichip PP OK: {n_stages}-stage GPipe over the text blocks "
                 "== sequential")
    return {"rank": mesh.rank, "model_rank": mesh.model_rank, "loss": loss,
            "lines": lines if is_main() else [], "launches": _launch_counts()}


def _launch_counts() -> dict:
    """This rank's kernel launches so far, by wrapper."""
    from mpreid_tpu_torch.ops.adam import fused_adam_leaf
    from mpreid_tpu_torch.ops.attention import fused_attention, fused_attention_bwd
    from mpreid_tpu_torch.ops.pairwise import l1_cross, minsum_cross

    return {"attention_fwd": dict(fused_attention.launches_by_route),
            "attention_bwd": dict(fused_attention_bwd.launches_by_route),
            "adam": fused_adam_leaf.launches, "l1_cross": l1_cross.launches,
            "minsum_cross": minsum_cross.launches}


def dryrun_multichip(world: int, device: str = "cuda", timeout: float = 600.0,
                     threads: Optional[int] = None) -> list:
    """The three phases over ``world`` gloo ranks → every rank's results
    (loss, kernel launches), rank 0's OK lines printed here."""
    from .launch import spawn

    results = spawn(_dryrun_rank, world, (world, device), timeout=timeout, threads=threads)
    for line in results[0]["lines"]:
        print(line)
    return results
