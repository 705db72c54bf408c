"""Smoke run of the PyTorch port (mpreid_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the exit code is not 0:

1. the card's name and power limit, torch and CUDA versions (no card: fail);
2. build every CUDA kernel from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main paths, with the stated tolerance, and its times: the kernel,
   the plain version, one library call computing the same function, and the
   bound (the least time the card could take for the same work): the
   attention forward and backward (bf16 on the tensor-core kernels at the
   vision, text and 256×256 vehicle shapes, fp32 on the CUDA-core kernels
   at the vision shape and, for the backward that once refused them, at L
   163 (configs/cross/sysu_rgb2ir.yml) and L 257, both layouts; the ptxas
   report of the tensor-core sources, which must show no spills at dh 64)
   and the Adam leaf update (a c_fc leaf, fp32/bf16 moments, Adam/AdamW);
4. the baseline eval path (ViT-B/16, 256×128, bf16, batch 64) at full width
   on seeded random weights through ``engine.processor.do_inference``,
   counting the forward kernel's launches in that run;
5. the baseline training path (configs/person/vit_base.yml's settings:
   ViT-B/16 with 751 classes, 256×128, bf16 over fp32 parameters, PK batches
   of 16 × 4, augmentation on, Adam) through ``engine.steps.make_train_step``:
   a warm-up step, then timed steps, counting the attention kernels'
   launches; one short epoch through ``engine.processor.do_train`` over a
   ``TrainLoader``; then steps with ``SOLVER.FUSED_ADAM`` on, counting the
   Adam kernel's launches, and one fused update against the plain one; then
   three train steps of configs/veri/vit_base.yml (ViT-B/16 at 256×256, L
   257, 576 classes), whose attention backward the CUDA-core kernel refused;
6. cross-checks: eval features and a train step's loss and gradients in
   fp32 on the card against fp32 on the CPU, and bf16 against fp32 on the
   card;
7. the re-ranking slice (``TEST.RE_RANKING``): the eval path of phase 4
   through ``do_inference`` with re-ranking (one L1 kernel launch), its
   distance matrix against the same features re-ranked on the CPU; the
   dense route at Market-1501 scale (3,368 × 15,913, 1280-d seeded
   clustered features) through ``R1mAPEvaluator``, exact and quantized; the
   sparse-V route at MSMT17 scale (11,659 × 82,161) with the quantized
   min-sum, then 256 query rows recomputed exactly by
   ``re_ranking_sparse_rows`` (21 min-sum kernel launches) as its oracle;
8. the Uni-Prompt slice (configs/ours/cctv_ir_cctv_rgb.yml's settings:
   ViT-B/16 + the 12 × 512 text tower, 1,000 classes, bf16 over fp32, batch
   64, seeded uint8 images with view labels over 0-14): the stage-1 bank
   over 4,096 images, one stage-1a and one stage-1b epoch (64 steps each,
   12 attention forward and 12 backward launches per step at the text
   shape) through ``do_train_stage1``, the stage-2 text features of every
   class, 24 timed stage-2a steps (PK 16 × 4, augmentation and the i2t term
   on), one 12-step stage-2b epoch through ``do_train_stage2`` and
   ``do_inference``; then ``batch_hard_triplet_loss`` on the feats[1] of a
   stage-2a forward against ``losses/triplet.py``, margin and soft margin;
   then one stage-1b and one stage-2a step at batch 8 in fp32 on the card
   against the CPU (loss, every gradient, parameters after the step), and
   bf16 against fp32 on text and eval features;
9. CLIP weights from a local file and the RN50 backbone, from seeded
   OpenAI-layout files (fp16, as OpenAI ships them; written to a temporary
   directory, since the real files are not in the repository): a ViT-B/16
   file (14×14+1 positions) as a plain state_dict and as a ``torch.jit``
   archive, each through ``load_pretrained`` into configs/person/vit_base.yml's
   model, fp32 eval features on the card against the CPU; then an RN50 file
   (7×7+1 pool grid) through ``MODEL.PRETRAIN_PATH`` into
   configs/person/cnn_base.yml's model (751 classes, 256×128, bf16, batch
   64): ``do_inference`` on 256 images and train steps, eval features and a
   train step's loss and gradients in fp32 on the card against the CPU; into
   configs/person/cnn_clipreid.yml's Uni-Prompt model: the bank over 1,024
   images, 8 stage-1a and 8 stage-1b steps (12 + 12 text-tower attention
   launches a step, on "tc"), the text features of every class, 8 stage-2a
   steps and ``do_inference``; and one stage-2a step of
   configs/veri/cnn_prom.yml at 256×256 (the attention pool at L 257). The
   RN50 rates are printed on lines of their own with the card's name and
   power limit;
10. the MoE Uni-Prompt pipeline, as ``train_uniprompt`` runs
   configs/ours/cctv_ir_cctv_rgb.yml under configs/tpu/uniprompt_tuned.yml
   with bench.py's MoE (4 experts, top-2, 2 MoE layers): phase 8's model
   after stage 1b upcycled by ``switch_to_moe``, its eval features against
   the dense model's (fp32 max abs, bf16 cosine), the all-tie routing at
   step 0 (experts 0 and 1 for every token), one stage-2a and one stage-2b
   epoch through ``do_train_stage2`` over the device-resident train set
   (the aux loss finite, the gates moved, the experts not), 12 + 12
   attention launches a step, and ``do_inference``; then one stage-2b step
   at batch 8 of an MoE model with distinct random experts and gates, fp32
   on the card against the CPU;
11. the device-resident epoch (``TPU.DEVICE_DATASET``) with
   configs/person/vit_base.yml at Market-1501's train size (12,936 seeded
   images, 751 ids, 1.27 GB of uint8 on the card): ``do_train`` for two
   epochs with ``TPU.PROFILE_DIR`` (the second epoch traced; the trace's
   size and the device's idle share in it), 24 steps of the device epoch
   against 24 of the step loop over the same batches from one state and one
   generator state, and both modes' img/s in turns;
12. the TTA / TTPT eval modes (``test_uniprompt``'s branches, through
   ``do_inference_ttpt``) on phase 8's model after stage 2, over 256 + 256
   seeded images at batch 64: Option A (4 vision forwards a query batch),
   then Option B with TTA on and 5 tuning steps a query batch over all
   1,000 classes (the text tower's attention forward and backward at B
   1,000, L 77, causal), with query images/s, seconds per tuned batch, peak
   memory and the entropy trace; then the tuner in fp32 on the card
   against the CPU, on the full-width towers with the classes cut to 64
   and the queries to 16;
13. the margin heads (``MODEL.COS_LAYER``, each of arcface, cosface,
   amsoftmax and circle, the last with ``SOLVER.FUSED_ADAM``) in
   configs/person/vit_base.yml's training path at full width: 4 steps on
   one PK batch, augmentation off, the loss falling, and one fp32 step's
   loss and gradients on the card against the CPU.

Phase 12 runs after phase 8 (on its model) and phase 13 after phase 6.
Phase 3 also holds the attention kernels at the TTPT tuner's text batch
(B 1,000, L 77, 8 × 64, causal, bf16), timed, and the L1 and min-sum
kernels (re-ranking's exact Jaccard step) against their plain versions at
the path's shapes: the Market-1501
dense shape, one MSMT17 query block × gallery chunk, and a ragged dense
case (the plain versions compared and timed on the first 256 query rows at
full G and N), and the batch-hard kernel at the PK batch (64 × 768) in fp32
and bf16, a ragged 60-row batch, a batch with a singleton identity and a
single-identity batch.

The last two lines of standard output are one JSON object with the kernels'
numbers and one with the run's verdict and device. Every bf16 attention
launch of a path must count on the tensor-core route ("tc"). ``--profile`` adds
``torch.profiler`` breakdowns by kernel of three eval batches, of three
train steps and of one re-ranking compute at each scale, and the device's
idle share over one traced ``do_inference`` run, over the traced train
steps, over each traced compute, over three traced stage-1b and three
stage-2a steps and over three traced RN50 train steps.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data.loader import ImageBatcher, ShuffledLoader, TrainLoader
from mpreid_tpu_torch.data.sampler import RandomIdentitySampler
from mpreid_tpu_torch.data.synthetic import make_clip_file
from mpreid_tpu_torch.engine import (
    R1mAPEvaluator, build_device_dataset, build_image_bank, do_inference, do_inference_ttpt,
    do_train, do_train_stage1, do_train_stage2, epoch_perm, initial_state, loss_and_grads,
    make_eval_step, make_stage1_step, make_train_epoch, make_train_step,
    precompute_text_features, stage1_loss_and_grads,
)
from mpreid_tpu_torch.engine.processor import TRACE_FILE
from mpreid_tpu_torch.engine.ttpt import make_ttpt_tuner, ttpt_query_input
from mpreid_tpu_torch.kernels import build
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.losses.triplet import euclidean_dist, triplet_loss
from mpreid_tpu_torch.models import (
    RN50, VIT_B16, build_model, build_model_uniprompt, load_balancing_loss, load_pretrained,
    make_model, make_model_uniprompt, switch_to_moe, topk_routing,
)
from mpreid_tpu_torch.ops import adam
from mpreid_tpu_torch.ops import attention as attn
from mpreid_tpu_torch.ops import batch_hard as bh
from mpreid_tpu_torch.ops import euclidean_squared_distmat, pairwise
from mpreid_tpu_torch.ops.reranking import smallest_k
from mpreid_tpu_torch.ops.reranking_sparse import re_ranking_sparse_rows
from mpreid_tpu_torch.ops.augment import eval_preprocess
from mpreid_tpu_torch.solver import make_optimizer, make_scheduler

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 and bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# fp32 instructions other than the FMA (a min, a subtract, an add) issue at
# one per lane a clock: 132 SMs x 128 lanes x 1.98 GHz (the FMA rate above
# counts each FMA as two operations)
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# backward: relative to max(1, max |plain|); bf16 outputs may land one bf16
# step away after fp32 sums in another order
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# each op rounded on its own in both versions: m and v to 1e-6 relative, p
# to 1e-6 relative plus 1e-3·lr (PyTorch divides by a scalar as a product
# with the reciprocal, so the step may differ in its last bits)
ADAM_RTOL, ADAM_ATOL_LR = 1e-6, 1e-3
C_FC = (3072, 768)

CARD = "cuda"  # the training slice's device
QUERY, GALLERY, BATCH, HW = 128, 128, 64, (256, 128)
RUNS = 10  # timed do_inference runs of the slice
NUM_CLASSES, P_IDS, K_INST = 751, 16, 4
ADAM_LEAVES = 52  # ViT-B/16 ReID leaves of at least MIN_FUSED_SIZE elements
TRAIN_STEPS = 24  # timed train steps
FUSED_STEPS = 12
TRAIN_IDS, TRAIN_IMGS_PER_ID = 64, 8  # in-memory train set (512 images)
CHECK_BATCH = 8  # cross-check batch, 2 ids × 4
GRAD_RTOL = 1e-3  # fp32 card vs CPU, per leaf, norm-relative (floored)
LOSS_RTOL = 1e-4
COSINE_FLOOR = 0.99
VISION = dict(name="vision", b=BATCH, l=129, heads=12, dh=64, masked=False)
TEXT = dict(name="text", b=BATCH, l=77, heads=8, dh=64, masked=True)
VEHICLE = dict(name="vehicle", b=BATCH, l=257, heads=12, dh=64, masked=False)
# configs/cross/sysu_rgb2ir.yml: 288x144 at stride 16, so L 163 (fp32 backward)
SYSU = dict(name="sysu", b=BATCH, l=163, heads=12, dh=64, masked=False)
VEHICLE_HW, VEHICLE_CLASSES, VEHICLE_CAMERAS = (256, 256), 576, 20  # VeRi-776
VEHICLE_STEPS = 3
# re-ranking: Market-1501 (dense route) and MSMT17 (sparse-V route) query and
# gallery sizes, seeded clustered features of the ViT-B/16 eval width
MARKET = dict(q=3368, g=15913, ids=750)
MSMT = dict(q=11659, g=82161, ids=3000)
FEAT_DIM = 1280
K1 = 50
V_NONZEROS = 8 * (K1 + 1)  # nonzeros per V row (the sparse path's width)
MSMT_BLOCK = (2048, 4096)  # the sparse path's query block × gallery chunk
PLAIN_ROWS = 256  # query rows the plain versions are compared and timed on
MARKET_RUNS = 3
ORACLE_ROWS = 256
PAIRWISE_TOL = 1e-5  # relative to max(1, max |plain|): K sums in another order
RERANK_TOL = 1e-4  # card vs CPU re-ranked distances, fp32
# quantized vs exact rows at MSMT17 scale: the metric bars of
# tests/test_reranking_sparse.py:116-117 (one sampled query's rank-1, mAP
# 0.005). Its value bar (0.15 max abs, :102) is reported beside them: the
# quantized min-sum's value error grows with the corpus, in the JAX
# package's route as in the port's, which the CPU tests hold equal.
QUANTIZED_VALUE_BAR = 0.15
QUANTIZED_MAP_DELTA = 0.005
# batch-hard mining: the PK batch of the training paths, feats[1]'s width
HARD = dict(b=BATCH, d=768)
HARD_TOL = 1e-5  # relative to max(1, max |plain|): dot products summed in another order
# the Uni-Prompt slice (configs/ours/cctv_ir_cctv_rgb.yml at full ViT-B/16 width)
UNI_CLASSES = 1000  # bench.py's full-run class count
BANK_IMAGES = 4096  # stage-1 bank: 64 steps of 64 per stage-1 epoch
UNI_VIEWS = 15  # MMMP view labels 0-14: both platforms and both modalities
STAGE2A_STEPS = 24  # timed
STAGE2B_IDS = 192  # do_train_stage2's epoch of stage 2b: 192 ids × 4 = 12 batches
# the device-resident epoch (TPU.DEVICE_DATASET) at Market-1501's train size
MARKET_TRAIN = dict(images=12936, ids=751, cams=6)
EPOCH_CHECK_STEPS = 24  # device epoch against the step loop; and each timed turn
EPOCH_TURNS = 2  # rounds of (epoch, steps, steps, epoch)
# the MoE Uni-Prompt pipeline: bench.py's MoE (4 experts, top-2, 2 MoE layers)
MOE_BENCH = {"ENABLED": True, "NUM_EXPERTS": 4, "TOP_K": 2, "MOE_LAYERS": 2}
MOE_IDS = 384  # the stage-2a and 2b epochs: 384 ids × 4 = 24 batches
MOE_CHECK_CLASSES = 16  # the fp32 card-vs-CPU stage-2b step's classes
UPCYCLE_TOL = 1e-5  # fp32 eval features, upcycled MoE against dense, max abs
# the TTA / TTPT eval modes on the Uni-Prompt model, and the margin heads
TTPT_QUERY, TTPT_GALLERY = 256, 256
TTPT_STEPS = 5  # TEST.TTPT.STEPS's default
# the tuner's text batch: every class at once, causal
TTPT_TEXT = dict(name="ttpt_text", b=UNI_CLASSES, l=77, heads=8, dh=64, masked=True)
TTPT_CHECK_CLASSES, TTPT_CHECK_QUERIES = 64, 16  # the fp32 card-vs-CPU tuner check
TTPT_TRACE_RTOL, TTPT_FEAT_ATOL, TTPT_NEAR_TIE = 1e-4, 1e-3, 1e-3
# where a tuned batch's device time goes, by operator (attention: attention_ms)
TTPT_OP_GROUPS = {"matmul": ["aten::mm", "aten::bmm", "aten::addmm"], "casts": ["aten::copy_"],
                  "softmax": ["softmax"]}
MARGIN_KINDS = ("arcface", "cosface", "amsoftmax", "circle")
MARGIN_STEPS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms of device time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 10 ** 7
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def cuda_ms(fn, runs: int = 30, warmup: int = 3, reps: int = 10) -> float:
    """Median over ``runs`` CUDA-event timings of ``reps`` back-to-back calls
    of ``fn``, per call, after ``warmup`` calls. Each timing starts behind a
    device-side sleep twice as long as the host takes to enqueue the calls,
    so the events time the device's work alone: a kernel shorter than its
    wrapper's host-side cost is not charged that cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep = int(sleep_cycles_per_ms() * (2 * enqueue_ms + 1))
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def attention_bound_ms(b, l, heads, dh, dtype) -> tuple:
    """(ms, bound_by): qkv read once and out written once over the memory
    rate, against QKᵀ and P·V's multiply-adds over the type's peak rate."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * l * 3 * heads * dh * size + b * l * heads * dh * size
    flops = 4 * b * heads * l * l * dh
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


CARD_LINE = ""  # the card's name and power limit, as nvidia-smi gives them


def header() -> None:
    global CARD_LINE
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    log(line)
    CARD_LINE = line
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)} count {torch.cuda.device_count()}")


def check_attention(case: dict, dtype: torch.dtype, layout: str, timed: bool) -> dict:
    dev = torch.device("cuda")
    b, l, heads, dh = case["b"], case["l"], case["heads"], case["dh"]
    gen = torch.Generator(device=dev).manual_seed(1234)
    qkv = torch.randn(b, l, 3 * heads * dh, device=dev, generator=gen).to(dtype)
    mask = (torch.full((l, l), float("-inf"), device=dev).triu(1)
            if case["masked"] else None)
    out = attn.fused_attention(qkv, heads, mask, layout=layout)
    plain = attn.attention_plain(qkv, heads, mask, layout=layout)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    ok = bool(torch.isfinite(out).all().item()) and err <= TOL[dtype]
    row = dict(case=case["name"], dtype=str(dtype).split(".")[-1], layout=layout,
               shape=[b, l, heads, dh], masked=case["masked"], max_abs_err=err,
               tol=TOL[dtype], ok=ok)
    if timed:
        d = heads * dh
        if layout == "packed":
            q, k, v = (t.view(b, l, heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
        else:
            t = qkv.view(b, l, heads, 3 * dh).transpose(1, 2)
            q, k, v = t[..., :dh], t[..., dh:2 * dh], t[..., 2 * dh:]
        row["ms"] = cuda_ms(lambda: attn.fused_attention(qkv, heads, mask, layout=layout))
        row["plain_ms"] = cuda_ms(lambda: attn.attention_plain(qkv, heads, mask, layout=layout))
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        row["bound_ms"], row["bound_by"] = attention_bound_ms(b, l, heads, dh, dtype)
    log(f"  attention {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"attention kernel disagrees with its plain version: {row}")
    return row


def attention_bwd_bound_ms(b, l, heads, dh, dtype) -> tuple:
    """(ms, bound_by): qkv and dO read once and dqkv written once over the
    memory rate, against the five L×L×dh products over the type's peak."""
    size = torch.tensor([], dtype=dtype).element_size()
    d = heads * dh
    nbytes = b * l * (3 * d + d + 3 * d) * size
    flops = 5 * 2 * b * heads * l * l * dh
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_attention_bwd(case: dict, dtype: torch.dtype, layout: str, timed: bool) -> dict:
    dev = torch.device("cuda")
    b, l, heads, dh = case["b"], case["l"], case["heads"], case["dh"]
    gen = torch.Generator(device=dev).manual_seed(4321)
    qkv = torch.randn(b, l, 3 * heads * dh, device=dev, generator=gen).to(dtype)
    do = torch.randn(b, l, heads * dh, device=dev, generator=gen).to(dtype)
    mask = (torch.full((l, l), float("-inf"), device=dev).triu(1)
            if case["masked"] else None)
    got = attn.fused_attention_bwd(qkv, do, heads, mask, layout=layout)
    plain = attn.attention_bwd_plain(qkv, do, heads, mask, layout=layout)
    torch.cuda.synchronize()
    err = (got.float() - plain.float()).abs().max().item()
    scale = max(1.0, plain.float().abs().max().item())
    ok = bool(torch.isfinite(got).all().item()) and err <= BWD_TOL[dtype] * scale
    row = dict(case=case["name"], dtype=str(dtype).split(".")[-1], layout=layout,
               shape=[b, l, heads, dh], masked=case["masked"], max_abs_err=err,
               tol=BWD_TOL[dtype] * scale, ok=ok)
    if timed:
        d = heads * dh
        leaf = qkv.detach().clone().requires_grad_(True)
        if layout == "packed":
            q, k, v = (t.view(b, l, heads, dh).transpose(1, 2) for t in leaf.split(d, dim=-1))
        else:
            t = leaf.view(b, l, heads, 3 * dh).transpose(1, 2)
            q, k, v = t[..., :dh], t[..., dh:2 * dh], t[..., 2 * dh:]
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        dout = do.view(b, l, heads, dh).transpose(1, 2)
        row["ms"] = cuda_ms(lambda: attn.fused_attention_bwd(qkv, do, heads, mask, layout=layout))
        row["plain_ms"] = cuda_ms(
            lambda: attn.attention_bwd_plain(qkv, do, heads, mask, layout=layout))
        row["library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(out, leaf, dout, retain_graph=True))
        row["bound_ms"], row["bound_by"] = attention_bwd_bound_ms(b, l, heads, dh, dtype)
    log(f"  attention_bwd {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"attention backward kernel disagrees with its plain version: {row}")
    return row


def ptxas_report(names=("attention_fwd_tc", "attention_bwd_tc")) -> dict:
    """Registers, spills and static shared memory that ptxas reported for each
    kernel of ``names`` built in this process, by head width; raises where a
    kernel at dh 64 spills."""
    out = {}
    for name in names:
        text = build.LOGS.get(name)
        if text is None:
            out[name] = "built before this process: not reported"
            continue
        kernels, current = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                dh = re.search(r"ILi(\d+)E", m.group(1)).group(1)
                current = kernels.setdefault(f"dh{dh}", {})
                continue
            if current is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                current.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                current["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                current["static_smem_bytes"] = int(m.group(1))
        out[name] = kernels
    log(f"  ptxas {json.dumps(out)}")
    for name, kernels in out.items():
        dh64 = kernels.get("dh64", {}) if isinstance(kernels, dict) else {}
        if dh64.get("spill_stores") or dh64.get("spill_loads"):
            raise AssertionError(f"{name} spills registers at dh 64: {dh64}")
    return out


def adam_bound_ms(n: int, moment_dtype: torch.dtype) -> tuple:
    """(ms, bound_by): p, m, v, g read once and p, m, v written once over the
    memory rate, against ~15 fp32 operations per element."""
    ms = torch.tensor([], dtype=moment_dtype).element_size()
    nbytes = n * (4 + 4 + 2 * ms) + n * (4 + 2 * ms)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 15 * n / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_adam(moment_dtype: torch.dtype, decoupled: bool, timed: bool) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    p = torch.randn(C_FC, device=dev, generator=gen) * 0.03
    g = torch.randn(C_FC, device=dev, generator=gen) * 1e-3
    m = (torch.randn(C_FC, device=dev, generator=gen) * 1e-4).to(moment_dtype)
    v = (torch.rand(C_FC, device=dev, generator=gen) * 1e-7).to(moment_dtype)
    lr, wd, t = 5e-6 * 2, 1e-4, 3
    args = (lr, 1 - 0.9 ** t, 1 - 0.999 ** t, 0.9, 0.999, 1e-8, wd, decoupled)
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    adam.fused_adam_leaf(p, m, v, g, *args)
    adam.adam_leaf_plain(p2, m2, v2, g, *args)
    torch.cuda.synchronize()
    errs = [(x.float() - y.float()).abs().max().item() for x, y in ((p, p2), (m, m2), (v, v2))]
    ok = all((x.float() - y.float()).abs().le(ADAM_RTOL * y.float().abs() + atol).all().item()
             for x, y, atol in ((p, p2, ADAM_ATOL_LR * lr), (m, m2, 0.0), (v, v2, 0.0)))
    row = dict(moment_dtype=str(moment_dtype).split(".")[-1], decoupled=decoupled,
               shape=list(C_FC), max_abs_err=max(errs), max_abs_err_p=errs[0],
               rtol=ADAM_RTOL, atol_p=ADAM_ATOL_LR * lr, ok=ok)
    if timed:
        row["ms"] = cuda_ms(lambda: adam.fused_adam_leaf(p, m, v, g, *args))
        row["plain_ms"] = cuda_ms(lambda: adam.adam_leaf_plain(p2, m2, v2, g, *args))
        leaf = p.clone().requires_grad_(True)
        leaf.grad = g.clone()
        opt = torch.optim.Adam([leaf], lr=lr, weight_decay=wd, fused=True)
        row["library_ms"] = cuda_ms(opt.step)
        row["bound_ms"], row["bound_by"] = adam_bound_ms(p.numel(), moment_dtype)
    log(f"  adam {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"Adam kernel disagrees with its plain version: {row}")
    return row


def sparse_rows(rows: int, n: int, nnz: int, gen: torch.Generator) -> torch.Tensor:
    """(rows, n) fp32 on the card shaped as re-ranking's V: ``nnz`` seeded
    positive entries per row (a repeated index keeps the larger value), each
    row normalised to sum 1."""
    idx = torch.randint(0, n, (rows, nnz), device="cuda", generator=gen)
    val = torch.rand(rows, nnz, device="cuda", generator=gen)
    v = torch.zeros(rows, n, device="cuda").scatter_reduce_(1, idx, val, reduce="amax")
    return v / v.sum(dim=1, keepdim=True)


def pairwise_bound_ms(q: int, g: int, n: int) -> tuple:
    """(ms, bound_by): both inputs read once and the (Q, G) output written
    once over the memory rate, against two fp32 instructions per element
    pair (a subtract and an add of the absolute value, or a min and an add)
    at one instruction per lane a clock."""
    t_bytes = 4 * (q * n + g * n + q * g) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * q * g * n / FP32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_pairwise(name: str, q: int, g: int, n: int, nnz, timed: bool, seed: int = 7) -> dict:
    """The ``name`` kernel (l1_cross or minsum_cross) against its plain version
    on the first PLAIN_ROWS query rows; ``nnz`` nonzeros per row shaped as V,
    or dense |randn| rows when None."""
    kernel, plain = getattr(pairwise, name), getattr(pairwise, f"{name}_plain")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if nnz:
        a, b = sparse_rows(q, n, nnz, gen), sparse_rows(g, n, nnz, gen)
    else:
        a = torch.randn(q, n, device="cuda", generator=gen).abs()
        b = torch.randn(g, n, device="cuda", generator=gen).abs()
    rows = min(q, PLAIN_ROWS)
    out = kernel(a, b)
    want = plain(a[:rows], b)
    torch.cuda.synchronize()
    err = (out[:rows] - want).abs().max().item()
    tol = PAIRWISE_TOL * max(1.0, want.abs().max().item())
    ok = bool(torch.isfinite(out).all().item()) and err <= tol
    row = dict(name=name, shape=[q, g, n], nonzeros_per_row=nnz, compared_rows=rows,
               max_abs_err=err, tol=tol, ok=ok)
    del out, want
    if timed:
        if name == "l1_cross":
            def library():
                return torch.cdist(a, b, p=1)
        else:  # min(x, y) = (x + y - |x - y|) / 2
            def library():
                return 0.5 * (a.sum(1)[:, None] + b.sum(1)[None] - torch.cdist(a, b, p=1))
        row["ms"] = cuda_ms(lambda: kernel(a, b), runs=5, warmup=1, reps=1)
        row["plain_ms"] = cuda_ms(lambda: plain(a[:rows], b), runs=2, warmup=1, reps=1)
        row["plain_rows"] = rows
        row["library_ms"] = cuda_ms(library, runs=3, warmup=1, reps=1)
        row["bound_ms"], row["bound_by"] = pairwise_bound_ms(q, g, n)
    log(f"  {name} {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain version: {row}")
    return row


def batch_hard_bound_ms(b: int, d: int, dtype: torch.dtype) -> tuple:
    """(ms, bound_by): the features, the labels read once and the four (B,)
    outputs written once over the memory rate, against the B×B dot products
    and the row norms (2·B·B·D + 2·B·D fp32 operations) over the fp32 peak."""
    size = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (b * d * size + 4 * b + 16 * b) / PEAK_BYTES_PER_S * 1e3
    t_ops = (2 * b * b * d + 2 * b * d) / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hard_inputs(b: int, d: int, dtype: torch.dtype, labels=None, grid: bool = False,
                seed: int = 21):
    """Seeded features on the card (normal, or on a grid of 1/4, where every
    distance is exact in fp32) and PK labels of 4, or the labels given."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if grid:
        f = torch.randint(-4, 5, (b, d), device="cuda", generator=gen).float() / 4
    else:
        f = torch.randn(b, d, device="cuda", generator=gen)
    if labels is None:
        labels = torch.arange(b, device="cuda") // K_INST
    return f.to(dtype), torch.as_tensor(labels, device="cuda").int()


def hard_mismatch(got, want, f, labels, tol) -> int:
    """Rows whose p or n index differs where no other candidate of the row lies
    within ``tol`` of the best (the top two differ by more than the tolerance)."""
    dist = euclidean_dist(f.float(), f.float())
    same = labels[:, None] == labels[None, :]
    bad = 0
    for val, idx, ref, mask in ((want[0], got[2], want[2], same),
                                (want[1], got[3], want[3], ~same)):
        clear = (((dist - val[:, None]).abs() <= tol) & mask).sum(1) == 1
        bad += int((idx[clear] != ref[clear]).sum())
    return bad


def check_batch_hard(name: str, b: int, d: int, dtype: torch.dtype, timed: bool,
                     labels=None, grid: bool = False) -> dict:
    """The batch-hard kernel against ``batch_hard_plain`` on the card: ap/an
    within HARD_TOL × max(1, max|plain|) (inf where plain is inf), p/n equal
    wherever the best two candidates differ by more than that; on grid
    features (exact distances) everything equal, and singleton identities at
    ap = sqrt(1e-12), p = self."""
    f, lab = hard_inputs(b, d, dtype, labels, grid)
    got = bh.batch_hard_mining(f, lab)
    want = bh.batch_hard_plain(f, lab)
    torch.cuda.synchronize()
    fin = torch.isfinite(want[1])
    scale = max([1.0, want[0].abs().max().item()]
                + ([want[1][fin].abs().max().item()] if bool(fin.any()) else []))
    tol = HARD_TOL * scale
    err = max((got[0] - want[0]).abs().max().item(),
              (got[1] - want[1])[fin].abs().max().item() if bool(fin.any()) else 0.0)
    ok = (err <= tol and torch.equal(torch.isinf(got[1]), ~fin)
          and hard_mismatch(got, want, f, lab, tol) == 0)
    if grid:
        solo = (lab[:, None] == lab[None, :]).sum(1) == 1
        ok = ok and all(torch.equal(g, w) for g, w in zip(got, want))
        ok = ok and bool((got[0][solo] == 1e-6).all()) and torch.equal(
            got[2][solo].long(), torch.nonzero(solo).flatten())
        ok = ok and bool((got[3][~fin] == 0).all())
    row = dict(case=name, dtype=str(dtype).split(".")[-1], shape=[b, d], grid=grid,
               rows_without_negative=int((~fin).sum()), max_abs_err=err, tol=tol, ok=ok)
    if timed:
        row["ms"] = cuda_ms(lambda: bh.batch_hard_mining(f, lab))
        row["plain_ms"] = cuda_ms(lambda: bh.batch_hard_plain(f, lab))
        x = f.float()
        row["library_ms"] = cuda_ms(lambda: torch.cdist(x, x))
        row["library"] = "torch.cdist(x, x): the distance matrix alone"
        row["bound_ms"], row["bound_by"] = batch_hard_bound_ms(b, d, dtype)
    log(f"  batch_hard {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"batch-hard kernel disagrees with its plain version: {row}")
    return row


def batch_hard_rows() -> list:
    """Phase 3's batch-hard cases: the PK batch (64 × 768) in fp32 (timed)
    and bf16, a ragged 60-row batch, and on grid features a batch with a
    singleton identity and a single-identity batch (no negatives)."""
    b, d = HARD["b"], HARD["d"]
    singleton = [i // K_INST for i in range(b - 1)] + [b]
    return [check_batch_hard("pk", b, d, torch.float32, timed=True),
            check_batch_hard("pk", b, d, torch.bfloat16, timed=False),
            check_batch_hard("ragged", 60, d, torch.float32, timed=False),
            check_batch_hard("singleton", b, d, torch.float32, False, singleton, grid=True),
            check_batch_hard("one_identity", b, d, torch.bfloat16, False, [0] * b, grid=True)]


class InMemoryBatcher:
    """Seeded uint8 query + gallery images with the ``ImageBatcher.iter_sequential``
    contract: every identity has images on both sides, so CMC is defined."""

    def __init__(self, n_query: int, n_gallery: int, batch_size: int, size_hw, seed: int = 0):
        rng = np.random.default_rng(seed)
        n_ids = n_query // 2
        h, w = size_hw
        bases = rng.integers(40, 215, (n_ids, h, w, 3)).astype(np.int16)
        pids = np.concatenate([np.repeat(np.arange(n_ids), 2),
                               np.repeat(np.arange(n_ids), n_gallery // n_ids)])
        noise = rng.integers(-60, 61, (len(pids), h, w, 3))
        self.images = np.clip(bases[pids] + noise, 0, 255).astype(np.uint8)
        self.pids = pids.astype(np.int32)
        self.camids = np.concatenate([np.zeros(n_query), np.ones(len(pids) - n_query)]
                                     ).astype(np.int32)
        self.batch_size = batch_size

    def iter_sequential(self):
        for lo in range(0, len(self.pids), self.batch_size):
            sl = slice(lo, lo + self.batch_size)
            n = len(self.pids[sl])
            yield {"images": self.images[sl], "pids": self.pids[sl],
                   "camids": self.camids[sl], "trackids": np.zeros(n, np.int32),
                   "count": n}


# configs/person/vit_base.yml, built in code (the script needs no yaml);
# tests/test_torch_package.py holds it to the file
VIT_BASE = {
    "MODEL": {"PRETRAIN_CHOICE": "imagenet", "METRIC_LOSS_TYPE": "triplet",
              "IF_LABELSMOOTH": "on", "IF_WITH_CENTER": "no", "NAME": "ViT-B-16",
              "STRIDE_SIZE": [16, 16], "ID_LOSS_WEIGHT": 1.0, "TRIPLET_LOSS_WEIGHT": 1.0},
    "INPUT": {"SIZE_TRAIN": list(HW), "SIZE_TEST": list(HW), "PROB": 0.5, "RE_PROB": 0.5,
              "PADDING": 10, "PIXEL_MEAN": [0.5, 0.5, 0.5], "PIXEL_STD": [0.5, 0.5, 0.5]},
    "DATALOADER": {"SAMPLER": "softmax_triplet", "NUM_INSTANCE": K_INST, "NUM_WORKERS": 8},
    "SOLVER": {"IMS_PER_BATCH": BATCH, "OPTIMIZER_NAME": "Adam", "BASE_LR": 0.000005,
               "WARMUP_METHOD": "linear", "WARMUP_ITERS": 10, "WARMUP_FACTOR": 0.1,
               "WEIGHT_DECAY": 0.0001, "WEIGHT_DECAY_BIAS": 0.0001, "LARGE_FC_LR": False,
               "MAX_EPOCHS": 60, "CHECKPOINT_PERIOD": 60, "LOG_PERIOD": 50, "EVAL_PERIOD": 60,
               "BIAS_LR_FACTOR": 2, "STEPS": [30, 50], "GAMMA": 0.1},
    "TEST": {"EVAL": True, "IMS_PER_BATCH": BATCH, "RE_RANKING": False, "WEIGHT": "",
             "NECK_FEAT": "before", "FEAT_NORM": "yes"},
    "DATASETS": {"NAMES": "market1501", "ROOT_DIR": "../data"},
    "OUTPUT_DIR": "output/person_vit_base",
}


# configs/veri/vit_base.yml: the same but 256×256 (L 257) and VeRi-776;
# tests/test_torch_package.py holds it to the file
VERI = {**VIT_BASE,
        "INPUT": {**VIT_BASE["INPUT"], "SIZE_TRAIN": list(VEHICLE_HW),
                  "SIZE_TEST": list(VEHICLE_HW)},
        "DATASETS": {"NAMES": "veri", "ROOT_DIR": "../data"},
        "OUTPUT_DIR": "output/veri_vit_base"}


def vit_base_cfg(dtype: str = "bfloat16", device: str = "cuda", settings: dict = VIT_BASE):
    """configs/person/vit_base.yml's settings (as train.py takes them), or
    ``settings``, on ``device`` in ``dtype``, writing no files."""
    cfg = get_default_cfg()
    cfg._merge_dict(settings)
    cfg.SOLVER.STAGE2.IMS_PER_BATCH = cfg.SOLVER.IMS_PER_BATCH
    cfg.MODEL.DEVICE = device
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.OUTPUT_DIR = ""
    return cfg


def run_slice(profile: bool) -> tuple:
    cfg = vit_base_cfg()
    t0 = time.perf_counter()
    model = make_model(cfg, num_class=751, camera_num=6, view_num=1)
    log(f"model: ViT-B/16 ReID, {sum(p.numel() for p in model.parameters())} parameters, "
        f"random init from SOLVER.SEED {cfg.SOLVER.SEED} in {time.perf_counter() - t0:.2f} s")
    loader = InMemoryBatcher(QUERY, GALLERY, BATCH, HW)
    n_batches = (QUERY + GALLERY) // BATCH

    do_inference(cfg, model, loader, QUERY)  # warm-up pass
    torch.cuda.synchronize()
    reset_counts()
    seconds = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        r1, r5 = do_inference(cfg, model, loader, QUERY)  # ends in a host copy of the metrics
        seconds.append(time.perf_counter() - t0)
    launches = attn.fused_attention.launches
    depth = len(model.image_encoder.transformer.resblocks)
    expect_counts("eval slice", read_counts(), {"attention_fwd": depth * n_batches * RUNS})
    rates = sorted((QUERY + GALLERY) / s for s in seconds)
    q1, med, q3 = (float(x) for x in np.percentile(rates, [25, 50, 75]))

    # forward alone on a device-resident batch (the layer under the end-to-end number)
    step = make_eval_step(model, cfg)
    batch = next(loader.iter_sequential())
    batch = dict(batch, images=torch.from_numpy(batch["images"]).cuda())
    feats = step(batch)
    if not bool(torch.isfinite(feats.float()).all().item()) or tuple(feats.shape) != (BATCH, 1280):
        raise AssertionError(f"bad eval features {tuple(feats.shape)}")
    fwd_ms = cuda_ms(lambda: step(batch), runs=20, reps=1)
    res = dict(eval_feats_per_s=med, eval_feats_per_s_q1=q1, eval_feats_per_s_q3=q3,
               runs=RUNS, images_per_run=QUERY + GALLERY,
               forward_ms_per_batch=fwd_ms, forward_feats_per_s=BATCH / fwd_ms * 1e3,
               rank1=float(r1), rank5=float(r5), launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"slice {json.dumps(res)}")
    if profile:
        profile_eval(cfg, model, loader, step, batch)
    return model, res


def device_busy_ms(prof) -> float:
    """Union of the device kernels' intervals in a profile, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def attention_ms(prof) -> float:
    """Device time of the attention kernels (``mha_*``) in a profile, in ms."""
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "mha_" in e.name) / 1e3


def profile_eval(cfg, model, loader, step, batch) -> None:
    """Per-kernel breakdown of 3 eval batches, and the device's idle share
    over one whole ``do_inference`` run (traced; tracing adds host time)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    shares = dict(eval_batches_device_ms=device_busy_ms(prof), attention_ms=attention_ms(prof))
    shares["attention_share"] = shares["attention_ms"] / shares["eval_batches_device_ms"]
    with profile(activities=acts) as prof_run:
        t0 = time.perf_counter()
        do_inference(cfg, model, loader, QUERY)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof_run)
    idle = dict(do_inference_wall_ms_traced=wall_ms, device_busy_ms=busy,
                device_idle_share=1 - busy / wall_ms)
    log("profile of 3 eval batches (bf16, batch 64):\n" + table)
    log(f"attention {json.dumps(shares)}")
    log(f"idle {json.dumps(idle)}")


class MemoryBatcher(ImageBatcher):
    """``ImageBatcher`` over uint8 images held in memory (record i is image i,
    its view label the camera and track id), so ``TrainLoader``,
    ``ShuffledLoader`` and the PK sampler run unchanged."""

    def __init__(self, images: np.ndarray, pids: np.ndarray, batch_size: int, views=None):
        views = np.zeros(len(pids), np.int32) if views is None else views
        records = [(str(i), int(p), int(v), int(v)) for i, (p, v) in enumerate(zip(pids, views))]
        super().__init__(records, images.shape[1:3], batch_size, num_workers=4)
        self.images = images

    def _decode(self, rec):
        return self.images[int(rec[0])]


def train_images(seed: int = 2, hw=HW):
    """Seeded uint8 train set: TRAIN_IDS identities × TRAIN_IMGS_PER_ID images
    of ``hw``, a per-identity pattern plus per-image noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    bases = rng.integers(40, 215, (TRAIN_IDS, h, w, 3), dtype=np.int16)
    pids = np.repeat(np.arange(TRAIN_IDS), TRAIN_IMGS_PER_ID)
    noise = rng.integers(-60, 61, (len(pids), h, w, 3), dtype=np.int16)
    return np.clip(bases[pids] + noise, 0, 255).astype(np.uint8), pids.astype(np.int32)


def pk_batches(images, pids, n: int, ids: int = P_IDS, seed: int = 3) -> list:
    """``n`` PK batches (``ids`` identities × K_INST images) on the card."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        chosen = rng.choice(np.unique(pids), ids, replace=False)
        idx = np.concatenate([rng.choice(np.flatnonzero(pids == i), K_INST, replace=False)
                              for i in chosen])
        zeros = torch.zeros(len(idx), dtype=torch.int32, device=CARD)
        out.append({"images": torch.from_numpy(images[idx]).to(CARD),
                    "pids": torch.from_numpy(pids[idx]).to(CARD), "camids": zeros,
                    "trackids": zeros})
    return out


COUNTED = {"attention_fwd": attn.fused_attention, "attention_bwd": attn.fused_attention_bwd,
           "adam": adam.fused_adam_leaf, "l1_cross": pairwise.l1_cross,
           "minsum_cross": pairwise.minsum_cross, "batch_hard": bh.fused_batch_hard}
ROUTED = {"attention_fwd": attn.fused_attention, "attention_bwd": attn.fused_attention_bwd}


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
    for fn in ROUTED.values():
        fn.launches_by_route = dict.fromkeys(attn.ROUTES, 0)


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def read_routes() -> dict:
    return {name: dict(fn.launches_by_route) for name, fn in ROUTED.items()}


def expect_counts(what: str, got: dict, want: dict) -> None:
    """Every kernel's launches are as ``want`` says, 0 where it says nothing,
    and every attention launch (the paths run bf16) on the "tc" route."""
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
    routes = read_routes()
    for name, by_route in routes.items():
        if by_route != {r: got[name] if r == "tc" else 0 for r in attn.ROUTES}:
            raise AssertionError(f"{what}: attention launches by route {routes}, "
                                 f"expected all {got[name]} of {name} on tc")


def run_train(profile: bool) -> dict:
    """The training slice at full width: timed steps, one do_train epoch,
    fused-Adam steps and one fused update against the plain one."""
    cfg = vit_base_cfg(device=CARD)
    t0 = time.perf_counter()
    model = make_model(cfg, num_class=NUM_CLASSES, camera_num=6, view_num=1)
    depth = len(model.image_encoder.transformer.resblocks)
    loss_fn, _ = make_loss(cfg, NUM_CLASSES)
    optimizer = make_optimizer(cfg.SOLVER, model, stage="baseline")
    lr = make_scheduler(cfg.SOLVER, "multistep")(1)
    images, pids = train_images()
    batches = pk_batches(images, pids, 4)
    log(f"train model: ViT-B/16 ReID, {NUM_CLASSES} classes, "
        f"{sum(p.numel() for p in model.parameters())} parameters, bf16 over fp32, "
        f"Adam lr {lr:.3g} (epoch 1), set up in {time.perf_counter() - t0:.2f} s")

    state = initial_state(model, optimizer)
    step = make_train_step(model, cfg, loss_fn, optimizer)
    gen = torch.Generator(device=CARD).manual_seed(int(cfg.SOLVER.SEED))
    state, _ = step(state, batches[0], lr, gen)  # warm-up step
    torch.cuda.synchronize()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, losses = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i % len(batches)], lr, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    counts = read_counts()
    expect_counts("train steps", counts, {"attention_fwd": depth * TRAIN_STEPS,
                                          "attention_bwd": depth * TRAIN_STEPS, "adam": 0})
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    train, _ = optimizer.partition(model)
    big = [k for k, p in train.items() if p.numel() >= adam.MIN_FUSED_SIZE]
    if len(big) != ADAM_LEAVES:
        raise AssertionError(f"{len(big)} leaves of at least {adam.MIN_FUSED_SIZE} elements, "
                             f"expected {ADAM_LEAVES}")
    changed = [k for k, p in train.items() if not torch.equal(p.detach(), before[k])]
    if not set(big) <= set(changed):
        raise AssertionError(f"parameters that did not change: {sorted(set(big) - set(changed))}")
    del before
    rates = sorted(BATCH / x for x in seconds)
    q1, med, q3 = (float(x) for x in np.percentile(rates, [25, 50, 75]))
    res = dict(train_img_per_s=med, train_img_per_s_q1=q1, train_img_per_s_q3=q3,
               step_ms_median=float(np.median(seconds)) * 1e3, steps=TRAIN_STEPS, batch=BATCH,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
               launches_by_route=read_routes(),
               changed_leaves=len(changed), trainable_leaves=len(train), losses=losses)
    log(f"train {json.dumps(res)}")

    # one short epoch through do_train over a TrainLoader on the same data
    sampler = RandomIdentitySampler(list(zip(range(len(pids)), pids)), BATCH, K_INST,
                                    seed=int(cfg.SOLVER.SEED))
    loader = TrainLoader(MemoryBatcher(images, pids, BATCH), sampler)
    n_epoch = len(sampler.epoch_indices(1)) // BATCH
    cfg_epoch = cfg.clone()
    cfg_epoch.SOLVER.LOG_PERIOD = 4
    reset_counts()
    t0 = time.perf_counter()
    _, history = do_train(cfg_epoch, model, loader, None, optimizer, lambda e: lr, loss_fn,
                          QUERY, max_epochs=1)
    epoch_s = time.perf_counter() - t0
    expect_counts("do_train epoch", read_counts(), {"attention_fwd": depth * n_epoch,
                                                    "attention_bwd": depth * n_epoch, "adam": 0})
    if not np.isfinite(history[0]["loss"]):
        raise AssertionError(f"non-finite do_train loss {history}")
    res_epoch = dict(batches=n_epoch, seconds=epoch_s, img_per_s=n_epoch * BATCH / epoch_s,
                     loss=history[0]["loss"], acc=history[0]["acc"])
    log(f"do_train epoch {json.dumps(res_epoch)}")

    # SOLVER.FUSED_ADAM: the Adam kernel on every leaf of at least MIN_FUSED_SIZE
    cfg_fused = cfg.clone()
    cfg_fused.SOLVER.FUSED_ADAM = True
    opt_fused = make_optimizer(cfg_fused.SOLVER, model, stage="baseline")
    state_f = initial_state(model, opt_fused)
    step_f = make_train_step(model, cfg_fused, loss_fn, opt_fused)
    reset_counts()
    fused_s = []
    for i in range(FUSED_STEPS):
        t0 = time.perf_counter()
        state_f, metrics = step_f(state_f, batches[i % len(batches)], lr, gen)
        torch.cuda.synchronize()
        fused_s.append(time.perf_counter() - t0)
    fused_counts = read_counts()
    expect_counts("fused-Adam steps", fused_counts, {
        "attention_fwd": depth * FUSED_STEPS, "attention_bwd": depth * FUSED_STEPS,
        "adam": len(big) * FUSED_STEPS})
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError("non-finite loss with SOLVER.FUSED_ADAM")
    f_q1, f_med, f_q3 = (float(x) for x in np.percentile(sorted(BATCH / x for x in fused_s),
                                                         [25, 50, 75]))
    res_fused = dict(steps=FUSED_STEPS, big_leaves=len(big), launches=fused_counts,
                     step_ms_median=float(np.median(fused_s)) * 1e3, train_img_per_s=f_med,
                     train_img_per_s_q1=f_q1, train_img_per_s_q3=f_q3,
                     **fused_update_check(model, cfg, loss_fn, opt_fused, state_f, batches[0],
                                          lr))
    log(f"fused adam {json.dumps(res_fused)}")
    if profile:
        profile_train(step, state, batches, lr, gen)
    return dict(model=model, train=res, epoch=res_epoch, fused=res_fused, big_leaves=len(big))


def fused_update_check(model, cfg, loss_fn, opt_fused, state_f, batch, lr) -> dict:
    """One update from the same state and gradients, fused against plain:
    parameters within ADAM_RTOL·|p| + ADAM_ATOL_LR·lr·mult (a step that
    differs in its last bits moves p by an ulp of p), moments within
    ADAM_RTOL relative."""
    from mpreid_tpu_torch.solver import OptState

    x = eval_preprocess(batch["images"], mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD)
    _, _, grads, _ = loss_and_grads(model, cfg, loss_fn, opt_fused, x, batch["pids"].long())
    opt_plain = make_optimizer(cfg.SOLVER, model, stage="baseline")
    train, _ = opt_fused.partition(model)
    results = []
    for opt in (opt_fused, opt_plain):
        params = {k: p.detach().clone() for k, p in train.items()}
        st = OptState(step=state_f.opt_state.step,
                      mu={k: t.clone() for k, t in state_f.opt_state.mu.items()},
                      nu={k: t.clone() for k, t in state_f.opt_state.nu.items()})
        st = opt.update(grads, st, params, lr)
        results.append((params, st))
    torch.cuda.synchronize()
    (pf, sf), (pp, sp) = results

    def excess(a, b, atol):  # largest |a - b| over its allowance
        return ((a.float() - b.float()).abs() / (ADAM_RTOL * b.float().abs() + atol)).max().item()

    p_x = max(excess(pf[k], pp[k], ADAM_ATOL_LR * lr * opt_plain.lr_mult[k]) for k in pf)
    m_x = max(excess(st_f[k], st_p[k], 1e-30) for st_f, st_p in ((sf.mu, sp.mu), (sf.nu, sp.nu))
              for k in pf)
    p_err = max(((pf[k] - pp[k]).abs().max() / (lr * opt_plain.lr_mult[k])).item() for k in pf)
    res = dict(fused_vs_plain_max_param_err_lr_units=p_err, param_err_over_allowance=p_x,
               moment_err_over_allowance=m_x, rtol=ADAM_RTOL, atol_lr_units=ADAM_ATOL_LR)
    if not (p_x <= 1.0 and m_x <= 1.0):
        raise AssertionError(f"fused Adam update disagrees with the plain one: {res}")
    return res


def run_vehicle_train() -> dict:
    """configs/veri/vit_base.yml at full width: ViT-B/16 at 256×256 (L 257),
    576 classes, bf16 over fp32, VEHICLE_STEPS train steps on PK batches of
    seeded images (augmentation on, Adam): finite losses and 12 + 12
    attention launches a step, all on the tensor-core route."""
    cfg = vit_base_cfg(device=CARD, settings=VERI)
    model = make_model(cfg, num_class=VEHICLE_CLASSES, camera_num=VEHICLE_CAMERAS, view_num=1)
    depth = len(model.image_encoder.transformer.resblocks)
    length = model.image_encoder.positional_embedding.shape[0]
    if length != VEHICLE["l"]:
        raise AssertionError(f"vehicle ViT-B/16 sequence length {length}, expected {VEHICLE['l']}")
    loss_fn, _ = make_loss(cfg, VEHICLE_CLASSES)
    optimizer = make_optimizer(cfg.SOLVER, model, stage="baseline")
    lr = make_scheduler(cfg.SOLVER, "multistep")(1)
    images, pids = train_images(seed=11, hw=VEHICLE_HW)
    batches = pk_batches(images, pids, VEHICLE_STEPS, seed=12)
    del images
    state = initial_state(model, optimizer)
    step = make_train_step(model, cfg, loss_fn, optimizer)
    gen = torch.Generator(device=CARD).manual_seed(int(cfg.SOLVER.SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, losses = [], []
    for batch in batches:
        (state, metrics), secs = timed(lambda: step(state, batch, lr, gen))
        seconds.append(secs)
        losses.append(float(metrics["loss"]))
    counts = read_counts()
    expect_counts("vehicle train steps", counts, {"attention_fwd": depth * VEHICLE_STEPS,
                                                  "attention_bwd": depth * VEHICLE_STEPS})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite vehicle train loss: {losses}")
    res = dict(config="configs/veri/vit_base.yml", hw=list(VEHICLE_HW), seq_len=length,
               classes=VEHICLE_CLASSES, steps=VEHICLE_STEPS, batch=BATCH, losses=losses,
               step_seconds=seconds, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, launches_by_route=read_routes())
    log(f"vehicle train {json.dumps(res)}")
    return res


def profile_train(step, state, batches, lr, gen) -> None:
    """Per-kernel breakdown of 3 train steps and the device's idle share
    over them (traced; tracing adds host time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            state, _ = step(state, batches[i], lr, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    log("profile of 3 train steps (bf16, batch 64):\n" + table)
    att = attention_ms(prof)
    log(f"idle {json.dumps(dict(train_steps_wall_ms_traced=wall_ms, device_busy_ms=busy, device_idle_share=1 - busy / wall_ms, attention_ms=att, attention_share=att / busy))}")


def check_batch() -> dict:
    """The cross-checks' PK batch of 2 × 4 seeded images, on the card."""
    images, pids = train_images(seed=5)
    return pk_batches(images, pids, 1, ids=CHECK_BATCH // K_INST, seed=6)[0]


def step_loss_and_grads(weights: dict, c, batch: dict, device) -> tuple:
    """(loss, {name: fp32 gradient on the CPU}) of one baseline train step of
    the model ``c`` builds, from ``weights``, augmentation off, on ``device``."""
    from mpreid_tpu_torch.engine.steps import augment_args
    from mpreid_tpu_torch.ops.augment import train_augment

    c.INPUT.PROB, c.INPUT.PADDING, c.INPUT.RE_PROB = 0.0, 0, 0.0
    m = build_model(c, NUM_CLASSES, 6, 1)
    m.load_state_dict(weights, strict=True)
    m = m.to(device)
    loss_fn, _ = make_loss(c, NUM_CLASSES)
    opt = make_optimizer(c.SOLVER, m, stage="baseline")
    x = train_augment(batch["images"].to(device), torch.Generator(device=device),
                      **augment_args(c))
    loss, _, grads, _ = loss_and_grads(m, c, loss_fn, opt, x, batch["pids"].to(device).long())
    return float(loss), {k: g.float().cpu() for k, g in grads.items()}


def worst_grad_rel(got: dict, want: dict) -> float:
    """The largest per-leaf norm-relative gradient error, each leaf's norm
    floored at 1e-3 of the largest leaf's."""
    floor = 1e-3 * max(g.norm().item() for g in want.values())
    return max((got[k] - g).norm().item() / max(g.norm().item(), floor) for k, g in want.items())


def train_cross_checks(model) -> dict:
    """A train step's loss and gradients, augmentation off, batch of 2 × 4,
    from the same weights: fp32 on the card against fp32 on the CPU (each
    leaf norm-relative, floored at 1e-3 of the largest leaf), and bf16
    against fp32 on the card (cosine on every leaf of at least
    MIN_FUSED_SIZE elements)."""
    batch = check_batch()
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = {name: step_loss_and_grads(weights, vit_base_cfg(dtype, device), batch, device)
           for name, dtype, device in (("fp32_cpu", "float32", "cpu"),
                                       ("fp32_cuda", "float32", CARD),
                                       ("bf16_cuda", "bfloat16", CARD))}
    (l_cpu, g_cpu), (l_gpu, g_gpu), (_, g_bf16) = out["fp32_cpu"], out["fp32_cuda"], out["bf16_cuda"]
    grad_err = worst_grad_rel(g_gpu, g_cpu)
    big = [k for k, g in g_gpu.items() if g.numel() >= adam.MIN_FUSED_SIZE]
    cos = {k: F.cosine_similarity(g_bf16[k].flatten(), g_gpu[k].flatten(), dim=0).item()
           for k in big}
    res = dict(fp32_card_vs_cpu_loss_rel=abs(l_gpu - l_cpu) / abs(l_cpu), loss_rtol=LOSS_RTOL,
               fp32_card_vs_cpu_worst_grad_rel=grad_err, grad_rtol=GRAD_RTOL,
               bf16_vs_fp32_min_grad_cosine=min(cos.values()),
               min_cosine_leaf=min(cos, key=cos.get), cosine_floor=COSINE_FLOOR,
               leaves=len(g_cpu), large_leaves=len(big))
    log(f"train cross-checks {json.dumps(res)}")
    if not res["fp32_card_vs_cpu_loss_rel"] <= LOSS_RTOL:
        raise AssertionError(f"fp32 train loss on the card differs from the CPU's: {res}")
    if not grad_err <= GRAD_RTOL:
        raise AssertionError(f"fp32 gradients on the card differ from the CPU's: {res}")
    if not min(cos.values()) >= COSINE_FLOOR:
        raise AssertionError(f"bf16 vs fp32 gradient cosine below {COSINE_FLOOR}: {res}")
    return res


def cross_checks(model) -> None:
    """fp32 on the card vs fp32 on the CPU (plain attention), and bf16 vs fp32 on the card."""
    loader = InMemoryBatcher(8, 8, 8, HW, seed=1)
    images = next(loader.iter_sequential())["images"]
    state = model.state_dict()
    feats = {}
    for name, dtype, device in (("bf16_cuda", "bfloat16", "cuda"),
                                ("fp32_cuda", "float32", "cuda"),
                                ("fp32_cpu", "float32", "cpu")):
        c = vit_base_cfg(dtype, device)
        m = build_model(c, 751, 6, 1)
        m.load_state_dict(state, strict=True)
        m = m.to(device).eval()
        feats[name] = make_eval_step(m, c)({"images": images}).float().cpu()
    err = (feats["fp32_cuda"] - feats["fp32_cpu"]).abs().max().item()
    cos = F.cosine_similarity(feats["bf16_cuda"], feats["fp32_cuda"], dim=1)
    res = dict(fp32_card_vs_cpu_max_abs=err, fp32_tol=1e-3,
               bf16_vs_fp32_min_cosine=cos.min().item(), cosine_floor=0.99)
    log(f"cross-checks {json.dumps(res)}")
    if not err <= 1e-3:
        raise AssertionError(f"fp32 card vs CPU features differ by {err}")
    if not bool((cos >= 0.99).all().item()):
        raise AssertionError(f"bf16 vs fp32 cosine below 0.99: {cos.tolist()}")


# configs/ours/cctv_ir_cctv_rgb.yml, built in code (the script needs no yaml);
# tests/test_torch_package.py holds it to the file
_STAGE1 = {"IMS_PER_BATCH": BATCH, "OPTIMIZER_NAME": "Adam", "BASE_LR": 0.00035,
           "WARMUP_LR_INIT": 0.00001, "LR_MIN": 1.0e-6, "WARMUP_METHOD": "linear",
           "WEIGHT_DECAY": 1.0e-4, "WEIGHT_DECAY_BIAS": 1.0e-4, "LOG_PERIOD": 50,
           "WARMUP_EPOCHS": 5}
UNIPROMPT = {
    "MODEL": {"PRETRAIN_CHOICE": "imagenet", "METRIC_LOSS_TYPE": "triplet",
              "IF_LABELSMOOTH": "on", "IF_WITH_CENTER": "no", "NAME": "ViT-B-16",
              "STRIDE_SIZE": [16, 16], "ID_LOSS_WEIGHT": 0.25, "TRIPLET_LOSS_WEIGHT": 1.0,
              "I2T_LOSS_WEIGHT": 1.0, "MOE": {"ENABLED": False}},
    "INPUT": VIT_BASE["INPUT"],
    "DATALOADER": VIT_BASE["DATALOADER"],
    "SOLVER": {
        "STAGE1": {**_STAGE1, "MAX_EPOCHS": 120, "CHECKPOINT_PERIOD": 120},
        "STAGE1A": {**_STAGE1, "MAX_EPOCHS": 60, "CHECKPOINT_PERIOD": 60},
        "STAGE1B": {**_STAGE1, "MAX_EPOCHS": 60, "CHECKPOINT_PERIOD": 60},
        "STAGE2": {"IMS_PER_BATCH": BATCH, "OPTIMIZER_NAME": "Adam", "BASE_LR": 0.000005,
                   "WARMUP_METHOD": "linear", "WARMUP_ITERS": 10, "WARMUP_FACTOR": 0.1,
                   "WEIGHT_DECAY": 0.0001, "WEIGHT_DECAY_BIAS": 0.0001, "LARGE_FC_LR": False,
                   "MAX_EPOCHS": 60, "CHECKPOINT_PERIOD": 60, "LOG_PERIOD": 50,
                   "EVAL_PERIOD": 60, "BIAS_LR_FACTOR": 2, "STEPS": [30, 50], "GAMMA": 0.1},
    },
    "TEST": VIT_BASE["TEST"],
    "DATASETS": {"NAMES": "mmmp", "ROOT_DIR": "/data/mmmp1_10",
                 "EXP_SETTING": "exp_cctv_ir_cctv_rgb"},
    "OUTPUT_DIR": "output_uniprompt",
}


# configs/tpu/uniprompt_tuned.yml, built in code; it names the blocks to lay
# over a task config (its header), here cctv_ir_cctv_rgb.yml's;
# tests/test_torch_package.py holds it to the file
UNIPROMPT_TUNED = {
    "MODEL": {"NAME": "ViT-B-16"},
    "TPU": {"DEVICE_DATASET": True, "EVAL_SHARDED": True, "ZERO_OPT_STATE": True,
            "COMPILE_CACHE_DIR": "/tmp/mpreid_xla_cache"},
    "SOLVER": {"MOMENT_DTYPE": "bfloat16",
               **{k: {"MOMENT_DTYPE": "bfloat16"}
                  for k in ("STAGE1", "STAGE1A", "STAGE1B", "STAGE2")}},
    "TEST": {"IMS_PER_BATCH": 128},
}


def uniprompt_cfg(dtype: str = "bfloat16", device: str = CARD, settings: dict = UNIPROMPT):
    """configs/ours/cctv_ir_cctv_rgb.yml's settings (as train_uniprompt takes
    them), or ``settings``, on ``device`` in ``dtype``, writing no files; each
    stage runs one epoch here."""
    cfg = get_default_cfg()
    cfg._merge_dict(settings)
    cfg.MODEL.DEVICE = device
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.OUTPUT_DIR = ""
    return cfg


def tuned_cfg(dtype: str = "bfloat16", device: str = CARD, moe: bool = True):
    """configs/ours/cctv_ir_cctv_rgb.yml under configs/tpu/uniprompt_tuned.yml,
    as ``train_uniprompt --config_file`` of both takes them, with bench.py's
    MoE settings (``moe``), on ``device`` in ``dtype``, writing no files."""
    cfg = uniprompt_cfg(dtype, device)
    cfg._merge_dict(UNIPROMPT_TUNED)
    if moe:
        cfg._merge_dict({"MODEL": {"MOE": MOE_BENCH}})
    return cfg


def uniprompt_images(seed: int = 7):
    """BANK_IMAGES seeded uint8 images over UNI_CLASSES identities (4 or 5
    each) with view labels drawn over 0-14."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BANK_IMAGES, *HW, 3), dtype=np.uint8)
    pids = (np.arange(BANK_IMAGES) % UNI_CLASSES).astype(np.int32)
    views = rng.integers(0, UNI_VIEWS, BANK_IMAGES).astype(np.int32)
    return images, pids, views


def timed(fn):
    """(result, seconds) of ``fn()`` ending in a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_ms_by_op(prof, groups: dict) -> dict:
    """Self device time of the traced operators, in ms, summed into the
    first of ``groups`` ({name: substrings}) whose substring the operator's
    name holds, "other" for the rest (operators only: each kernel's time is
    its launching operator's)."""
    out = dict.fromkeys([*groups, "other"], 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.self_device_time_total:
            continue
        group = next((g for g, subs in groups.items() if any(x in e.key for x in subs)), "other")
        out[group] += e.self_device_time_total / 1e3
    return out


def profile_idle(fn, what: str, groups=None) -> dict:
    """The device's idle share over ``fn()`` (traced; tracing adds host time)
    and its breakdown by kernel, and with ``groups`` by operator group."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof)
    log(f"profile of {what}:\n" + prof.key_averages().table(sort_by="cuda_time_total",
                                                             row_limit=20))
    att = attention_ms(prof)
    res = dict(what=what, wall_ms_traced=wall_ms, device_busy_ms=busy,
               device_idle_share=1 - busy / wall_ms, attention_ms=att,
               attention_share=att / busy)
    if groups:
        res["device_ms_by_op"] = device_ms_by_op(prof, groups)
    log(f"idle {json.dumps(res)}")
    return res


def run_uniprompt(profile: bool) -> dict:
    """The Uni-Prompt slice at full width (ViT-B/16 + the 12 × 512 text
    tower, bf16 over fp32 parameters, 1,000 classes): the stage-1 bank over
    BANK_IMAGES, one stage-1a and one stage-1b epoch through do_train_stage1,
    the stage-2 text features, STAGE2A_STEPS timed stage-2a steps (PK 16 × 4,
    augmentation on, the i2t term), one stage-2b epoch of 12 steps through
    do_train_stage2, and do_inference; each with its kernel launches."""
    cfg = uniprompt_cfg()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = make_model_uniprompt(cfg, num_class=UNI_CLASSES, camera_num=14, view_num=UNI_VIEWS)
    vdepth = len(model.image_encoder.transformer.resblocks)
    tdepth = len(model.text_encoder.transformer.resblocks)
    images, pids, views = uniprompt_images()
    loader1 = ShuffledLoader(MemoryBatcher(images, pids, BATCH, views), int(cfg.SOLVER.SEED))
    log(f"uniprompt model: ViT-B/16 + text tower ({tdepth} × "
        f"{model.text_encoder.width}, {model.clip_config.transformer_heads} heads), "
        f"{UNI_CLASSES} classes, {sum(p.numel() for p in model.parameters())} parameters, "
        f"bf16 over fp32, set up in {time.perf_counter() - t0:.2f} s")
    res = {}

    # the stage-1 bank
    build_image_bank(cfg, model, ShuffledLoader(MemoryBatcher(images[:BATCH], pids[:BATCH],
                                                              BATCH, views[:BATCH]), 0))
    torch.cuda.synchronize()
    reset_counts()
    bank, secs = timed(lambda: build_image_bank(cfg, model, loader1))
    n_bank = BANK_IMAGES // BATCH
    expect_counts("image bank", read_counts(), {"attention_fwd": vdepth * n_bank})
    if tuple(bank[0].shape) != (BANK_IMAGES, model.in_planes_proj) or \
            not bool(torch.isfinite(bank[0].float()).all()):
        raise AssertionError(f"bad image bank {tuple(bank[0].shape)}")
    if set(np.unique(bank[2]).tolist()) != set(range(UNI_VIEWS)):
        raise AssertionError("the bank's views do not cover 0-14")
    res["bank"] = dict(images=BANK_IMAGES, seconds=secs, feats_per_s=BANK_IMAGES / secs)

    # stage 1a and 1b: one epoch each (64 steps of 64 bank rows)
    n_steps = BANK_IMAGES // BATCH
    for stage in ("1a", "1b"):
        stage_cfg = cfg.SOLVER[f"STAGE{stage.upper()}"].clone()
        stage_cfg.MAX_EPOCHS = 1
        opt = make_optimizer(stage_cfg, model, stage=f"stage{stage}")
        reset_counts()
        (state, hist), secs = timed(lambda: do_train_stage1(
            cfg, model, loader1, opt, make_scheduler(stage_cfg, "cosine"),
            is_stage1b=stage == "1b", bank=bank, stage_cfg=stage_cfg))
        counts = read_counts()
        expect_counts(f"stage {stage} epoch", counts, {"attention_fwd": tdepth * n_steps,
                                                       "attention_bwd": tdepth * n_steps})
        if state.opt_state.step != n_steps or not np.isfinite(hist[0]["loss"]):
            raise AssertionError(f"stage {stage}: {state.opt_state.step} steps, {hist}")
        res[f"stage{stage}"] = dict(steps=n_steps, batch=BATCH, seconds=secs,
                                    bank_rows_per_s=BANK_IMAGES / secs, loss=hist[0]["loss"],
                                    launches=counts)
        if profile and stage == "1b":
            step = make_stage1_step(model, cfg, opt, "1b")
            sel = torch.arange(BATCH, device=CARD)
            lab, vw = (torch.as_tensor(a[:BATCH]).to(CARD) for a in bank[1:])
            res["stage1_profile"] = profile_idle(
                lambda: [step(state, bank[0][sel], lab, vw, 1e-4) for _ in range(3)],
                "3 stage-1b steps (bf16, batch 64)")

    # the weights after stage 1b: the MoE phase upcycles them
    after_1b = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # the stage-2 text features of every class
    reset_counts()
    text, secs = timed(lambda: precompute_text_features(cfg, model, UNI_CLASSES))
    n_text = -(-UNI_CLASSES // BATCH)
    expect_counts("text features", read_counts(), {"attention_fwd": tdepth * n_text})
    if tuple(text.shape) != (UNI_CLASSES, model.in_planes_proj) or \
            not bool(torch.isfinite(text.float()).all()):
        raise AssertionError(f"bad text features {tuple(text.shape)}")
    res["text_features"] = dict(classes=UNI_CLASSES, seconds=secs,
                                classes_per_s=UNI_CLASSES / secs)

    # stage 2a: timed steps of make_train_step with the i2t term
    loss_fn, _ = make_loss(cfg, UNI_CLASSES)
    opt_2a = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    lr = make_scheduler(cfg.SOLVER.STAGE2, "multistep")(1)
    batches = pk_batches(images, pids, 4, seed=8)
    state = initial_state(model, opt_2a)
    step = make_train_step(model, cfg, loss_fn, opt_2a, uniprompt=True, text_features=text)
    gen = torch.Generator(device=CARD).manual_seed(int(cfg.SOLVER.SEED))
    state, _ = step(state, batches[0], lr, gen)  # warm-up step
    torch.cuda.synchronize()
    reset_counts()
    seconds, losses = [], []
    for i in range(STAGE2A_STEPS):
        (state, metrics), secs = timed(lambda: step(state, batches[i % len(batches)], lr, gen))
        seconds.append(secs)
        losses.append(metrics["loss"])
    counts = read_counts()
    expect_counts("stage 2a steps", counts, {"attention_fwd": vdepth * STAGE2A_STEPS,
                                             "attention_bwd": vdepth * STAGE2A_STEPS})
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite stage-2a loss: {losses}")
    q1, med, q3 = (float(x) for x in np.percentile(sorted(BATCH / x for x in seconds),
                                                   [25, 50, 75]))
    res["stage2a"] = dict(steps=STAGE2A_STEPS, batch=BATCH, train_img_per_s=med,
                          train_img_per_s_q1=q1, train_img_per_s_q3=q3,
                          step_ms_median=float(np.median(seconds)) * 1e3, launches=counts,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses)
    if profile:
        res["stage2a_profile"] = profile_idle(
            lambda: [step(state, batches[i], lr, gen) for i in range(3)],
            "3 stage-2a steps (bf16, batch 64)")
    with torch.no_grad():  # feats[1] of one stage-2a forward, for the batch-hard check
        x = eval_preprocess(batches[1]["images"], mean=cfg.INPUT.PIXEL_MEAN,
                            std=cfg.INPUT.PIXEL_STD)
        feats = model.forward_train(x, batches[1]["pids"].long())["feats"][1]

    # stage 2b: one epoch of 12 steps through do_train_stage2
    sub = np.flatnonzero(pids < STAGE2B_IDS)
    sampler = RandomIdentitySampler(list(zip(range(len(sub)), pids[sub])), BATCH, K_INST,
                                    seed=int(cfg.SOLVER.SEED))
    loader2 = TrainLoader(MemoryBatcher(images[sub], pids[sub], BATCH, views[sub]), sampler)
    n_2b = len(sampler.epoch_indices(1)) // BATCH
    opt_2b = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2b")
    reset_counts()
    (_, hist), secs = timed(lambda: do_train_stage2(
        cfg, model, loader2, None, opt_2b, make_scheduler(cfg.SOLVER.STAGE2, "multistep"),
        loss_fn, QUERY, UNI_CLASSES, max_epochs=1))
    counts = read_counts()
    expect_counts("stage 2b epoch", counts, {
        "attention_fwd": tdepth * n_text + vdepth * n_2b, "attention_bwd": vdepth * n_2b})
    if not np.isfinite(hist[0]["loss"]):
        raise AssertionError(f"non-finite stage-2b loss {hist}")
    res["stage2b"] = dict(steps=n_2b, seconds=secs, img_per_s=n_2b * BATCH / secs,
                          loss=hist[0]["loss"], acc=hist[0]["acc"], launches=counts)

    # inference
    loader = InMemoryBatcher(QUERY, GALLERY, BATCH, HW)
    reset_counts()
    (r1, r5), secs = timed(lambda: do_inference(cfg, model, loader, QUERY))
    counts = read_counts()
    expect_counts("uniprompt do_inference", counts,
                  {"attention_fwd": vdepth * (QUERY + GALLERY) // BATCH})
    res["inference"] = dict(images=QUERY + GALLERY, seconds=secs,
                            feats_per_s=(QUERY + GALLERY) / secs, rank1=float(r1),
                            rank5=float(r5), launches=counts)
    log(f"uniprompt {json.dumps(res)}")
    return dict(res=res, model=model, feats=feats, labels=batches[1]["pids"], text=text,
                after_1b=after_1b, data=(images, pids, views))


def uniprompt_triplet_check(feats: torch.Tensor, labels: torch.Tensor) -> dict:
    """batch_hard_triplet_loss (the batch-hard kernel forward, the torch VJP)
    against autograd through losses/triplet.py::triplet_loss, margin 0.3 and
    soft margin, on the feats[1] of one stage-2a forward (fp32). The loss is
    held to 2·HARD_TOL·max(1, max distance) absolute (the hinge and the
    softplus are 1-Lipschitz in each of ap and an, which the kernel gives to
    HARD_TOL·max(1, max distance)), the gradient to 1e-4 norm-relative."""
    reset_counts()
    res = {}
    for name, margin in (("margin_0.3", 0.3), ("soft", None)):
        x = feats.detach().float().requires_grad_(True)
        y = feats.detach().float().requires_grad_(True)
        loss, _, _ = bh.batch_hard_triplet_loss(x, labels, margin=margin)
        loss.backward()
        want, ap, an = triplet_loss(y, labels.long(), margin=margin)
        want.backward()
        torch.cuda.synchronize()
        res[name] = dict(loss=loss.item(), loss_abs_err=abs(loss.item() - want.item()),
                         loss_tol=2 * HARD_TOL * max(1.0, ap.max().item(), an.max().item()),
                         grad_rel_err=(x.grad - y.grad).norm().item() / y.grad.norm().item())
    res["launches"] = read_counts()["batch_hard"]
    log(f"batch-hard triplet loss on feats[1] {json.dumps(res)}")
    if res["launches"] != 2 or not all(
            r["loss_abs_err"] <= r["loss_tol"] and r["grad_rel_err"] <= 1e-4
            for k, r in res.items() if k != "launches"):
        raise AssertionError(f"batch_hard_triplet_loss disagrees with triplet_loss: {res}")
    return res


def _rel_err(a: torch.Tensor, b: torch.Tensor, floor: float = 0.0) -> float:
    return (a - b).norm().item() / max(b.norm().item(), floor, 1e-30)


def uniprompt_cross_checks(model, text: torch.Tensor) -> dict:
    """From the slice's weights: one stage-1b step and one stage-2a step at
    batch 8 (augmentation off), fp32 on the card against fp32 on the CPU: the
    loss to LOSS_RTOL, every gradient to GRAD_RTOL norm-relative (floored at
    1e-3 of the largest leaf; the unused leaves' zeros included), the
    parameters after the step to 0.25·lr·mult, except where the coupled
    gradient g' = g + wd·p is below 100·eps or has another sign on the card
    than on the CPU: Adam's first step is lr·g'/(|g'| + eps), which rounding
    of such a g' can move by up to lr either way, so those elements
    (counted) are held to 2·lr·mult. Then bf16 against fp32 on the card:
    cosine ≥ COSINE_FLOOR on text features and stage-2 eval features."""
    from mpreid_tpu_torch.engine.steps import trainable_params

    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    text32 = text.float()
    images, pids, views = uniprompt_images(seed=9)
    gen = np.random.default_rng(10)
    idx = gen.choice(BANK_IMAGES, CHECK_BATCH, replace=False)
    bank_rows = torch.from_numpy(
        gen.standard_normal((CHECK_BATCH, model.in_planes_proj)).astype(np.float32))
    target = torch.arange(CHECK_BATCH) // K_INST
    out, models = {}, {}
    for name, device in (("cpu", "cpu"), ("card", CARD)):
        c = uniprompt_cfg("float32", device)
        c.INPUT.PROB, c.INPUT.PADDING, c.INPUT.RE_PROB = 0.0, 0, 0.0
        m = build_model_uniprompt(c, UNI_CLASSES, 14, UNI_VIEWS)
        m.load_state_dict(weights, strict=True)
        m = m.to(device)
        models[name] = m
        res = {}
        opt1 = make_optimizer(c.SOLVER.STAGE1B, m, stage="stage1b")
        loss, grads = stage1_loss_and_grads(m, opt1, "1b", bank_rows.to(device), target.to(device),
                                            torch.from_numpy(views[idx]).to(device).long())
        train = trainable_params(m, opt1)
        opt1.update(grads, opt1.init(m), train, 1e-3)
        res["1b"] = (float(loss), {k: g.float().cpu() for k, g in grads.items()},
                     {k: p.detach().cpu().clone() for k, p in train.items()}, opt1, 1e-3)
        m.load_state_dict(weights, strict=True)
        loss_fn, _ = make_loss(c, UNI_CLASSES)
        opt2 = make_optimizer(c.SOLVER.STAGE2, m, stage="stage2a")
        x = eval_preprocess(torch.from_numpy(images[idx]).to(device),
                            mean=c.INPUT.PIXEL_MEAN, std=c.INPUT.PIXEL_STD)
        loss, _, grads, _ = loss_and_grads(m, c, loss_fn, opt2, x, target.to(device),
                                           text_features=text32.to(device))
        train = trainable_params(m, opt2)
        lr2 = 1e-3
        opt2.update(grads, opt2.init(m), train, lr2)
        res["2a"] = (float(loss), {k: g.float().cpu() for k, g in grads.items()},
                     {k: p.detach().cpu().clone() for k, p in train.items()}, opt2, lr2)
        m.load_state_dict(weights, strict=True)
        out[name] = res
    checks = {}
    for stage in ("1b", "2a"):
        (l_cpu, g_cpu, p_cpu, opt, lr), (l_gpu, g_gpu, p_gpu, _, _) = \
            out["cpu"][stage], out["card"][stage]
        floor = 1e-3 * max(g.norm().item() for g in g_cpu.values())
        zero = [k for k, g in g_cpu.items() if not bool(g.any())]
        worst_p, worst_all, n_small, n_flip, ok_p = 0.0, 0.0, 0, 0, True
        for k, p in p_cpu.items():
            err = (p_gpu[k] - p).abs() / (lr * opt.lr_mult[k])
            # Adam's first step is lr·g'/(|g'| + eps) with g' = g + wd·p: where
            # |g'| < 100·eps, or where the two devices' g' (held to GRAD_RTOL)
            # differ in sign, rounding of g' moves it by up to lr either way
            g_c, g_g = (g[k] + opt.wd[k] * weights[k] for g in (g_cpu, g_gpu))
            flip = torch.sign(g_c) != torch.sign(g_g)
            small = (g_c.abs() < 100 * opt.eps) | flip
            n_small += int(small.sum())
            n_flip += int(flip.sum())
            worst_p = max(worst_p, err[~small].max().item() if bool((~small).any()) else 0.0)
            worst_all = max(worst_all, err.max().item())
        ok_p = worst_p <= 0.25 and worst_all <= 2.0
        checks[stage] = dict(
            loss_rel=abs(l_gpu - l_cpu) / abs(l_cpu),
            worst_grad_rel=max(_rel_err(g_gpu[k], g, floor) for k, g in g_cpu.items()),
            zero_grad_leaves=len(zero), zero_on_card=all(not bool(g_gpu[k].any()) for k in zero),
            worst_param_err_lr_units=worst_p, elements_near_zero_step=n_small,
            elements_with_flipped_step=n_flip,
            worst_param_err_lr_units_near_zero_step=worst_all, leaves=len(g_cpu))
        log(f"uniprompt step cross-check {stage} {json.dumps(checks[stage])}")
        if not (checks[stage]["loss_rel"] <= LOSS_RTOL and checks[stage]["worst_grad_rel"]
                <= GRAD_RTOL and checks[stage]["zero_on_card"] and ok_p):
            raise AssertionError(f"stage {stage} step on the card differs from the CPU's: "
                                 f"{checks[stage]}")
    if checks["2a"]["zero_grad_leaves"] < 7:
        raise AssertionError(f"stage 2a: expected the unused leaves' zero gradients: {checks}")
    # text features fp32 card vs CPU on the first classes, and bf16 vs fp32
    labels = torch.arange(BATCH)
    with torch.no_grad():
        t_cpu = models["cpu"].get_text(labels, None, "2")
        t_card = models["card"].get_text(labels.to(CARD), None, "2").cpu()
        x8 = torch.from_numpy(images[idx[:CHECK_BATCH]])
        f32 = make_eval_step(models["card"], uniprompt_cfg("float32"))({"images": x8}).float()
    checks["text_fp32_card_vs_cpu_max_abs"] = (t_card - t_cpu).abs().max().item()
    del models
    c16 = uniprompt_cfg("bfloat16")
    m16 = build_model_uniprompt(c16, UNI_CLASSES, 14, UNI_VIEWS)
    m16.load_state_dict(weights, strict=True)
    m16 = m16.to(CARD).eval()
    with torch.no_grad():
        t16 = m16.get_text(labels.to(CARD), None, "2").float().cpu()
        f16 = make_eval_step(m16, c16)({"images": x8}).float()
    checks["text_bf16_vs_fp32_min_cosine"] = F.cosine_similarity(t16, t_card, dim=1).min().item()
    checks["eval_bf16_vs_fp32_min_cosine"] = F.cosine_similarity(f16, f32, dim=1).min().item()
    checks.update(loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL, cosine_floor=COSINE_FLOOR)
    log(f"uniprompt cross-checks {json.dumps(checks)}")
    if checks["text_fp32_card_vs_cpu_max_abs"] > 1e-3:
        raise AssertionError(f"fp32 text features differ between the card and the CPU: {checks}")
    if min(checks["text_bf16_vs_fp32_min_cosine"],
           checks["eval_bf16_vs_fp32_min_cosine"]) < COSINE_FLOOR:
        raise AssertionError(f"bf16 vs fp32 cosine below {COSINE_FLOOR}: {checks}")
    return checks


# ---------------------------------------------------------------------------
# the TTA / TTPT eval modes and the margin heads (MODEL.COS_LAYER)
# ---------------------------------------------------------------------------

def ttpt_cfg(tta: bool, ttpt: bool, dtype: str = "bfloat16", device: str = CARD):
    """configs/ours/cctv_ir_cctv_rgb.yml's settings with the eval modes set
    as ``test_uniprompt`` takes them, TEST.TTPT.STEPS TTPT_STEPS."""
    cfg = uniprompt_cfg(dtype, device)
    cfg.TEST.TTA_ENABLED, cfg.TEST.TTPT.ENABLED = tta, ttpt
    cfg.TEST.TTPT.STEPS = TTPT_STEPS
    return cfg


def query_agg(model, cfg, images: np.ndarray, device) -> torch.Tensor:
    """TTPT's query input for uint8 ``images``, as ``do_inference_ttpt`` builds it."""
    x = eval_preprocess(torch.from_numpy(images).to(device), mean=cfg.INPUT.PIXEL_MEAN,
                        std=cfg.INPUT.PIXEL_STD)
    return ttpt_query_input(model, cfg, x)


def run_ttpt(model, profile: bool) -> dict:
    """The TTA / TTPT eval modes (``test_uniprompt``'s branches) on the
    Uni-Prompt model after stage 2, over TTPT_QUERY + TTPT_GALLERY seeded
    images at batch 64, bf16: Option A through ``do_inference_ttpt`` with
    TTA on and TTPT off (4 vision forwards a query batch), then Option B
    with TTA on (2 vision forwards a query batch and, for each, TTPT_STEPS
    + 1 text forwards and TTPT_STEPS backwards over all UNI_CLASSES
    classes); each with its launches, all on "tc". Then one query batch's
    tuning alone, timed, and its entropy trace (``profile``: traced, by
    kernel and operator group, with the device's idle share)."""
    vdepth = len(model.image_encoder.transformer.resblocks)
    tdepth = len(model.text_encoder.transformer.resblocks)
    loader = InMemoryBatcher(TTPT_QUERY, TTPT_GALLERY, BATCH, HW, seed=13)
    nq, ng = TTPT_QUERY // BATCH, TTPT_GALLERY // BATCH
    n = TTPT_QUERY + TTPT_GALLERY
    res = {}
    cfg = ttpt_cfg(tta=True, ttpt=False)
    do_inference_ttpt(cfg, model, InMemoryBatcher(BATCH, BATCH, BATCH, HW, seed=14), BATCH)
    reset_counts()
    (r1, r5), secs = timed(lambda: do_inference_ttpt(cfg, model, loader, TTPT_QUERY))
    counts = read_counts()
    expect_counts("TTA (Option A)", counts, {"attention_fwd": vdepth * (4 * nq + ng)})
    res["tta"] = dict(images=n, seconds=secs, images_per_s=n / secs,
                      query_images_per_s=TTPT_QUERY / secs, rank1=r1, rank5=r5,
                      launches=counts)

    cfg = ttpt_cfg(tta=True, ttpt=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (r1, r5), secs = timed(lambda: do_inference_ttpt(cfg, model, loader, TTPT_QUERY))
    counts = read_counts()
    expect_counts("TTPT (Option B)", counts, {
        "attention_fwd": vdepth * (2 * nq + ng) + tdepth * (TTPT_STEPS + 1) * nq,
        "attention_bwd": tdepth * TTPT_STEPS * nq})
    peak = torch.cuda.max_memory_allocated() / 1e9
    tuner = make_ttpt_tuner(model, cfg)
    agg = query_agg(model, cfg, loader.images[:BATCH], CARD)
    tune_s = []
    for _ in range(3):
        (feats, trace, sim), t = timed(lambda: tuner(agg))
        tune_s.append(t)
    trace = trace.cpu().tolist()
    if not (np.isfinite(trace).all() and len(trace) == TTPT_STEPS
            and bool(torch.isfinite(feats).all()) and tuple(feats.shape) == tuple(agg.shape)
            and tuple(sim.shape) == (BATCH, UNI_CLASSES)):
        raise AssertionError(f"TTPT tuner: trace {trace}, features {tuple(feats.shape)}")
    res["ttpt"] = dict(images=n, seconds=secs, query_images_per_s=TTPT_QUERY / secs,
                       steps=TTPT_STEPS, classes=UNI_CLASSES, rank1=r1, rank5=r5,
                       peak_mem_gb=peak, launches=counts,
                       seconds_per_tuned_batch=statistics.median(tune_s),
                       tuned_batch_seconds=tune_s, entropy_trace=trace)
    if profile:
        res["tuner_profile"] = profile_idle(
            lambda: tuner(agg), f"one tuned query batch ({TTPT_STEPS} steps, text B "
                                f"{UNI_CLASSES}, bf16)",
            TTPT_OP_GROUPS)
    log(f"TTA / TTPT {json.dumps(res)}")
    return res


def ttpt_cross_check(model) -> dict:
    """The tuner in fp32 on the card against the CPU, on the full-width
    towers with the classes cut to TTPT_CHECK_CLASSES and the queries to
    TTPT_CHECK_QUERIES (so the CPU side ends in seconds): the same query
    input (the CPU's), entropy trace to TTPT_TRACE_RTOL norm-relative, the
    chosen classes equal except where the CPU's top-2 similarities lie
    within TTPT_NEAR_TIE of each other (relative to the row's largest), and
    the tuned features of the rows whose classes agree to TTPT_FEAT_ATOL."""
    sliced = ("prompt_learner.ctx_generic", "classifier.weight", "classifier_proj.weight")
    weights = {k: (v[:TTPT_CHECK_CLASSES] if k in sliced else v).detach().cpu()
               for k, v in model.state_dict().items()}
    images = InMemoryBatcher(TTPT_QUERY, TTPT_GALLERY, BATCH, HW, seed=13).images
    out, agg = {}, None
    for device in ("cpu", CARD):
        c = ttpt_cfg(tta=True, ttpt=True, dtype="float32", device=device)
        m = build_model_uniprompt(c, TTPT_CHECK_CLASSES, 14, UNI_VIEWS)
        m.load_state_dict(weights, strict=True)
        m = m.to(device).eval()
        if agg is None:
            agg = query_agg(m, c, images[:TTPT_CHECK_QUERIES], "cpu")
        (feats, trace, sim), secs = timed(lambda: make_ttpt_tuner(m, c)(agg.to(device)))
        out[device] = (feats.cpu(), trace.cpu(), sim.cpu(), secs)
        del m
    (f_cpu, t_cpu, s_cpu, cpu_s), (f_card, t_card, s_card, _) = out["cpu"], out[CARD]
    top2 = s_cpu.topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) < TTPT_NEAR_TIE * s_cpu.abs().amax(dim=1)
    same = s_cpu.argmax(1) == s_card.argmax(1)
    diff = (f_card - f_cpu).abs().amax(dim=1)
    res = dict(classes=TTPT_CHECK_CLASSES, queries=TTPT_CHECK_QUERIES, steps=TTPT_STEPS,
               trace_rel=_rel_err(t_card, t_cpu), trace_rtol=TTPT_TRACE_RTOL,
               classes_differ=int((~same).sum()), near_ties=int(near_tie.sum()),
               feat_max_abs=diff[same].max().item() if bool(same.any()) else float("inf"),
               feat_atol=TTPT_FEAT_ATOL, trace_cpu=t_cpu.tolist(), cpu_seconds=cpu_s)
    log(f"TTPT tuner fp32 card vs CPU {json.dumps(res)}")
    if not (res["trace_rel"] <= TTPT_TRACE_RTOL and bool((same | near_tie).all())
            and res["feat_max_abs"] <= TTPT_FEAT_ATOL):
        raise AssertionError(f"the TTPT tuner on the card differs from the CPU's: {res}")
    return res


def margin_cfg(kind: str, dtype: str = "bfloat16", device: str = CARD, fused: bool = False):
    """configs/person/vit_base.yml with MODEL.COS_LAYER on, the head ``kind``."""
    cfg = vit_base_cfg(dtype, device)
    cfg.MODEL.COS_LAYER, cfg.MODEL.COS_LAYER_TYPE = True, kind
    cfg.SOLVER.FUSED_ADAM = fused
    return cfg


def run_margin() -> dict:
    """The margin heads in the baseline training path at full width
    (configs/person/vit_base.yml, 751 classes, PK 16 × 4, bf16, Adam; the
    last kind with SOLVER.FUSED_ADAM): per kind, MARGIN_STEPS train steps
    on one PK batch with augmentation off, so each step's loss is the same
    batch's before its update and must fall from the first step to the
    last (with augmentation on, the draws move it by more than a few steps
    at lr 5e-6 do); 12 + 12 attention launches a step, all on "tc"; then one
    fp32 step card vs CPU."""
    images, pids = train_images(seed=15)
    batch = pk_batches(images, pids, 1, seed=16)[0]
    check = check_batch()
    res = {}
    for kind in MARGIN_KINDS:
        fused = kind == MARGIN_KINDS[-1]
        cfg = margin_cfg(kind, fused=fused)
        cfg.INPUT.PROB, cfg.INPUT.PADDING, cfg.INPUT.RE_PROB = 0.0, 0, 0.0
        t0 = time.perf_counter()
        model = make_model(cfg, num_class=NUM_CLASSES, camera_num=6, view_num=1)
        depth = len(model.image_encoder.transformer.resblocks)
        loss_fn, _ = make_loss(cfg, NUM_CLASSES)
        opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
        train, _ = opt.partition(model)
        big = sum(p.numel() >= adam.MIN_FUSED_SIZE for p in train.values())
        lr = cfg.SOLVER.BASE_LR
        state = initial_state(model, opt)
        step = make_train_step(model, cfg, loss_fn, opt)
        gen = torch.Generator(device=CARD).manual_seed(int(cfg.SOLVER.SEED))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reset_counts()
        losses, seconds = [], []
        for _ in range(MARGIN_STEPS):
            (state, metrics), secs = timed(lambda: step(state, batch, lr, gen))
            losses.append(float(metrics["loss"]))
            seconds.append(secs)
        counts = read_counts()
        expect_counts(f"margin head {kind}", counts, {
            "attention_fwd": depth * MARGIN_STEPS, "attention_bwd": depth * MARGIN_STEPS,
            "adam": big * MARGIN_STEPS if fused else 0})
        res[kind] = dict(fused_adam=fused, lr=lr, steps=MARGIN_STEPS, batch=BATCH, losses=losses,
                         step_seconds=seconds, setup_seconds=setup_s, launches=counts)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"margin head {kind}: losses {res[kind]}")
        weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model, state, step, opt, train
        (l_cpu, g_cpu), (l_card, g_card) = (
            step_loss_and_grads(weights, margin_cfg(kind, "float32", device), check, device)
            for device in ("cpu", CARD))
        res[kind]["fp32_card_vs_cpu"] = dict(loss_rel=abs(l_card - l_cpu) / abs(l_cpu),
                                             worst_grad_rel=worst_grad_rel(g_card, g_cpu),
                                             loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL)
        log(f"margin head {kind} {json.dumps(res[kind])}")
        cross = res[kind]["fp32_card_vs_cpu"]
        if not (cross["loss_rel"] <= LOSS_RTOL and cross["worst_grad_rel"] <= GRAD_RTOL):
            raise AssertionError(f"margin head {kind}: fp32 step on the card differs from the "
                                 f"CPU's: {cross}")
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the device-resident epoch (TPU.DEVICE_DATASET) and the trace (TPU.PROFILE_DIR)
# ---------------------------------------------------------------------------

def market_train_set(seed: int = 31):
    """Seeded uint8 images at Market-1501's train size (12,936 × 256×128,
    751 identities of 17 or 18 images, cameras 0-5): a per-identity pattern
    plus per-image noise, drawn on the card in chunks and held on the host,
    as a loader holds decoded images."""
    n, ids = MARKET_TRAIN["images"], MARKET_TRAIN["ids"]
    rng = np.random.default_rng(seed)
    pids = np.sort(np.arange(n) % ids).astype(np.int32)
    cams = rng.integers(0, MARKET_TRAIN["cams"], n).astype(np.int32)
    gen = torch.Generator(device=CARD).manual_seed(seed)
    base = torch.randint(40, 215, (ids, *HW, 3), generator=gen, device=CARD, dtype=torch.int16)
    images = np.empty((n, *HW, 3), np.uint8)
    pid_t = torch.from_numpy(pids).to(CARD).long()
    for lo in range(0, n, 1024):
        sel = pid_t[lo:lo + 1024]
        noise = torch.randint(-60, 61, (len(sel), *HW, 3), generator=gen, device=CARD,
                              dtype=torch.int16)
        images[lo:lo + len(sel)] = (base[sel] + noise).clamp_(0, 255).to(torch.uint8).cpu().numpy()
    return images, pids, cams


def trace_idle_share(path: str) -> dict:
    """The device's busy time and idle share over a Chrome trace that
    ``torch.profiler`` wrote: the union of its kernel, copy and memset spans
    against the span of every event in it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for lo, hi in device:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    window = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return dict(trace_bytes=os.path.getsize(path), events=len(events), device_spans=len(device),
                window_ms=window / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1 - busy / window)


def run_device_epoch() -> dict:
    """configs/person/vit_base.yml with TPU.DEVICE_DATASET on at Market-1501's
    train size: do_train for 2 epochs with TPU.PROFILE_DIR (the second epoch
    traced), counting the attention launches; then EPOCH_CHECK_STEPS steps
    of the device epoch and of the step loop over the same perm rows from
    one state and one generator state, and both modes' img/s in turns."""
    cfg = vit_base_cfg(device=CARD)
    cfg.TPU.DEVICE_DATASET = True
    t0 = time.perf_counter()
    images, pids, cams = market_train_set()
    seed = int(cfg.SOLVER.SEED)
    batcher = MemoryBatcher(images, pids, BATCH, cams)
    loader = TrainLoader(batcher, RandomIdentitySampler(batcher.records, BATCH, K_INST, seed=seed))
    n_epoch = [len(epoch_perm(loader, e, seed)) for e in (1, 2)]
    if n_epoch[0] != n_epoch[1]:
        raise AssertionError(f"device epochs of {n_epoch} batches: the count must be epoch 0's")
    model = make_model(cfg, num_class=MARKET_TRAIN["ids"], camera_num=MARKET_TRAIN["cams"],
                       view_num=1)
    depth = len(model.image_encoder.transformer.resblocks)
    loss_fn, _ = make_loss(cfg, MARKET_TRAIN["ids"])
    optimizer = make_optimizer(cfg.SOLVER, model, stage="baseline")
    lr = make_scheduler(cfg.SOLVER, "multistep")(1)
    resident = images.nbytes + 3 * 4 * len(pids)
    log(f"device epoch: {len(pids)} images of {HW[0]}×{HW[1]}, {MARKET_TRAIN['ids']} ids, "
        f"{resident} resident bytes, {n_epoch[0]} batches an epoch, set up in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, train_log() as records:
        cfg.TPU.PROFILE_DIR = tmp
        reset_counts()
        (state, history), secs = timed(lambda: do_train(
            cfg, model, loader, None, optimizer, lambda e: lr, loss_fn, QUERY, max_epochs=2))
        counts = read_counts()
        t0 = time.perf_counter()
        trace = trace_idle_share(os.path.join(tmp, TRACE_FILE))
        trace["parse_seconds"] = time.perf_counter() - t0
    # the traced epoch's Speed counts the trace's stop and export too
    speeds = [float(re.search(r"Speed: ([0-9.]+)", r.getMessage()).group(1))
              for r in records if "done." in r.getMessage()]
    expect_counts("device-epoch do_train", counts, {"attention_fwd": depth * 2 * n_epoch[0],
                                                    "attention_bwd": depth * 2 * n_epoch[0]})
    if state.opt_state.step != 2 * n_epoch[0] or not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"device-epoch do_train: {state.opt_state.step} steps, {history}")
    if trace["trace_bytes"] <= 0 or trace["device_spans"] <= 0:
        raise AssertionError(f"empty trace of the second epoch: {trace}")
    res = dict(config="configs/person/vit_base.yml + TPU.DEVICE_DATASET", images=len(pids),
               ids=MARKET_TRAIN["ids"], resident_bytes=resident, batches_per_epoch=n_epoch,
               do_train_seconds_2_epochs=secs, epoch_img_per_s_log=speeds, history=history,
               launches=counts,
               launches_by_route=read_routes(), traced_epoch_2=trace,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"device epoch do_train {json.dumps(res)}")

    # the device epoch against the step loop, from one state and one generator state
    data = build_device_dataset(loader, next(model.parameters()).device)
    runs = {}
    for mode in ("epoch", "steps"):
        m = copy.deepcopy(model)
        opt = make_optimizer(cfg.SOLVER, m, stage="baseline")
        runs[mode] = dict(model=m, opt=opt, state=initial_state(m, opt),
                          gen=torch.Generator(device=CARD).manual_seed(seed + 5),
                          epoch=make_train_epoch(m, cfg, loss_fn, opt),
                          step=make_train_step(m, cfg, loss_fn, opt))

    def turn(mode, rows):
        r = runs[mode]
        if mode == "epoch":
            r["state"], (losses, _) = r["epoch"](r["state"], *data, rows, lr, r["gen"])
            return losses
        out = []
        for batch in batcher.iter_indices(rows.reshape(-1), drop_last=True):
            r["state"], metrics = r["step"](r["state"], batch, lr, r["gen"])
            out.append(metrics["loss"])
        return torch.stack(out)

    rows = epoch_perm(loader, 3, seed)[:EPOCH_CHECK_STEPS]
    losses = {mode: turn(mode, rows).float().cpu() for mode in runs}
    (pa, pb) = (dict(runs[m]["model"].named_parameters()) for m in ("epoch", "steps"))
    mult = runs["epoch"]["opt"].lr_mult
    param_err = max(((pa[k] - pb[k]).abs().max() / (lr * mult[k])).item() for k in mult)
    bit_equal = torch.equal(losses["epoch"], losses["steps"]) and \
        all(torch.equal(pa[k], pb[k]) for k in pa)
    loss_rel = ((losses["epoch"] - losses["steps"]).abs() / losses["steps"].abs()).max().item()
    check = dict(steps=EPOCH_CHECK_STEPS, bit_equal=bit_equal, max_loss_rel=loss_rel,
                 max_param_err_lr_units=param_err, loss_rtol=1e-3,
                 param_tol_lr_units=2 * EPOCH_CHECK_STEPS)
    log(f"device epoch against the step loop {json.dumps(check)}")
    if not (loss_rel <= 1e-3 and param_err <= 2 * EPOCH_CHECK_STEPS):
        raise AssertionError(f"the device epoch differs from the step loop: {check}")

    # both modes' rates, in turns: (epoch, steps, steps, epoch) per round
    rates = {"epoch": [], "steps": []}
    for rnd in range(EPOCH_TURNS):
        for i, mode in enumerate(("epoch", "steps", "steps", "epoch")):
            rows = epoch_perm(loader, 10 + 4 * rnd + i, seed)[:EPOCH_CHECK_STEPS]
            _, secs = timed(lambda: turn(mode, rows))
            rates[mode].append(EPOCH_CHECK_STEPS * BATCH / secs)
    res_rates = dict(steps_per_turn=EPOCH_CHECK_STEPS, batch=BATCH, order="epoch steps steps "
                     "epoch, twice", img_per_s=rates,
                     median_img_per_s={k: float(np.median(v)) for k, v in rates.items()},
                     card=CARD_LINE)
    log(f"device epoch against the step loop, img/s in turns {json.dumps(res_rates)}")
    rate_line("device-epoch vs step-loop train img/s (configs/person/vit_base.yml, batch 64, "
              "medians of 4 turns of 24 steps)", res_rates["median_img_per_s"])
    del runs, data
    return dict(res=res, check=check, rates=res_rates)


# ---------------------------------------------------------------------------
# the MoE Uni-Prompt pipeline (configs/tpu/uniprompt_tuned.yml, MoE 4/2/2)
# ---------------------------------------------------------------------------

def dense_model(cfg, weights: dict):
    """The dense Uni-Prompt model of ``cfg`` (MoE off) with ``weights``."""
    dense = cfg.clone()
    dense.MODEL.MOE.ENABLED = False
    m = build_model_uniprompt(dense, UNI_CLASSES, 14, UNI_VIEWS)
    m.load_state_dict(weights, strict=True)
    return m.to(dense.MODEL.DEVICE).eval()


def upcycle_check(weights: dict, images: np.ndarray) -> dict:
    """The upcycled MoE model's eval features against the dense model's on
    the same weights: fp32 to UPCYCLE_TOL max abs, bf16 cosine ≥ COSINE_FLOOR."""
    x = torch.from_numpy(images[:BATCH]).to(CARD)
    feats = {}
    for dtype in ("float32", "bfloat16"):
        cfg = tuned_cfg(dtype)
        dense = dense_model(cfg, weights)
        moe = switch_to_moe(cfg, dense)
        step_d, step_m = make_eval_step(dense, cfg), make_eval_step(moe, cfg)
        feats[dtype] = (step_d({"images": x}).float(), step_m({"images": x}).float())
        del dense, moe
    (d32, m32), (d16, m16) = feats["float32"], feats["bfloat16"]
    res = dict(fp32_max_abs=(m32 - d32).abs().max().item(), fp32_feature_max=d32.abs().max().item(),
               bf16_min_cosine=F.cosine_similarity(m16, d16, dim=1).min().item(),
               fp32_tol=UPCYCLE_TOL, cosine_floor=COSINE_FLOOR)
    log(f"upcycled against dense {json.dumps(res)}")
    if not (res["fp32_max_abs"] <= UPCYCLE_TOL and res["bf16_min_cosine"] >= COSINE_FLOOR):
        raise AssertionError(f"the upcycled model differs from the dense one: {res}")
    return res


@contextlib.contextmanager
def train_log():
    """The training loops' log records at INFO while the block runs (the
    "Epoch N done" lines carry each epoch's Speed)."""
    logger = logging.getLogger("mpreid_tpu_torch.train")
    records, level = [], logger.level
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def speed_from_log(records: list) -> float:
    """The samples/s of the last "Epoch N done" line among log records."""
    lines = [r.getMessage() for r in records if "done." in r.getMessage()]
    return float(re.search(r"Speed: ([0-9.]+)", lines[-1]).group(1))


def block_ms(model) -> dict:
    """Device time of one MoE block and of one dense block of the tower,
    forward and backward with every weight gradient (bf16, B 64, L 129)."""
    blocks = model.image_encoder.transformer.resblocks
    gen = torch.Generator(device=CARD).manual_seed(13)
    x = torch.randn(BATCH, VISION["l"], model.image_encoder.width, device=CARD,
                    dtype=model.dtype, generator=gen).requires_grad_(True)

    for p in blocks.parameters():
        p.requires_grad_(True)

    def fwd_bwd(block):
        out = block(x)
        out = out[0] if isinstance(out, tuple) else out  # an MoE block's (x, logits, combine)
        torch.autograd.grad(out.float().square().mean(), [x, *block.parameters()])

    return dict(moe=cuda_ms(lambda: fwd_bwd(blocks[0]), runs=10, reps=3),
                dense=cuda_ms(lambda: fwd_bwd(blocks[-1]), runs=10, reps=3))


def run_uniprompt_moe(after_1b: dict, images, pids, views, profile: bool) -> dict:
    """Phase 8's model after stage 1b, upcycled (``switch_to_moe``) under
    configs/tpu/uniprompt_tuned.yml with MoE 4/2/2: features against the
    dense model, the all-tie routing at step 0, one stage-2a and one
    stage-2b epoch through do_train_stage2 over the device-resident train
    set, and do_inference; each with its attention launches. Then the
    device time of an MoE block against a dense one and, with ``profile``,
    the device's busy time and idle share over three traced stage-2b steps."""
    cfg = tuned_cfg()
    res = dict(config="configs/ours/cctv_ir_cctv_rgb.yml + configs/tpu/uniprompt_tuned.yml, "
                      "MODEL.MOE 4 experts top-2 2 layers")
    res["upcycle"] = upcycle_check(after_1b, images)
    model = switch_to_moe(cfg, dense_model(cfg, after_1b))
    vdepth = len(model.image_encoder.transformer.resblocks)
    tdepth = len(model.text_encoder.transformer.resblocks)
    blocks = model.image_encoder.transformer.resblocks[:MOE_BENCH["MOE_LAYERS"]]
    gates = [f"image_encoder.transformer.resblocks.{i}.gate.weight" for i in range(len(blocks))]

    # the upcycled model at step 0: zero gates, every token ties, experts 0 and 1
    x = eval_preprocess(torch.from_numpy(images[:BATCH]).to(CARD), mean=cfg.INPUT.PIXEL_MEAN,
                        std=cfg.INPUT.PIXEL_STD)
    with torch.no_grad():
        logits = model.image_encoder(x)[3]
    _, selected = topk_routing(logits[0], MOE_BENCH["TOP_K"])
    ties = dict(tokens=int(selected.shape[0]), gating_blocks=int(logits.shape[0]),
                zero_logits=not bool(logits.any()),
                all_experts_0_1=bool((selected == torch.tensor([0, 1], device=CARD)).all()))
    log(f"all-tie routing at step 0 {json.dumps(ties)}")
    if not (ties["zero_logits"] and ties["all_experts_0_1"]):
        raise AssertionError(f"upcycled routing does not pick experts 0 and 1: {ties}")
    res["tie_routing"] = ties

    # stage 2a and 2b: one epoch each over the device-resident train set
    sub = np.flatnonzero(pids < MOE_IDS)
    batcher = MemoryBatcher(images[sub], pids[sub], BATCH, views[sub])
    loader = TrainLoader(batcher, RandomIdentitySampler(batcher.records, BATCH, K_INST,
                                                        seed=int(cfg.SOLVER.SEED)))
    n = len(epoch_perm(loader, 1, int(cfg.SOLVER.SEED)))
    n_text = -(-UNI_CLASSES // cfg.SOLVER.STAGE2.IMS_PER_BATCH)
    loss_fn, _ = make_loss(cfg, UNI_CLASSES)
    for stage in ("stage2a", "stage2b"):
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage=stage)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with train_log() as records:
            (state, hist), secs = timed(lambda: do_train_stage2(
                cfg, model, loader, None, opt, make_scheduler(cfg.SOLVER.STAGE2, "multistep"),
                loss_fn, QUERY, UNI_CLASSES, max_epochs=1))
        counts = read_counts()
        expect_counts(f"MoE {stage} epoch", counts, {
            "attention_fwd": tdepth * n_text + vdepth * n, "attention_bwd": vdepth * n})
        with torch.no_grad():
            aux = load_balancing_loss(model.image_encoder(x)[3][0], MOE_BENCH["TOP_K"]).item()
        moved = {k: not torch.equal(p.detach(), before[k]) for k, p in model.named_parameters()}
        experts = [k for k in moved if ".experts." in k]
        if state.opt_state.step != n or not np.isfinite(hist[0]["loss"]) or not np.isfinite(aux):
            raise AssertionError(f"MoE {stage}: {state.opt_state.step} steps, {hist}, aux {aux}")
        if not all(moved[g] for g in gates[:1]) or any(moved[k] for k in experts):
            raise AssertionError(f"MoE {stage}: gates moved {[moved[g] for g in gates]}, "
                                 f"experts moved {[k for k in experts if moved[k]]}")
        res[stage] = dict(steps=n, batch=BATCH, seconds_with_text_and_data=secs,
                          img_per_s_epoch_log=speed_from_log(records), loss=hist[0]["loss"],
                          acc=hist[0]["acc"], aux_loss=aux, gates_moved=[moved[g] for g in gates],
                          experts_moved=any(moved[k] for k in experts), launches=counts,
                          attention_per_step={"fwd": vdepth, "bwd": vdepth},
                          launches_by_route=read_routes(),
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"MoE {stage} {json.dumps(res[stage])}")

    res["block_ms"] = block_ms(model)
    log(f"MoE block against dense block, forward and backward {json.dumps(res['block_ms'])}")
    if profile:
        step = make_train_step(model, cfg, loss_fn, opt, uniprompt=True,
                               text_features=precompute_text_features(cfg, model, UNI_CLASSES))
        batches = pk_batches(images[sub], pids[sub], 3, seed=14)
        gen = torch.Generator(device=CARD).manual_seed(15)
        step(state, batches[0], 1e-6, gen)  # warm-up
        res["stage2b_profile"] = profile_idle(
            lambda: [step(state, b, 1e-6, gen) for b in batches],
            "3 MoE stage-2b steps (bf16, batch 64)")

    loader_eval = InMemoryBatcher(QUERY, GALLERY, cfg.TEST.IMS_PER_BATCH, HW)
    reset_counts()
    (r1, r5), secs = timed(lambda: do_inference(cfg, model, loader_eval, QUERY))
    counts = read_counts()
    expect_counts("MoE do_inference", counts, {
        "attention_fwd": vdepth * -(-(QUERY + GALLERY) // cfg.TEST.IMS_PER_BATCH)})
    res["inference"] = dict(images=QUERY + GALLERY, batch=cfg.TEST.IMS_PER_BATCH, seconds=secs,
                            feats_per_s=(QUERY + GALLERY) / secs, rank1=float(r1),
                            rank5=float(r5), launches=counts)
    log(f"MoE uniprompt {json.dumps(res)}")
    rate_line("MoE stage-2a / 2b train img/s (uniprompt_tuned.yml, MoE 4/2/2, device epoch, "
              "batch 64, the epoch's own Speed)",
              {s: res[s]["img_per_s_epoch_log"] for s in ("stage2a", "stage2b")})
    return res


def moe_cross_checks(images: np.ndarray) -> dict:
    """One stage-2b step at batch 8 (augmentation off) of an MoE model with
    distinct random experts and gates, fp32 on the card against fp32 on the
    CPU: the loss (with the load-balancing term) to LOSS_RTOL, every
    gradient, the gates' included, to GRAD_RTOL norm-relative (floored at
    1e-3 of the largest leaf)."""
    c_cpu = tuned_cfg("float32", device="cpu")
    cpu_model = make_model_uniprompt(c_cpu, MOE_CHECK_CLASSES, 14, UNI_VIEWS, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(CARD)
    text = precompute_text_features(c_cpu, cpu_model, MOE_CHECK_CLASSES)
    target = torch.arange(CHECK_BATCH) // K_INST
    x = eval_preprocess(torch.from_numpy(images[:CHECK_BATCH]), mean=c_cpu.INPUT.PIXEL_MEAN,
                        std=c_cpu.INPUT.PIXEL_STD)
    loss_fn, _ = make_loss(c_cpu, MOE_CHECK_CLASSES)
    out = {}
    for name, m, dev in (("cpu", cpu_model, "cpu"), ("card", card_model, CARD)):
        opt = make_optimizer(c_cpu.SOLVER.STAGE2, m, stage="stage2b")
        loss, _, grads, _ = loss_and_grads(m, c_cpu, loss_fn, opt, x.to(dev), target.to(dev),
                                           text_features=text.to(dev))
        out[name] = (float(loss), {k: g.float().cpu() for k, g in grads.items()})
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["card"]
    floor = 1e-3 * max(g.norm().item() for g in g_cpu.values())
    gates = [k for k in g_cpu if k.endswith("gate.weight")]
    res = dict(loss_rel=abs(l_card - l_cpu) / abs(l_cpu),
               worst_grad_rel=max(_rel_err(g_card[k], g, floor) for k, g in g_cpu.items()),
               worst_gate_grad_rel=max(_rel_err(g_card[k], g_cpu[k], floor) for k in gates),
               gate_grad_norms=[g_cpu[k].norm().item() for k in gates], leaves=len(g_cpu),
               loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL)
    log(f"MoE stage-2b step cross-check {json.dumps(res)}")
    if not (res["loss_rel"] <= LOSS_RTOL and res["worst_grad_rel"] <= GRAD_RTOL
            and len(gates) == MOE_BENCH["MOE_LAYERS"] and res["gate_grad_norms"][0] > 0):
        raise AssertionError(f"the MoE stage-2b step on the card differs from the CPU's: {res}")
    return res


# configs/person/cnn_base.yml, configs/person/cnn_clipreid.yml and
# configs/veri/cnn_prom.yml, built in code; tests/test_torch_package.py holds
# each to its file
CNN_BASE = {**VIT_BASE, "MODEL": {**VIT_BASE["MODEL"], "NAME": "RN50"},
            "SOLVER": {**VIT_BASE["SOLVER"], "BASE_LR": 0.00035},
            "OUTPUT_DIR": "output/person_cnn_base"}
CNN_CLIPREID = {**UNIPROMPT, "MODEL": {**UNIPROMPT["MODEL"], "NAME": "RN50"},
                "DATASETS": {"NAMES": "market1501", "ROOT_DIR": "../data"},
                "OUTPUT_DIR": "output/person_cnn_clipreid"}
CNN_PROM = {**CNN_CLIPREID, "INPUT": VERI["INPUT"],
            "DATASETS": {"NAMES": "veri", "ROOT_DIR": "../data"},
            "OUTPUT_DIR": "output/veri_cnn_prom"}
VIT_FILE_GRID, RN50_FILE_GRID = 14, 7  # the OpenAI files' grids (224 input)
RN50_EVAL_RUNS = 3
RN50_TRAIN_STEPS = 3  # timed, after a warm-up step
RN50_BANK = 1024  # stage-1 bank images of the RN50 Uni-Prompt phase
RN50_STAGE1_STEPS = 8  # per stage, on the bank's first 8 × 64 rows
RN50_STAGE2A_STEPS = 8
# BatchNorm running statistics after one fp32 train step, card vs CPU
RN50_STATS_RTOL = 1e-3
# where an RN50 step's device time goes, by operator
RN50_OP_GROUPS = {"convolution": ["convolution"], "batch_norm": ["batch_norm"],
                  "casts": ["aten::copy_"], "avg_pool": ["avg_pool"],
                  "matmul": ["aten::mm", "aten::bmm", "aten::addmm"],
                  "softmax": ["softmax"]}
RN50_BF16_LOSS_RTOL = 1e-2  # bf16 vs fp32 train loss (0.2% on the CPU)


def rate_line(what: str, res: dict) -> None:
    """A rate of this run, marked with the card it was taken on."""
    log(f"rate {json.dumps(dict(what=what, card=CARD_LINE, **res))}")


def clip_loader_check(tmp: str) -> dict:
    """A seeded full-width OpenAI-layout ViT-B/16 file (224 input: 14×14+1
    positions, fp16 as OpenAI ships it) written as a plain state_dict and as a
    ``torch.jit`` archive, each loaded with ``load_pretrained`` into
    configs/person/vit_base.yml's model: both give the same weights, the
    positions are resized to 16×8+1, and fp32 eval features on the card
    agree with the same load on the CPU to 1e-3; bf16 on the card against
    fp32 to cosine COSINE_FLOOR, its 12 forward launches on "tc"."""
    paths = {}
    t0 = time.perf_counter()
    for jit in (False, True):
        paths[jit] = make_clip_file(os.path.join(tmp, f"ViT-B-16{'-jit' * jit}.pt"), VIT_B16,
                                    VIT_FILE_GRID, seed=21, jit=jit, half=True)
    write_s = time.perf_counter() - t0
    images = next(InMemoryBatcher(8, 8, 8, HW, seed=3).iter_sequential())["images"]
    feats, weights = {}, {}
    for name, dtype, device, jit in (("fp32_cpu", "float32", "cpu", False),
                                     ("fp32_card", "float32", CARD, False),
                                     ("fp32_card_jit", "float32", CARD, True),
                                     ("bf16_card", "bfloat16", CARD, True)):
        cfg = vit_base_cfg(dtype, device)
        cfg.MODEL.PRETRAIN_PATH = paths[jit]
        model = make_model(cfg, NUM_CLASSES, 6, 1)
        seeded = model.image_encoder.proj.detach().clone()
        t0 = time.perf_counter()
        load_pretrained(model, cfg)
        load_s = time.perf_counter() - t0
        if torch.equal(model.image_encoder.proj.detach(), seeded) or \
                tuple(model.image_encoder.positional_embedding.shape) != (129, model.in_planes):
            raise AssertionError("the CLIP file did not replace the vision tower")
        if name.startswith("fp32_card"):
            weights[name] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        reset_counts()
        feats[name] = make_eval_step(model, cfg)({"images": images}).float().cpu()
        if name == "bf16_card":
            expect_counts("CLIP-loaded bf16 eval batch", read_counts(),
                          {"attention_fwd": len(model.image_encoder.transformer.resblocks)})
        del model
    same = all(torch.equal(v, weights["fp32_card_jit"][k]) for k, v in weights["fp32_card"].items())
    err = (feats["fp32_card"] - feats["fp32_cpu"]).abs().max().item()
    cos = F.cosine_similarity(feats["bf16_card"], feats["fp32_card"], dim=1).min().item()
    res = dict(file="ViT-B-16, 14x14+1 positions, fp16, plain and torch.jit",
               file_mb=os.path.getsize(paths[False]) / 1e6, write_seconds=write_s,
               load_seconds=load_s, archive_equals_plain=same, fp32_card_vs_cpu_max_abs=err,
               fp32_tol=1e-3, bf16_vs_fp32_min_cosine=cos, cosine_floor=COSINE_FLOOR,
               finite=all(bool(torch.isfinite(f).all()) for f in feats.values()))
    log(f"CLIP loader {json.dumps(res)}")
    if not (same and err <= 1e-3 and cos >= COSINE_FLOOR and res["finite"]):
        raise AssertionError(f"CLIP weights loaded on the card disagree: {res}")
    return res


def rn50_model(settings: dict, path: str, classes: int, uniprompt: bool = False):
    """(cfg, model) of ``settings`` in bf16 on the card, with the RN50 file
    at ``path`` grafted through ``MODEL.PRETRAIN_PATH``."""
    dtype, device = "bfloat16", CARD
    cfg = (uniprompt_cfg(dtype, device, settings) if uniprompt
           else vit_base_cfg(dtype, device, settings))
    cfg.MODEL.PRETRAIN_PATH = path
    make = make_model_uniprompt if uniprompt else make_model
    model = load_pretrained(make(cfg, num_class=classes, camera_num=6, view_num=1), cfg)
    return cfg, model


def run_rn50_base(path: str, profile: bool) -> dict:
    """configs/person/cnn_base.yml at full width (RN50, 751 classes, 256×128,
    bf16 over fp32, batch 64) from the seeded file: ``do_inference`` on 256
    images (a warm-up run, then RN50_EVAL_RUNS timed), then a warm-up and
    RN50_TRAIN_STEPS timed train steps on PK 16 × 4 batches (augmentation
    on, Adam); no kernel of the port runs on this path."""
    cfg, model = rn50_model(CNN_BASE, path, NUM_CLASSES)
    loader = InMemoryBatcher(QUERY, GALLERY, BATCH, HW)
    do_inference(cfg, model, loader, QUERY)  # warm-up
    reset_counts()
    seconds = [timed(lambda: do_inference(cfg, model, loader, QUERY))[1]
               for _ in range(RN50_EVAL_RUNS)]
    expect_counts("RN50 do_inference", read_counts(), {})
    feats = make_eval_step(model, cfg)(next(loader.iter_sequential()))
    dim = model.in_planes + model.in_planes_proj  # 2048 + 1024
    if tuple(feats.shape) != (BATCH, dim) or not bool(torch.isfinite(feats.float()).all()):
        raise AssertionError(f"bad RN50 eval features {tuple(feats.shape)}")
    res = dict(eval_feats_per_s=(QUERY + GALLERY) / statistics.median(seconds),
               eval_seconds=seconds, feat_dim=int(feats.shape[1]))

    loss_fn, _ = make_loss(cfg, NUM_CLASSES)
    optimizer = make_optimizer(cfg.SOLVER, model, stage="baseline")
    lr = make_scheduler(cfg.SOLVER, "multistep")(1)
    images, pids = train_images(seed=13)
    batches = pk_batches(images, pids, 1 + RN50_TRAIN_STEPS, seed=14)
    state = initial_state(model, optimizer)
    step = make_train_step(model, cfg, loss_fn, optimizer)
    gen = torch.Generator(device=CARD).manual_seed(int(cfg.SOLVER.SEED))
    state, _ = step(state, batches[0], lr, gen)  # warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, losses = [], []
    for batch in batches[1:]:
        (state, metrics), secs = timed(lambda: step(state, batch, lr, gen))
        seconds.append(secs)
        losses.append(float(metrics["loss"]))
    expect_counts("RN50 train steps", read_counts(), {})
    tracked = int(model.image_encoder.bn1.num_batches_tracked)
    if not all(np.isfinite(losses)) or tracked != 1 + RN50_TRAIN_STEPS:
        raise AssertionError(f"RN50 train steps: losses {losses}, BN batches {tracked}")
    res.update(train_img_per_s=BATCH / statistics.median(seconds), step_seconds=seconds,
               losses=losses, bn_batches_tracked=tracked,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"RN50 baseline {json.dumps(res)}")
    if profile:
        res["train_profile"] = profile_idle(
            lambda: [step(state, batches[1 + i], lr, gen) for i in range(RN50_TRAIN_STEPS)],
            f"{RN50_TRAIN_STEPS} RN50 train steps (bf16, batch 64)", RN50_OP_GROUPS)
        # the attention pool alone, forward and backward at the layer4 map's shape
        pool = model.image_encoder.attnpool
        x4 = torch.randn(BATCH, pool.embed_dim, HW[0] // 16, HW[1] // 16, device=CARD,
                         dtype=torch.bfloat16, requires_grad=True)
        res["attnpool_fwd_bwd_ms"] = cuda_ms(lambda: pool(x4).float().sum().backward(),
                                             runs=10, reps=3)
        step_busy_ms = res["train_profile"]["device_busy_ms"] / RN50_TRAIN_STEPS
        res["attnpool_share_of_step_busy"] = res["attnpool_fwd_bwd_ms"] / step_busy_ms
        log(f"RN50 attention pool forward + backward {res['attnpool_fwd_bwd_ms']:.4f} ms, "
            f"{res['attnpool_share_of_step_busy']:.1%} of a step's busy device time "
            f"({step_busy_ms:.2f} ms)")
    return dict(res=res, model=model)


def tower_op_inputs(tower, x) -> dict:
    """{name: input} of every convolution, BatchNorm and the attention pool
    of an RN50 tower, from one forward on running statistics."""
    from mpreid_tpu_torch.models.resnet import AttentionPool2d, BatchNorm2d, Conv2d

    inputs = {}
    hooks = [mod.register_forward_pre_hook(
        lambda _, args, name=name: inputs.setdefault(name, args[0].detach().cpu()))
        for name, mod in tower.named_modules()
        if isinstance(mod, (Conv2d, BatchNorm2d, AttentionPool2d))]
    with torch.no_grad():
        tower(x, None, train=False)
    for hook in hooks:
        hook.remove()
    return inputs


def tower_op_grads(tower, inputs: dict, device) -> dict:
    """{(name, mode): [gradient of the input, then of each parameter]} of
    each of ``tower``'s operators alone on ``inputs`` (the same on every
    device), for a seeded normal cotangent on its output; BatchNorms once on
    running statistics ("eval") and once on batch statistics ("train")."""
    from mpreid_tpu_torch.models.resnet import BatchNorm2d

    modules = dict(tower.named_modules())
    gen = torch.Generator().manual_seed(18)
    grads = {}
    for name, x in inputs.items():
        mod = modules[name]
        for mode in (("eval", "train") if isinstance(mod, BatchNorm2d) else ("",)):
            x_in = x.to(device).requires_grad_(True)
            y = mod(x_in, mode == "train") if mode else mod(x_in)
            cot = torch.randn(y.shape, generator=gen).to(device)
            leaves = [x_in] + list(mod.parameters())
            grads[name, mode] = [g.float().cpu() for g in
                                 torch.autograd.grad((y.float() * cot).sum(), leaves)]
    return grads


def rn50_cross_checks(model) -> dict:
    """configs/person/cnn_base.yml from the slice's weights, batch 2 × 4,
    augmentation off, fp32 on the card against fp32 on the CPU:

    * eval features to 1e-3;
    * one train step (BatchNorms on batch statistics, the real loss): the
      loss to LOSS_RTOL, the running statistics it leaves in every
      BatchNorm to RN50_STATS_RTOL × max(1, max|cpu|), and the gradients of
      the leaves after the tower (classifiers, BNNecks) to GRAD_RTOL
      norm-relative, floored at 1e-3 of the largest, as the ViT's;
    * every operator of the tower alone (55 convolutions, 55 BatchNorms on
      running and on batch statistics, the attention pool) on its input
      from the CPU's forward, with a seeded cotangent: the gradients of its
      input and parameters to GRAD_RTOL, floored at 1e-3 of the operator's
      largest.

    The tower's leaves are not held on the train step's gradients: through
    16 bottlenecks those of a random-weight RN50 are ill-conditioned (two
    CPU runs that only sum in another order differ by percents on batch
    statistics, and by a good part of GRAD_RTOL on running statistics,
    where cuDNN's fp32 algorithms round differently again), so no
    tolerance there could tell a wrong backward from rounding; one
    operator alone is well-conditioned. bf16
    against fp32 is held on the eval features (cosine) and on the train
    loss (RN50_BF16_LOSS_RTOL), not on gradients, for the same reason."""
    from mpreid_tpu_torch.engine.steps import augment_args
    from mpreid_tpu_torch.ops.augment import train_augment

    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    images, pids = train_images(seed=15)
    batch = pk_batches(images, pids, 1, ids=CHECK_BATCH // K_INST, seed=16)[0]
    out, op_inputs = {}, None
    for name, dtype, device in (("fp32_cpu", "float32", "cpu"), ("fp32_cuda", "float32", CARD),
                                ("bf16_cuda", "bfloat16", CARD)):
        c = vit_base_cfg(dtype, device, CNN_BASE)
        c.INPUT.PROB, c.INPUT.PADDING, c.INPUT.RE_PROB = 0.0, 0, 0.0
        m = build_model(c, NUM_CLASSES, 6, 1)
        m.load_state_dict(weights, strict=True)
        m = m.to(device).eval()
        feats = make_eval_step(m, c)({"images": batch["images"].cpu().numpy()}).float().cpu()
        loss_fn, _ = make_loss(c, NUM_CLASSES)
        opt = make_optimizer(c.SOLVER, m, stage="baseline")
        x = train_augment(batch["images"].to(device), torch.Generator(device=device),
                          **augment_args(c))
        loss, _, grads, _ = loss_and_grads(m, c, loss_fn, opt, x, batch["pids"].to(device).long())
        heads = {k: g.float().cpu() for k, g in grads.items() if not k.startswith("image_encoder")}
        stats = {k: v.float().cpu().clone() for k, v in m.state_dict().items() if ".running_" in k}
        op_grads = None
        if dtype == "float32":
            m.load_state_dict(weights, strict=True)  # the running statistics before the step
            if op_inputs is None:
                op_inputs = tower_op_inputs(m.image_encoder, x)
            op_grads = tower_op_grads(m.image_encoder, op_inputs, device)
        out[name] = (feats, float(loss), stats, heads, op_grads)
        del m
    (f_cpu, l_cpu, s_cpu, h_cpu, o_cpu), (f_gpu, l_gpu, s_gpu, h_gpu, o_gpu), \
        (f16, l16, *_) = out["fp32_cpu"], out["fp32_cuda"], out["bf16_cuda"]
    floor = 1e-3 * max(g.norm().item() for g in h_cpu.values())
    head_err = {k: _rel_err(h_gpu[k], g, floor) for k, g in h_cpu.items()}
    op_err = {}
    for key, gs in o_cpu.items():
        op_floor = 1e-3 * max(g.norm().item() for g in gs)
        op_err[" ".join(key).strip()] = max(_rel_err(o_gpu[key][i], g, op_floor)
                                            for i, g in enumerate(gs))
    stats_err = {k: (s_gpu[k] - v).abs().max().item() / max(1.0, v.abs().max().item())
                 for k, v in s_cpu.items()}
    res = dict(eval_fp32_card_vs_cpu_max_abs=(f_gpu - f_cpu).abs().max().item(), eval_tol=1e-3,
               eval_bf16_vs_fp32_min_cosine=F.cosine_similarity(f16, f_gpu, dim=1).min().item(),
               loss_fp32_card_vs_cpu_rel=abs(l_gpu - l_cpu) / abs(l_cpu), loss_rtol=LOSS_RTOL,
               worst_running_stat_err=max(stats_err.values()),
               worst_running_stat=max(stats_err, key=stats_err.get),
               running_stat_rtol=RN50_STATS_RTOL, running_stat_buffers=len(stats_err),
               worst_head_grad_rel=max(head_err.values()),
               worst_head_leaf=max(head_err, key=head_err.get), head_leaves=len(head_err),
               worst_op_grad_rel=max(op_err.values()), worst_op=max(op_err, key=op_err.get),
               op_checks=len(op_err), grad_rtol=GRAD_RTOL, cosine_floor=COSINE_FLOOR,
               loss_bf16_vs_fp32_rel=abs(l16 - l_gpu) / abs(l_gpu),
               loss_bf16_rtol=RN50_BF16_LOSS_RTOL)
    log(f"RN50 cross-checks {json.dumps(res)}")
    if not (res["eval_fp32_card_vs_cpu_max_abs"] <= 1e-3
            and res["loss_fp32_card_vs_cpu_rel"] <= LOSS_RTOL
            and res["worst_running_stat_err"] <= RN50_STATS_RTOL
            and res["worst_head_grad_rel"] <= GRAD_RTOL
            and res["worst_op_grad_rel"] <= GRAD_RTOL
            and res["eval_bf16_vs_fp32_min_cosine"] >= COSINE_FLOOR
            and res["loss_bf16_vs_fp32_rel"] <= RN50_BF16_LOSS_RTOL):
        raise AssertionError(f"RN50 on the card disagrees with the CPU or with fp32: {res}")
    return res


def run_rn50_uniprompt(path: str) -> dict:
    """configs/person/cnn_clipreid.yml at full width (RN50 + the 12 × 512
    text tower, 751 classes, bf16 over fp32) from the seeded file: the
    stage-1 bank over RN50_BANK images, RN50_STAGE1_STEPS stage-1a and 1b
    steps through ``do_train_stage1`` (12 + 12 attention launches a step,
    on "tc"), the stage-2 text features of every class, RN50_STAGE2A_STEPS
    timed stage-2a steps and ``do_inference``; each with its launches."""
    cfg, model = rn50_model(CNN_CLIPREID, path, NUM_CLASSES, uniprompt=True)
    tdepth = len(model.text_encoder.transformer.resblocks)
    rng = np.random.default_rng(17)
    images = rng.integers(0, 256, (RN50_BANK, *HW, 3), dtype=np.uint8)
    pids = (np.arange(RN50_BANK) % 128).astype(np.int32)  # 8 images of 128 ids: PK batches
    views = np.zeros(RN50_BANK, np.int32)
    loader1 = ShuffledLoader(MemoryBatcher(images, pids, BATCH, views), int(cfg.SOLVER.SEED))
    res, launches = {}, {}
    build_image_bank(cfg, model, ShuffledLoader(
        MemoryBatcher(images[:BATCH], pids[:BATCH], BATCH, views[:BATCH]), 0))  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    bank, secs = timed(lambda: build_image_bank(cfg, model, loader1))
    expect_counts("RN50 image bank", read_counts(), {})
    if tuple(bank[0].shape) != (RN50_BANK, model.in_planes_proj) or \
            not bool(torch.isfinite(bank[0].float()).all()):
        raise AssertionError(f"bad RN50 image bank {tuple(bank[0].shape)}")
    res["bank"] = dict(images=RN50_BANK, seconds=secs, feats_per_s=RN50_BANK / secs)

    rows = RN50_STAGE1_STEPS * BATCH
    sub = tuple(b[:rows] for b in bank)
    for stage in ("1a", "1b"):
        stage_cfg = cfg.SOLVER[f"STAGE{stage.upper()}"].clone()
        stage_cfg.MAX_EPOCHS = 1
        opt = make_optimizer(stage_cfg, model, stage=f"stage{stage}")
        reset_counts()
        (state, hist), secs = timed(lambda: do_train_stage1(
            cfg, model, loader1, opt, make_scheduler(stage_cfg, "cosine"),
            is_stage1b=stage == "1b", bank=sub, stage_cfg=stage_cfg))
        launches[f"stage{stage}_steps"] = read_counts()
        expect_counts(f"RN50 stage {stage}", launches[f"stage{stage}_steps"],
                      {"attention_fwd": tdepth * RN50_STAGE1_STEPS,
                       "attention_bwd": tdepth * RN50_STAGE1_STEPS})
        if state.opt_state.step != RN50_STAGE1_STEPS or not np.isfinite(hist[0]["loss"]):
            raise AssertionError(f"RN50 stage {stage}: {state.opt_state.step} steps, {hist}")
        res[f"stage{stage}"] = dict(steps=RN50_STAGE1_STEPS, seconds=secs,
                                    bank_rows_per_s=rows / secs, loss=hist[0]["loss"])

    reset_counts()
    text, secs = timed(lambda: precompute_text_features(cfg, model, NUM_CLASSES))
    launches["text_features"] = read_counts()
    n_text = -(-NUM_CLASSES // BATCH)
    expect_counts("RN50 text features", launches["text_features"],
                  {"attention_fwd": tdepth * n_text})
    if tuple(text.shape) != (NUM_CLASSES, model.in_planes_proj) or \
            not bool(torch.isfinite(text.float()).all()):
        raise AssertionError(f"bad RN50 text features {tuple(text.shape)}")
    res["text_features"] = dict(classes=NUM_CLASSES, seconds=secs)

    loss_fn, _ = make_loss(cfg, NUM_CLASSES)
    opt_2a = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    lr = make_scheduler(cfg.SOLVER.STAGE2, "multistep")(1)
    batches = pk_batches(images, pids, 4, seed=18)
    state = initial_state(model, opt_2a)
    step = make_train_step(model, cfg, loss_fn, opt_2a, uniprompt=True, text_features=text)
    gen = torch.Generator(device=CARD).manual_seed(int(cfg.SOLVER.SEED))
    reset_counts()
    seconds, losses = [], []
    for i in range(RN50_STAGE2A_STEPS):
        (state, metrics), secs = timed(lambda: step(state, batches[i % len(batches)], lr, gen))
        seconds.append(secs)
        losses.append(float(metrics["loss"]))
    launches["stage2a_steps"] = read_counts()
    expect_counts("RN50 stage 2a steps", launches["stage2a_steps"], {})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite RN50 stage-2a loss: {losses}")
    res["stage2a"] = dict(steps=RN50_STAGE2A_STEPS, losses=losses, step_seconds=seconds,
                          train_img_per_s=BATCH / statistics.median(seconds[1:]))

    reset_counts()
    (r1, r5), secs = timed(lambda: do_inference(cfg, model, InMemoryBatcher(
        QUERY, GALLERY, BATCH, HW), QUERY))
    launches["inference"] = read_counts()
    expect_counts("RN50 Uni-Prompt do_inference", launches["inference"], {})
    res["inference"] = dict(images=QUERY + GALLERY, seconds=secs, rank1=float(r1),
                            rank5=float(r5))
    log(f"RN50 Uni-Prompt {json.dumps(res)}")
    return dict(res=res, launches=launches)


def run_rn50_vehicle(path: str) -> dict:
    """One stage-2a step of configs/veri/cnn_prom.yml at full width (RN50 at
    256×256: the attention pool at L 257 from the file's 7×7+1 grid; 576
    classes) after the stage-2 text features of every class."""
    cfg, model = rn50_model(CNN_PROM, path, VEHICLE_CLASSES, uniprompt=True)
    pool_len = model.image_encoder.attnpool.positional_embedding.shape[0]
    tdepth = len(model.text_encoder.transformer.resblocks)
    reset_counts()
    text = precompute_text_features(cfg, model, VEHICLE_CLASSES)
    loss_fn, _ = make_loss(cfg, VEHICLE_CLASSES)
    opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    images, pids = train_images(seed=19, hw=VEHICLE_HW)
    batch = pk_batches(images, pids, 1, seed=20)[0]
    step = make_train_step(model, cfg, loss_fn, opt, uniprompt=True, text_features=text)
    gen = torch.Generator(device=CARD).manual_seed(int(cfg.SOLVER.SEED))
    (_, metrics), secs = timed(lambda: step(initial_state(model, opt), batch, 1e-5, gen))
    counts = read_counts()
    expect_counts("RN50 vehicle step", counts,
                  {"attention_fwd": tdepth * -(-VEHICLE_CLASSES // BATCH)})
    res = dict(config="configs/veri/cnn_prom.yml", hw=list(VEHICLE_HW), pool_len=pool_len,
               loss=float(metrics["loss"]), seconds=secs, launches=counts)
    log(f"RN50 vehicle step {json.dumps(res)}")
    if pool_len != VEHICLE["l"] or not np.isfinite(res["loss"]):
        raise AssertionError(f"RN50 vehicle step: {res}")
    return res


def neighbour_flips(feats: torch.Tensor, k: int) -> int:
    """Rows whose k-NN sets (re-ranking's first step) differ between the
    card's and the CPU's fp32 distances of the same features."""
    k = min(k, feats.shape[0])
    sets = []
    for device in ("cuda", "cpu"):
        f = feats.to(device)
        d = euclidean_squared_distmat(f, f)
        sets.append(smallest_k((d / d.amax(dim=0)).T, k).sort(dim=1).values.cpu())
    return int((sets[0] != sets[1]).any(dim=1).sum())


def rerank_entry(model) -> dict:
    """(a) ``do_inference`` with ``TEST.RE_RANKING`` on phase 4's slice: one
    L1 kernel launch. Then the same normalised features re-ranked by the
    evaluator on the card and on the CPU, fp32. Random weights give tightly
    clustered features whose distances nearly tie, so the last-bit
    differences between the two devices' distance products can swap a
    neighbour across the k1 + 1 boundary, and one swapped set moves
    distances by ~1e-2: the error is reported with the rows whose neighbour
    sets differ. The check holds the features rounded to multiples of 2⁻¹⁰,
    whose distance products are exact in fp32 on both devices (the same
    neighbour sets), to RERANK_TOL."""
    cfg = vit_base_cfg()
    cfg.TEST.RE_RANKING = True
    loader = InMemoryBatcher(QUERY, GALLERY, BATCH, HW)
    depth = len(model.image_encoder.transformer.resblocks)
    reset_counts()
    t0 = time.perf_counter()
    r1, r5 = do_inference(cfg, model, loader, QUERY)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("do_inference with re-ranking", counts, {
        "attention_fwd": depth * (QUERY + GALLERY) // BATCH, "l1_cross": 1})
    step = make_eval_step(model, cfg)
    feats = torch.cat([step(b)[: b["count"]] for b in loader.iter_sequential()]).float()
    feats = feats / torch.linalg.norm(feats, dim=1, keepdim=True)

    def rerank_both(f):
        out = []
        for device in ("cuda", "cpu"):
            ev = R1mAPEvaluator(QUERY, feat_norm=False, reranking=True, device=device)
            ev.update((f.to(device), loader.pids, loader.camids))
            out.append(ev.compute())
        return out

    (cmc, mAP, dist, *_), (_, _, dist_cpu, *_) = rerank_both(feats)
    grid = torch.round(feats * 1024) / 1024
    (cmc_g, _, dist_g, *_), (cmc_g_cpu, _, dist_g_cpu, *_) = rerank_both(grid)
    err = float(np.abs(dist_g - dist_g_cpu).max())
    res = dict(seconds=seconds, launches=counts, rank1=float(r1), rank5=float(r5),
               evaluator_rank1=float(cmc[0]), mAP=mAP,
               card_vs_cpu_max_abs=float(np.abs(dist - dist_cpu).max()),
               rows_with_other_neighbours=neighbour_flips(feats, K1 + 1),
               grid_card_vs_cpu_max_abs=err,
               grid_rows_with_other_neighbours=neighbour_flips(grid, K1 + 1),
               tol=RERANK_TOL, shape=list(dist.shape))
    log(f"rerank entry {json.dumps(res)}")
    if not (err <= RERANK_TOL and np.isfinite(dist).all() and np.isfinite(dist_g).all()):
        raise AssertionError(f"re-ranked distances on the card differ from the CPU's: {res}")
    if float(r1) != float(cmc[0]) or not np.array_equal(cmc_g, cmc_g_cpu):
        raise AssertionError(f"re-ranked CMC differs between the entry path, card and CPU: {res}")
    return res


def clustered_feats(q: int, g: int, ids: int, seed: int = 0):
    """bench.py's seeded clustered features (identity centres plus noise
    0.7) at FEAT_DIM, with identities as pids and camids over 6 cameras."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(ids, FEAT_DIM).astype(np.float32)
    q_ids, g_ids = rng.randint(0, ids, q), rng.randint(0, ids, g)
    qf = (centers[q_ids] + rng.randn(q, FEAT_DIM) * 0.7).astype(np.float32)
    gf = (centers[g_ids] + rng.randn(g, FEAT_DIM) * 0.7).astype(np.float32)
    camids = rng.randint(0, 6, q + g)
    return np.concatenate([qf, gf]), np.concatenate([q_ids, g_ids]), camids


def rerank_market(profile: bool) -> dict:
    """(b) The dense route at Market-1501 scale through R1mAPEvaluator
    (k1 50, k2 15, λ 0.3): median of MARKET_RUNS computes after a warm-up,
    one L1 launch each; then once with the quantized min-sum. ``profile``
    adds a breakdown by kernel of one traced compute."""
    q, g = MARKET["q"], MARKET["g"]
    feats, pids, camids = clustered_feats(**MARKET)
    feats = torch.from_numpy(feats).cuda()
    ev = R1mAPEvaluator(q, reranking=True)
    ev.update((feats, pids, camids))
    ev.compute()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds = []
    for _ in range(MARKET_RUNS):
        t0 = time.perf_counter()
        cmc, mAP, dist, *_ = ev.compute()  # ends in host copies
        seconds.append(time.perf_counter() - t0)
    counts = read_counts()
    expect_counts("Market-1501 dense re-ranking", counts, {"l1_cross": MARKET_RUNS})
    peak = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        profile_compute(ev, "Market-1501 dense")
    ev_fast = R1mAPEvaluator(q, reranking=True, rerank_fast=True)
    ev_fast.update((feats, pids, camids))
    t0 = time.perf_counter()
    cmc_f, mAP_f, dist_f, *_ = ev_fast.compute()
    fast_s = time.perf_counter() - t0
    res = dict(query=q, gallery=g, n=q + g, dim=FEAT_DIM, seconds_median=statistics.median(seconds),
               seconds=seconds, peak_mem_gb=peak, launches=counts, rank1=float(cmc[0]), mAP=mAP,
               fast_seconds=fast_s, fast_max_abs_diff=float(np.abs(dist_f - dist).max()),
               fast_rank1=float(cmc_f[0]), fast_mAP=mAP_f)
    log(f"rerank market1501 dense {json.dumps(res)}")
    if not (np.isfinite(dist).all() and np.isfinite(dist_f).all()):
        raise AssertionError(f"non-finite re-ranked distances at Market-1501 scale: {res}")
    return res


def profile_compute(ev, what: str) -> None:
    """Breakdown by kernel of one traced ``ev.compute()`` and the device's
    idle share over it (tracing adds host time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.compute()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log(f"profile of one {what} re-ranking compute:\n"
        + prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    busy = device_busy_ms(prof)
    log(f"idle {json.dumps(dict(compute_wall_ms_traced=wall_ms, device_busy_ms=busy, device_idle_share=1 - busy / wall_ms))}")


def rank_metrics(dist_rows: np.ndarray, rows: np.ndarray, q_ids, g_ids) -> tuple:
    """(rank-1, mAP) of distance rows against the synthetic identities (bench.py)."""
    order = np.argsort(dist_rows, axis=1, kind="stable")
    r1 = float(np.mean(g_ids[order[:, 0]] == q_ids[rows]))
    aps = []
    for i, r in enumerate(rows):
        rel = g_ids[order[i]] == q_ids[r]
        if rel.any():
            prec = np.cumsum(rel) / (np.arange(len(rel)) + 1)
            aps.append(float(np.sum(prec * rel) / rel.sum()))
    return r1, float(np.mean(aps)) if aps else 0.0


def rerank_msmt(profile: bool) -> dict:
    """(c) The sparse-V route at MSMT17 scale through R1mAPEvaluator (above
    TEST.RERANK_SPARSE_N: quantized min-sum); then ORACLE_ROWS evenly spaced
    query rows recomputed exactly by re_ranking_sparse_rows (the min-sum
    kernel on each gallery chunk): the quantized rows rank the gallery as
    the exact ones do to within one sampled query's rank-1 and
    QUANTIZED_MAP_DELTA of mAP; their value error is reported against
    QUANTIZED_VALUE_BAR. ``profile`` adds a breakdown of a second, traced
    compute."""
    q, g = MSMT["q"], MSMT["g"]
    feats, pids, camids = clustered_feats(**MSMT)
    ev = R1mAPEvaluator(q, reranking=True)
    ev.update((torch.from_numpy(feats).cuda(), pids, camids))
    del feats
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    cmc, mAP, dist, _, _, qf, gf = ev.compute()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    expect_counts("MSMT17 sparse quantized re-ranking", read_counts(), {})
    if profile:
        profile_compute(ev, "MSMT17 sparse quantized")
    del ev
    rows = np.linspace(0, q - 1, ORACLE_ROWS).astype(np.int64)
    d_rows = dist[rows]
    del dist
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    exact = re_ranking_sparse_rows(torch.from_numpy(qf).cuda(), torch.from_numpy(gf).cuda(),
                                   torch.from_numpy(rows).cuda()).cpu().numpy()
    oracle_s = time.perf_counter() - t0
    oracle_counts = read_counts()
    expect_counts("re_ranking_sparse_rows", oracle_counts,
                  {"minsum_cross": -(-g // MSMT_BLOCK[1])})
    q_ids, g_ids = pids[:q], pids[q:]
    r1_q, map_q = rank_metrics(d_rows, rows, q_ids, g_ids)
    r1_e, map_e = rank_metrics(exact, rows, q_ids, g_ids)
    diff = np.abs(d_rows - exact)
    res = dict(query=q, gallery=g, n=q + g, dim=FEAT_DIM, seconds=seconds, peak_mem_gb=peak,
               rank1=float(cmc[0]), mAP=mAP, oracle_rows=ORACLE_ROWS, oracle_seconds=oracle_s,
               oracle_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=oracle_counts, rows_max_abs_err_vs_exact=float(diff.max()),
               rows_mean_abs_err=float(diff.mean()),
               rows_err_p999=float(np.quantile(diff, 0.999)),
               rows_share_above_value_bar=float(np.mean(diff > QUANTIZED_VALUE_BAR)),
               value_bar=QUANTIZED_VALUE_BAR,
               top1_disagreement=float(np.mean(d_rows.argmin(1) != exact.argmin(1))),
               rank1_delta=r1_q - r1_e, map_delta_rows=map_q - map_e, rows_rank1_exact=r1_e,
               rows_map_exact=map_e)
    log(f"rerank msmt17 sparse {json.dumps(res)}")
    if not (np.isfinite(exact).all() and abs(r1_q - r1_e) <= 1 / ORACLE_ROWS + 1e-9
            and abs(map_q - map_e) < QUANTIZED_MAP_DELTA):
        raise AssertionError(f"quantized MSMT17 rows rank unlike the exact oracle's: {res}")
    return res


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    t_start = time.perf_counter()

    header()

    log("build:")
    secs = build.build(verbose=True)
    log(f"  built {json.dumps(secs)} (seconds per source, 0 = already built)")
    ptxas = ptxas_report()

    log("kernels against their plain versions on the card:")
    rows, bwd_rows = [], []
    cases = [(VISION, torch.bfloat16), (VISION, torch.float32), (TEXT, torch.bfloat16),
             (VEHICLE, torch.bfloat16), (SYSU, torch.float32), (VEHICLE, torch.float32),
             (TTPT_TEXT, torch.bfloat16)]
    for case, dtype in cases:
        for layout in attn.LAYOUTS:
            timed_here = layout == "packed" or case is VISION and dtype == torch.bfloat16
            rows.append(check_attention(case, dtype, layout, timed=timed_here))
            bwd_rows.append(check_attention_bwd(case, dtype, layout, timed=timed_here))
    adam_rows = [check_adam(md, decoupled, timed=md == torch.float32 and not decoupled)
                 for md in (torch.float32, torch.bfloat16) for decoupled in (False, True)]
    t0 = time.perf_counter()
    n_market, n_msmt = MARKET["q"] + MARKET["g"], MSMT["q"] + MSMT["g"]
    l1_rows = [check_pairwise("l1_cross", MARKET["q"], MARKET["g"], n_market, V_NONZEROS, True),
               check_pairwise("l1_cross", 130, 70, 600, None, False)]
    minsum_rows = [check_pairwise("minsum_cross", *MSMT_BLOCK, n_msmt, V_NONZEROS, True),
                   check_pairwise("minsum_cross", 130, 70, 600, None, False)]
    torch.cuda.empty_cache()
    log(f"  pairwise kernels {time.perf_counter() - t0:.1f} s")
    hard_rows = batch_hard_rows()

    log("baseline eval slice, ViT-B/16 at full width:")
    reset_counts()
    model, slice_res = run_slice(args.profile)

    log("baseline training slice, ViT-B/16 at full width:")
    train_res = run_train(args.profile)
    log("vehicle training slice, configs/veri/vit_base.yml (256×256, L 257), full width:")
    vehicle_res = run_vehicle_train()

    log("cross-checks:")
    cross_checks(model)
    train_cross_checks(train_res.pop("model"))
    torch.cuda.empty_cache()

    log("margin heads (MODEL.COS_LAYER), configs/person/vit_base.yml at full width:")
    t0 = time.perf_counter()
    margin_res = run_margin()
    log(f"  margin phase seconds {time.perf_counter() - t0:.1f}")

    log("re-ranking slice (TEST.RE_RANKING):")
    phase_s = {}
    t0 = time.perf_counter()
    entry_res = rerank_entry(model)
    del model
    phase_s["entry"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    market_res = rerank_market(args.profile)
    phase_s["market1501_dense"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    msmt_res = rerank_msmt(args.profile)
    phase_s["msmt17_sparse"] = time.perf_counter() - t0
    log(f"  re-ranking phase seconds {json.dumps(phase_s)}")
    torch.cuda.empty_cache()

    log("Uni-Prompt slice (stage 1a → 1b → 2a → 2b → inference), full width:")
    t0 = time.perf_counter()
    uni = run_uniprompt(args.profile)
    triplet_res = uniprompt_triplet_check(uni.pop("feats"), uni.pop("labels"))
    uni_model = uni.pop("model")
    uniprompt_cross_checks(uni_model, uni.pop("text"))
    log(f"  Uni-Prompt phase seconds {time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    log("TTA / TTPT eval modes on the Uni-Prompt model after stage 2, full width:")
    t0 = time.perf_counter()
    ttpt_res = run_ttpt(uni_model, args.profile)
    ttpt_res["fp32_card_vs_cpu"] = ttpt_cross_check(uni_model)
    del uni_model
    log(f"  TTA / TTPT phase seconds {time.perf_counter() - t0:.1f}")
    uni_res = uni["res"]
    after_1b, uni_data = uni.pop("after_1b"), uni.pop("data")
    del uni
    torch.cuda.empty_cache()

    log("MoE Uni-Prompt (configs/tpu/uniprompt_tuned.yml, MoE 4/2/2) after stage 1b, full width:")
    t0 = time.perf_counter()
    moe_res = run_uniprompt_moe(after_1b, *uni_data, args.profile)
    moe_cross_checks(uni_data[0])
    del after_1b, uni_data
    torch.cuda.empty_cache()
    log(f"  MoE phase seconds {time.perf_counter() - t0:.1f}")

    log("device-resident epoch (TPU.DEVICE_DATASET), ViT-B/16 at Market-1501's train size:")
    t0 = time.perf_counter()
    epoch_res = run_device_epoch()
    torch.cuda.empty_cache()
    log(f"  device-epoch phase seconds {time.perf_counter() - t0:.1f}")

    log("CLIP weights from a local file, and the RN50 backbone, full width:")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        clip_loader_check(tmp)
        rn50_path = make_clip_file(os.path.join(tmp, "RN50.pt"), RN50, RN50_FILE_GRID, seed=22,
                                   jit=True, half=True)
        rn50 = run_rn50_base(rn50_path, args.profile)
        rn50_cross_checks(rn50.pop("model"))
        rn50_uni = run_rn50_uniprompt(rn50_path)
        run_rn50_vehicle(rn50_path)
    rn50_res = rn50["res"]
    rate_line("RN50 eval feats/s (configs/person/cnn_base.yml, do_inference, 256 images)",
              dict(feats_per_s=rn50_res["eval_feats_per_s"]))
    rate_line("RN50 train img/s (configs/person/cnn_base.yml, batch 64, median step)",
              dict(img_per_s=rn50_res["train_img_per_s"]))
    rate_line("RN50 stage-1 rows/s (configs/person/cnn_clipreid.yml, bank and stage 1b)",
              dict(bank_feats_per_s=rn50_uni["res"]["bank"]["feats_per_s"],
                   stage1b_rows_per_s=rn50_uni["res"]["stage1b"]["bank_rows_per_s"]))
    log(f"  CLIP loader and RN50 phase seconds {time.perf_counter() - t0:.1f}")

    def timing(row):
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    def pick(found, case, dtype="bfloat16"):  # the packed row
        return next(r for r in found
                    if (r["case"], r["dtype"], r["layout"]) == (case, dtype, "packed"))

    def attention_entry(direction, found):
        name = f"attention_{direction}"
        bf16 = [r for r in found if r["dtype"] == "bfloat16"]
        return {
            "name": f"fused_attention_{direction}",
            "route": "cuda",
            "source": f"mpreid_tpu_torch/kernels/csrc/attention_{direction}_tc.cu",
            "replaces": "mpreid_tpu/ops/attention.py:" + ("229" if direction == "fwd" else "250"),
            "also_replaces": "mpreid_tpu/ops/attention.py:" + ("488" if direction == "fwd"
                                                               else "514"),
            "launches": train_counts[name],
            "launches_by_route": train_res["train"]["launches_by_route"][name],
            "launches_eval": slice_res["launches"] if direction == "fwd" else 0,
            "launches_uniprompt": {k: v[name] for k, v in uni_launches.items()},
            "launches_vehicle": vehicle_res["launches"][name],
            "launches_device_epoch_do_train": epoch_res["res"]["launches"][name],
            "launches_moe": {k: moe_res[k]["launches"][name]
                             for k in ("stage2a", "stage2b", "inference")},
            "launches_rn50_uniprompt": {k: v[name] for k, v in rn50_uni["launches"].items()},
            "launches_ttpt": {k: ttpt_res[k]["launches"][name] for k in ("tta", "ttpt")},
            "launches_margin": {k: margin_res[k]["launches"][name] for k in MARGIN_KINDS},
            "max_abs_err": max(r["max_abs_err"] for r in bf16),
            **timing(pick(found, "vision")),
            "shape": "B64 L129 12x64 bf16 packed, no mask",
            "text": timing(pick(found, "text")),
            "vehicle": timing(pick(found, "vehicle")),
            "ttpt_text": {"shape": "B1000 L77 8x64 bf16 packed, causal",
                          **timing(pick(found, "ttpt_text"))},
            "ptxas": ptxas[f"{name}_tc"],
            "simt_fp32": {"source": f"mpreid_tpu_torch/kernels/csrc/{name}.cu",
                          "max_abs_err": max(r["max_abs_err"] for r in found
                                             if r["dtype"] == "float32"),
                          **timing(pick(found, "vision", "float32")),
                          "sysu": timing(pick(found, "sysu", "float32")),
                          "vehicle": timing(pick(found, "vehicle", "float32"))},
        }

    train_counts = train_res["train"]["launches"]
    uni_launches = {"stage1a_epoch": uni_res["stage1a"]["launches"],
                    "stage2a_steps": uni_res["stage2a"]["launches"]}
    kernels = [attention_entry("fwd", rows), attention_entry("bwd", bwd_rows), {
        "name": "fused_adam_leaf",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/adam.cu",
        "replaces": "mpreid_tpu/ops/adam_kernel.py:60",
        "launches": train_res["fused"]["launches"]["adam"],
        "launches_margin": margin_res[MARGIN_KINDS[-1]]["launches"]["adam"],
        "max_abs_err": max(r["max_abs_err"] for r in adam_rows),
        **timing(adam_rows[0]),
        "shape": "c_fc leaf 3072x768 fp32, fp32 moments, Adam (coupled L2)",
    }, {
        "name": "l1_cross",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/pairwise_cross.cu",
        "replaces": "mpreid_tpu/ops/pallas_kernels.py:192",
        "launches": entry_res["launches"]["l1_cross"],
        "launches_market_dense": market_res["launches"]["l1_cross"],
        "max_abs_err": max(r["max_abs_err"] for r in l1_rows),
        **timing(l1_rows[0]),
        "plain_rows": l1_rows[0]["plain_rows"],
        "shape": f"Market-1501 dense: ({MARKET['q']}, {n_market}) x ({MARKET['g']}, "
                 f"{n_market}) fp32, {V_NONZEROS} nonzeros per row",
    }, {
        "name": "minsum_cross",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/pairwise_cross.cu",
        "replaces": "mpreid_tpu/ops/pallas_kernels.py:262",
        "launches": msmt_res["launches"]["minsum_cross"],
        "max_abs_err": max(r["max_abs_err"] for r in minsum_rows),
        **timing(minsum_rows[0]),
        "plain_rows": minsum_rows[0]["plain_rows"],
        "shape": f"MSMT17 query block x gallery chunk: ({MSMT_BLOCK[0]}, {n_msmt}) x "
                 f"({MSMT_BLOCK[1]}, {n_msmt}) fp32, {V_NONZEROS} nonzeros per row",
    }, {
        "name": "fused_batch_hard",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/batch_hard.cu",
        "replaces": "mpreid_tpu/ops/pallas_kernels.py:71",
        "launches": triplet_res["launches"],
        "launches_note": "batch_hard_triplet_loss on feats[1] of a stage-2a forward; no "
                         "config reaches it (nor the JAX package's), so the Uni-Prompt path "
                         "launches it 0 times",
        "max_abs_err": max(r["max_abs_err"] for r in hard_rows),
        **timing(hard_rows[0]),
        "library": hard_rows[0]["library"],
        "shape": f"PK batch {HARD['b']} x {HARD['d']} fp32 (feats[1]), labels 16 x 4",
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
