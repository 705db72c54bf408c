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
   vision, text and 256×256 vehicle shapes and at L 442 (256×256 at stride
   12, which the backward streams in chunks), untimed at L 1,000 (dh 64) and
   L 600 (dh 128), where both stream; fp32 on the kernels that take
   each product on the tensor cores in three TF32 passes at the vision and
   causal text shapes, at L 163 (configs/cross/sysu_rgb2ir.yml), L 257 and
   L 442 (256×256 at stride 12), both layouts, each fp32 launch repeated
   and held bit-equal to the first, with a second bound at the TF32 rate
   (``bound_tc_ms``); the ptxas report of the attention sources, which must
   show no spills: the fp32 sources at any head width, the bf16 ones
   (whole-sequence and chunked instances) at dh 64)
   and the Adam leaf update (a c_fc leaf, fp32/bf16 moments, Adam/AdamW;
   its step scalars [lr·mult, 1 − b1^t, 1 − b2^t] read from device memory;
   two launches bit-equal), and the Adam table (``adam_leaves``: one
   ``multi_adam_kernel`` launch over stage 2a's 161 trainable leaves, the
   Uni-Prompt ViT-B/16's) bit for bit against the per-op update of every leaf
   (``adam_leaf_plain``) and against ``SOLVER.FUSED_ADAM``'s route (the 53
   leaves of at least ``MIN_FUSED_SIZE`` elements on the per-leaf kernel, the
   rest in the table), each timed beside ``torch.optim.Adam(fused=True)`` on
   the same leaves and the bound; the L1 and min-sum kernels; the batch-hard
   kernel (the PK batch 64 × 768 in fp32 and bf16, ragged, grid cases, 600
   rows in two tiles; timed at B 64, 128 and 512 × 768 beside
   ``torch.cdist`` and an empty kernel launched the same way, the launch
   floor, and at each of its two shapes; its ptxas report, which must show
   no spill);
4. the baseline eval path (ViT-B/16, 256×128, bf16, batch 64) at full width
   on seeded random weights through ``engine.processor.do_inference``,
   counting the forward kernel's launches in that run;
5. the baseline training path (configs/person/vit_base.yml's settings:
   ViT-B/16 with 751 classes, 256×128, bf16 over fp32 parameters, PK batches
   of 16 × 4, augmentation on, Adam) through ``engine.steps.make_train_step``:
   a warm-up step, then timed steps, counting the attention kernels'
   launches; one short epoch through ``engine.processor.do_train`` over a
   ``TrainLoader``; then steps with ``SOLVER.FUSED_ADAM`` on, counting the
   Adam kernel's launches, and one fused update against the per-op update of
   every leaf; then
   three train steps of configs/veri/vit_base.yml (ViT-B/16 at 256×256, L
   257, 576 classes), whose attention backward an earlier fp32 kernel refused;
   then three of the same configuration at ``MODEL.STRIDE_SIZE [12, 12]`` (L
   442, which the bf16 backward refused before it streamed the sequence),
   all attention launches on "tc", a train step's gradients in bf16 against
   fp32 on the card (cosine, held to the same through the plain attention),
   and one ``do_inference`` over 64 + 64 images;
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
   ``do_inference_ttpt``, whose steps replay CUDA graphs from their third
   call) on phase 8's model after stage 2, over 256 + 256
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
   loss and gradients on the card against the CPU;
14. data parallelism over ``torch.distributed`` (``mpreid_tpu_torch/parallel``)
   at full width: (a) in a process given torchrun's variables for a world
   of 1, ``init_distributed`` makes the NCCL group, one all-reduce of a
   card tensor, one ``do_train`` step of configs/person/vit_base.yml
   (which runs without data parallelism) equal to the step without the
   group; then two ranks sharing the one card over gloo (NCCL refuses two
   ranks on one device), spawned with their own timeouts: (b) the baseline
   step, global batch 64 = 2 × 32, in fp32 against the single-process step
   (loss, every gradient, the BNNeck running statistics, the parameters
   after an Adam step), in bf16 its loss, launches per rank and img/s
   beside one process's (not a scaling number), plain and fused Adam; (c)
   ZeRO-1 against replicated data parallelism over 3 steps, fp32 and bf16
   moments, fused Adam off and on: parameters and gathered moments bit for
   bit, each rank's optimizer-state bytes; (d) one fp32 Uni-Prompt stage-2a
   step and one MoE stage-2b step (aux loss included) against one process;
   (e) gallery-sharded CMC / mAP at Market-1501's scale against the dense
   evaluator, with rows duplicated across the shard boundary;
15. the model axis of the mesh, GPipe and the sharded sparse re-ranking
   (``mpreid_tpu_torch/parallel``), ranks sharing the card over gloo: (a)
   configs/person/vit_base.yml at full width and depth (751 classes: 376 +
   375 rows a rank) on a 1 × 2 mesh with tensor-parallel towers: the fp32
   step against one process (loss, every gathered gradient, the parameters
   after an Adam step, plain and ``SOLVER.FUSED_ADAM``), bf16 steps' loss,
   launches per rank (12 + 12 attention a step at 6 local heads, all "tc";
   52 Adam a fused step) and step time beside one process's (not a scaling
   number); (b) the MoE stage-2b step (configs/tpu/uniprompt_tuned.yml, 4
   experts, top-2, 2 MoE layers) under expert parallelism and TP towers,
   fp32, aux loss included, against one process; (c)
   ``parallel.dryrun.dryrun_multichip(4)`` (its tiny shapes) on a 2 × 2 mesh,
   the L1 and min-sum kernels launched on every rank; (d) a 2-stage GPipe
   over a full-width text tower (12 × 512, L 77, causal, B 64, 4
   microbatches, fp32), forward and gradients against the blocks in
   sequence; (e) ``re_ranking_sparse_sharded`` over two ranks at
   Market-1501's scale against ``re_ranking_sparse``, with the min-sum
   kernel's launches per rank;
16. ``TPU.REMAT`` and ``TPU.ASYNC_CHECKPOINT``: (a) configs/person/vit_base.yml
   at full width and depth, then three steps of configs/veri/vit_base.yml
   (L 257), each with ``TPU.REMAT`` off and on from one set of weights and
   one generator state: the loss and every gradient of one step bit for bit
   (``torch.equal``), 12 + 12 against 24 + 12 attention launches a step
   (the recompute), all "tc", the parameters after the steps bit for bit,
   the peak of allocated memory of each mode, and the median step of each
   timed in turns on one model (with ``--profile`` the device's busy time
   over three traced steps); (b) one
   stage-2b step of configs/tpu/uniprompt_tuned.yml with bench.py's MoE and
   ``MODEL.MOE.DROPOUT`` 0.1, remat on against off bit for bit, the aux loss
   and the step generator's state after included; (c) ``do_train`` over one
   short epoch of configs/person/vit_base.yml with a checkpoint, the write
   blocking and then on a background thread: the seconds the loop spends
   in ``save_checkpoint``, the file's size, the file equal bit for bit to the
   state saved, and a failed write raising at ``wait_for_pending_saves``;
17. the compiled epochs (``engine/compiled.py``: the step captured once into
   a CUDA graph after two eager warm-up steps, then one replay a batch),
   each against the eager step loop over the same rows from one state and
   one generator state, over two epochs at different lr, bit for bit
   (``torch.equal``): (a) ``make_stage1_epoch`` for stage 1a and 1b on
   configs/ours/cctv_ir_cctv_rgb.yml (the 12 × 512 text tower, L 77,
   causal, 1,000 classes, a 4,096-row bank, batch 64): losses, contexts,
   moments; (b) ``make_train_epoch`` on configs/person/vit_base.yml over
   phase 11's resident Market-1501-size set, ``SOLVER.FUSED_ADAM`` off and
   on: losses, accuracies, every parameter and buffer (the BN running
   statistics), the moments and the generator state; (c) MoE stage 2a and
   2b under configs/tpu/uniprompt_tuned.yml (4/2/2, bf16 moments), 2b with
   ``MODEL.MOE.DROPOUT`` 0.1; (d) (b) and the MoE 2b case with
   ``TPU.REMAT`` on (the recompute's dropout draws from the graph's
   registered clones). Per case: the attention and Adam kernels one
   replay launched, counted by name in the trace of one graphed epoch that
   only replays and held against the launch counters (which a capture
   records and every replay adds), the rates of both modes in turns
   (graph, loop, loop, graph, once), the device's idle share over that
   traced epoch and the graph pool's bytes. The eager reference is the
   step body itself (``_make_stage1_body``, ``_make_step_body``);
18. the compiled steps (``engine/compiled.py::CompiledStep``: two eager
   warm-up calls a key, a CUDA graph captured at the third, replays after
   it), each against its eager body (``_make_eval_body``,
   ``_make_bank_body``, ``_make_text_body``, ``_make_step_body``,
   ``_make_stage1_body``) called on the same inputs, bit for bit
   (``torch.equal``): (a) ``run_validation`` on configs/person/vit_base.yml
   at Market-1501's query + gallery size (3,368 + 15,913 seeded images,
   batch 64, the last batch padded): every batch's features, CMC and mAP,
   the step kept in the eval cache (its rates timed over the first 76
   batches); (b) ``build_image_bank`` (4,096 images)
   and ``precompute_text_features`` (1,000 classes: 15 replayable widths and
   an eager tail of 40) on configs/ours/cctv_ir_cctv_rgb.yml; (c) the train
   step over host batches of phase 11's loader, as ``train_epochs`` feeds
   it, on configs/person/vit_base.yml with ``SOLVER.FUSED_ADAM`` off and
   on, configs/person/cnn_base.yml (RN50) and the MoE stage-2b step of
   configs/tpu/uniprompt_tuned.yml with dropout 0.1 and ``TPU.REMAT``:
   losses, accuracies, parameters, buffers, moments, step and generator
   over 3 + 3 steps at two lr; (d) stage 1b's trailing partial batch over 4
   epochs, and ``do_train_stage1`` over 3 epochs of a bank with a tail (its
   trailing step replays in the third). Per case: the kernels one replay
   ran, counted in its trace and held against the counters, the rates of
   both modes in turns (graph, eager, eager, graph, once), the traced idle
   share over 4 replays and the graph pool's bytes;
19. the TTA / TTPT steps (``engine/ttpt.py``: the TTA query step, the plain
   step with the norm fused, the TTPT query input and the tuner, each a
   ``CompiledStep`` kept on the model) on phase 12's model and images, with
   224 queries so that the fourth batch straddles the split: (a) Option A
   and (b) Option B through ``do_inference_ttpt``, twice graphed (the
   second call only replays and captures nothing) and once with every step
   replaced by its eager body (``_make_tta_query_body``,
   ``_make_eval_body(feat_norm)``, ``_make_ttpt_query_body``,
   ``_make_tuner_body``): every step call's outputs (features, the query
   inputs, tuned features, entropy traces and ``sim``), Option B's
   distances, CMC and mAP bit for bit (``torch.equal``), each call's
   launches and peak allocated memory; query images/s of both modes in
   turns (graph, eager, eager, graph, once) and, for the tuner alone,
   seconds per tuned batch the same way; per step the kernels of 4 traced
   replays against the counters, the idle share over them and the graph
   pool's bytes; then every graph is released;
20. from image files (``DATALOADER.NATIVE_DECODE``): a probe of what the
   native decoder needs on this host (g++, the libjpeg and libpng headers,
   Pillow, the host's CPUs, what ``native/`` builds), then a synthetic
   Market-1501 tree of JPEG files (750 identities × 4 images in train,
   query and gallery, 128×64, resized to 256×128), each sub-phase with the
   PIL decoder and, where the native one builds and self-checks, with it in
   turns: (a) ``ImageBatcher.decode_records`` over the 3,000 train files,
   the arrays byte for byte, images/s; (b) configs/person/vit_base.yml with
   ``SOLVER.FUSED_ADAM``, the graphed ``make_train_step`` fed by
   ``make_dataloader``'s ``TrainLoader``: six steps' losses, parameters,
   buffers, moments, step and generator bit for bit between the decoders,
   img/s in turns, the kernels of traced replays and the idle share over
   them; (c) ``run_validation`` over the query and gallery files: features,
   CMC and mAP bit for bit, feats/s; (d) ``native/rerank.py`` on the host
   against the card's dense ``re_ranking`` at 512 × 2,048 rows, both timed,
   on seeded clustered features (RERANK_TOL) and on (c)'s features (the
   card's dense against the CPU's on a 2⁻¹⁰ grid, RERANK_TOL; the host's
   native against both reported: neighbours tie there); (e)
   ``build_device_dataset`` from the files, held to (a)'s bytes. Where the
   native decoder cannot build, one line says what is missing and that
   its side of (a), (b), (c), (e) did not run;
21. the measured programs of ``mpreid_tpu_torch/utils/benchkit.py`` (the
   port of the JAX package's ``utils/benchkit.py``, which bench.py and
   tools/bench_*.py time) at bench.py's full-run widths, on
   ``uniprompt_env()`` (ViT-B/16 + the 12 × 512 text tower, 1,000 classes,
   256×128, bf16, seed 0) and ``rn50_env()`` (seed 1): (a, b) the stage-1a
   and 1b epoch windows (``stage1_harness`` + ``epoch_window``, 50 × 64
   bank rows), (c) the stage-2a step window (``stage2_harness`` +
   ``step_window``, 20 steps of 64), (d) the ViT eval scan (40 forwards of
   128) and (e) the TTA scan (10 of 128), (f) ``do_inference_tta`` over a
   ``SyntheticValLoader`` of 4 + 4 batches of 128 on the card, (g) the RN50
   baseline step window (``baseline_harness``, 20 of 64) and (h) the RN50
   eval scan. Each is timed by ``benchkit.best_of`` over 2 windows after the
   runner's own warm-up (so the windows timed only replay), with each
   window's kernel launches held to the program's (the counters set to 0
   before each); the capture's seconds and the graph pool's bytes
   reported apart; the step counter equal to the windows × the steps of a
   window; a scan's timed windows equal bit for bit and equal to the same
   chained forwards run eagerly; ``do_inference_tta``'s ranks the same in
   every window; and the memory allocated after ``benchkit.release`` within
   1 MiB of its level before the harness.

Phase 12 runs after phase 8 (on its model), phase 19 after phase 12 (on
its model), phase 13 after phase 6 and
phases 17 and 18 after phase 11 (on its resident set and its loader). On
the card every step of every phase runs through a compiled step or epoch:
the per-call steps (``make_eval_step``, ``make_image_bank_step``,
``make_text_step``, ``make_train_step``, ``make_stage1_step``, and the TTA /
TTPT steps of phases 12 and 19) replay a
captured graph from their third call with a key on, the epochs of phases
8, 9, 10, 11 and 16 that run through ``do_train_stage1`` or a
device-resident ``do_train`` / ``do_train_stage2`` from their third step;
the steps over a mesh of more than one rank (phases 14 and 15) stay eager.
A replay's kernel launches count once for every replay. Every Adam update
on the card launches the table once (``adam_table``; every optimizer here
has fewer than TABLE_LEAVES leaves in it), beside the per-leaf kernel's
launches where ``SOLVER.FUSED_ADAM`` is on; the stage-2a steps of phase 8,
phase 5's steps and the replayed steps of phases 17 and 18 also count the
leaves the table updated.
Phase 3 also holds the attention kernels at the TTPT tuner's text batch
(B 1,000, L 77, 8 × 64, causal, bf16), timed, and the L1 and min-sum
kernels (re-ranking's exact Jaccard step) against their plain versions at
the path's shapes: the Market-1501
dense shape, one MSMT17 query block × gallery chunk, and a ragged dense
case (the plain versions compared and timed on the first 256 query rows at
full G and N), and the batch-hard kernel at the PK batch (64 × 768) in fp32
and bf16, a ragged 60-row batch, a batch with a singleton identity and a
single-identity batch; and the attention kernels at one rank's heads under
a model axis of 2 (vision B 64, L 129, 6 × 64; text L 77, 4 × 64, causal;
bf16, timed).

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
    make_eval_step, make_image_bank_step, make_stage1_epoch, make_stage1_step, make_text_step,
    make_train_epoch, make_train_step, precompute_text_features, release_eval_steps,
    run_validation, stage1_loss_and_grads,
)
from mpreid_tpu_torch.engine import processor
from mpreid_tpu_torch.engine import ttpt as ttpt_engine
from mpreid_tpu_torch.engine import uniprompt as uni_engine
from mpreid_tpu_torch.engine.processor import TRACE_FILE
from mpreid_tpu_torch.engine.steps import (
    _make_bank_body, _make_eval_body, _make_stage1_body, _make_step_body, _make_text_body,
    labels_for,
)
from mpreid_tpu_torch.engine.compiled import WARMUP_STEPS
from mpreid_tpu_torch.engine.ttpt import cached_ttpt_tuner, make_ttpt_tuner, ttpt_query_input
from mpreid_tpu_torch.kernels import build
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.losses.triplet import euclidean_dist, triplet_loss
from mpreid_tpu_torch.models import (
    RN50, VIT_B16, build_model, build_model_uniprompt, load_balancing_loss, load_pretrained,
    make_model, make_model_uniprompt, switch_to_moe, topk_routing,
)
from mpreid_tpu_torch.models.layers import MultiHeadAttention
from mpreid_tpu_torch.ops import adam
from mpreid_tpu_torch.ops import attention as attn
from mpreid_tpu_torch.ops import batch_hard as bh
from mpreid_tpu_torch.ops import euclidean_squared_distmat, pairwise
from mpreid_tpu_torch.ops.reranking import smallest_k
from mpreid_tpu_torch.ops.reranking_sparse import re_ranking_sparse_rows
from mpreid_tpu_torch.ops.augment import eval_preprocess
from mpreid_tpu_torch.solver import make_optimizer, make_scheduler
from mpreid_tpu_torch.utils import benchkit

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 and bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# TF32 tensor cores, dense; the fp32 attention kernels take three TF32
# products for each multiply-add (bound_tc_ms)
PEAK_TF32_FLOPS = 495e12
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
TABLE_LEAVES = 448  # the leaves one launch of the Adam table takes (kernels/csrc/adam.cu)
STAGE2A_LEAVES, STAGE2A_BIG = 161, 53  # stage 2a's trainable leaves; those of MIN_FUSED_SIZE
TRAIN_STEPS = 24  # timed train steps
FUSED_STEPS = 12
TRAIN_IDS, TRAIN_IMGS_PER_ID = 64, 8  # in-memory train set (512 images)
CHECK_BATCH = 8  # cross-check batch, 2 ids × 4
GRAD_RTOL = 1e-3  # fp32 card vs CPU, per leaf, norm-relative (floored)
LOSS_RTOL = 1e-4
COSINE_FLOOR = 0.99
# stride 12 (L 442): the bf16 gradients through the kernels against those
# through the plain attention, each against fp32: at most this many times
# the plain path's 1 - cosine over the large leaves together, and the lowest
# single leaf at most LEAF_MARGIN under the plain path's lowest (about twice
# the gap seen either way between the two, 0.0029)
PLAIN_GAP_RATIO = 2.0
LEAF_MARGIN = 0.006
VISION = dict(name="vision", b=BATCH, l=129, heads=12, dh=64, masked=False)
TEXT = dict(name="text", b=BATCH, l=77, heads=8, dh=64, masked=True)
VEHICLE = dict(name="vehicle", b=BATCH, l=257, heads=12, dh=64, masked=False)
# configs/cross/sysu_rgb2ir.yml: 288x144 at stride 16, so L 163 (fp32 backward)
SYSU = dict(name="sysu", b=BATCH, l=163, heads=12, dh=64, masked=False)
# 256x256 at MODEL.STRIDE_SIZE [12, 12]: 21 x 21 patches + 1, L 442, past the
# 384 rows the bf16 backward stages whole (it streams them)
STRIDE12 = dict(name="stride12", b=BATCH, l=442, heads=12, dh=64, masked=False)
# untimed bf16 checks past the rows each bf16 kernel stages whole (800 / 384
# at dh 64, forward / backward; 416 / 208 at dh 128): several chunks each
LONG64 = dict(name="long64", b=4, l=1000, heads=12, dh=64, masked=False)
LONG128 = dict(name="long128", b=4, l=600, heads=6, dh=128, masked=True)
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
# the batches also timed at that width: stage 2 at batch 128, and 512, where
# every cluster's reads of all rows (B/8 clusters x B rows) add up in L2
HARD_TIMED = (128, 512)
HARD_TILED = 600  # past the 512-column tile of 16 anchor rows a cluster: two tiles
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
EPOCH_TURNS = 1  # rounds of (epoch, steps, steps, epoch)
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


def bound_ms(nbytes: float, flops: float, flops_per_s: float) -> tuple:
    """(ms, bound_by): the larger of the bytes over the memory rate and the
    operations over ``flops_per_s``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_ms(b, l, heads, dh, dtype, tf32x3: bool = False) -> tuple:
    """(ms, bound_by): qkv read once and out written once over the memory
    rate, against QKᵀ and P·V's multiply-adds over the type's peak rate, or
    with ``tf32x3`` three TF32 products each at the TF32 peak."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * l * 3 * heads * dh * size + b * l * heads * dh * size
    flops = 4 * b * heads * l * l * dh
    if tf32x3:
        return bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOPS)
    return bound_ms(nbytes, flops, PEAK_FLOPS[dtype])


def repeat_equal(fn, first: torch.Tensor) -> bool:
    """A second launch of ``fn`` gives the same bits as ``first``."""
    again = fn()
    torch.cuda.synchronize()
    return torch.equal(first, again)


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
    if dtype == torch.float32:
        row["bit_equal_repeat"] = repeat_equal(
            lambda: attn.fused_attention(qkv, heads, mask, layout=layout), out)
        row["ok"] = ok = ok and row["bit_equal_repeat"]
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
        if dtype == torch.float32:
            row["bound_tc_ms"], row["bound_tc_by"] = attention_bound_ms(b, l, heads, dh, dtype,
                                                                        tf32x3=True)
    log(f"  attention {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"attention kernel disagrees with its plain version: {row}")
    return row


def attention_bwd_bound_ms(b, l, heads, dh, dtype, tf32x3: bool = False) -> tuple:
    """(ms, bound_by): qkv and dO read once and dqkv written once over the
    memory rate, against the five L×L×dh products over the type's peak, or
    with ``tf32x3`` three TF32 products each at the TF32 peak."""
    size = torch.tensor([], dtype=dtype).element_size()
    d = heads * dh
    nbytes = b * l * (3 * d + d + 3 * d) * size
    flops = 5 * 2 * b * heads * l * l * dh
    if tf32x3:
        return bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOPS)
    return bound_ms(nbytes, flops, PEAK_FLOPS[dtype])


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
    if dtype == torch.float32:
        row["bit_equal_repeat"] = repeat_equal(
            lambda: attn.fused_attention_bwd(qkv, do, heads, mask, layout=layout), got)
        row["ok"] = ok = ok and row["bit_equal_repeat"]
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
        if dtype == torch.float32:
            row["bound_tc_ms"], row["bound_tc_by"] = attention_bwd_bound_ms(
                b, l, heads, dh, dtype, tf32x3=True)
    log(f"  attention_bwd {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"attention backward kernel disagrees with its plain version: {row}")
    return row


# sources that must show no spill at any head width; the bf16 ones are held
# to that at dh 64 only (the bf16 backward spills 52 bytes at dh 128)
SPILL_FREE = ("attention_fwd", "attention_bwd")


def ptxas_entries(text: str) -> list:
    """[(mangled entry name, {"registers", "spill_stores", "spill_loads",
    "static_smem_bytes"})] of each kernel in ptxas's ``-v`` report ``text``."""
    found = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            found.append((m.group(1), {}))
            continue
        if not found:
            continue
        current = found[-1][1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            current["static_smem_bytes"] = int(m.group(1))
    return found


def ptxas_report(names=("attention_fwd_tc", "attention_bwd_tc") + SPILL_FREE) -> dict:
    """Registers, spills and static shared memory that ptxas reported for each
    kernel of ``names`` built in this process, by head width (``dh64``), or
    by kernel and head width (``mha_bwd_rows_dh64``) where a source holds
    several kernels, with ``_chunked`` after the width for the bf16 kernels'
    chunked instances; raises where a kernel of ``SPILL_FREE`` spills, or
    another at dh 64."""
    out = {}
    for name in names:
        text = build.LOGS.get(name)
        if text is None:
            out[name] = "built before this process: not reported"
            continue
        found = []
        for mangled, props in ptxas_entries(text):
            pos, kernel = 3, ""
            while (n := re.match(r"\d+", mangled[pos:])):  # _ZN <len><name>... I
                pos += n.end() + int(n.group())
                kernel = mangled[pos - int(n.group()):pos]
            args = re.search(r"ILi(\d+)E(Lb([01])E)?", mangled)
            width = f"dh{args.group(1)}" + ("_chunked" if args.group(3) == "1" else "")
            found.append((kernel, width, props))
        several = len({kernel for kernel, _, _ in found}) > 1
        out[name] = {f"{kernel}_{width}" if several else width: props
                     for kernel, width, props in found}
    log(f"  ptxas {json.dumps(out)}")
    for name, kernels in out.items():
        if not isinstance(kernels, dict):
            continue
        for key, props in kernels.items():
            if not (props.get("spill_stores") or props.get("spill_loads")):
                continue
            if name in SPILL_FREE:
                raise AssertionError(f"{name} spills registers in {key}: {props}")
            if re.search(r"dh64(_chunked)?$", key):
                raise AssertionError(f"{name} spills registers at dh 64: {props}")
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
    # the step's scalars in device memory, as the solver forms them
    scalars = torch.tensor([lr, 1 - 0.9 ** t, 1 - 0.999 ** t], dtype=torch.float32, device=dev)
    args = (scalars, 0.9, 0.999, 1e-8, wd, decoupled)
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    p3, m3, v3 = p.clone(), m.clone(), v.clone()
    adam.fused_adam_leaf(p, m, v, g, *args)
    adam.fused_adam_leaf(p3, m3, v3, g, *args)  # a second launch: bit-equal to the first
    adam.adam_leaf_plain(p2, m2, v2, g, *args)
    torch.cuda.synchronize()
    repeat = all(torch.equal(x, y) for x, y in ((p, p3), (m, m3), (v, v3)))
    del p3, m3, v3
    errs = [(x.float() - y.float()).abs().max().item() for x, y in ((p, p2), (m, m2), (v, v2))]
    ok = all((x.float() - y.float()).abs().le(ADAM_RTOL * y.float().abs() + atol).all().item()
             for x, y, atol in ((p, p2, ADAM_ATOL_LR * lr), (m, m2, 0.0), (v, v2, 0.0)))
    row = dict(moment_dtype=str(moment_dtype).split(".")[-1], decoupled=decoupled,
               shape=list(C_FC), max_abs_err=max(errs), max_abs_err_p=errs[0],
               rtol=ADAM_RTOL, atol_p=ADAM_ATOL_LR * lr, ok=ok, bit_equal_repeat=repeat)
    if timed:
        row["ms"] = cuda_ms(lambda: adam.fused_adam_leaf(p, m, v, g, *args))
        row["plain_ms"] = cuda_ms(lambda: adam.adam_leaf_plain(p2, m2, v2, g, *args))
        leaf = p.clone().requires_grad_(True)
        leaf.grad = g.clone()
        opt = torch.optim.Adam([leaf], lr=lr, weight_decay=wd, fused=True)
        row["library_ms"] = cuda_ms(opt.step)
        row["bound_ms"], row["bound_by"] = adam_bound_ms(p.numel(), moment_dtype)
    log(f"  adam {json.dumps(row)}")
    if not (ok and repeat):
        raise AssertionError(f"Adam kernel disagrees with its plain version or itself: {row}")
    return row


def graph_ms(fn, reps: int = 10, runs: int = 30) -> float:
    """Median ms of one ``fn()`` over ``runs`` CUDA-event timings of a
    replay of a CUDA graph of ``reps`` calls (two eager calls on a side
    stream first), per call: the device's work alone, however many
    launches ``fn`` makes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def check_adam_table() -> dict:
    """The Adam update of stage 2a's trainable leaves (the Uni-Prompt
    ViT-B/16 of configs/ours/cctv_ir_cctv_rgb.yml's settings: fp32
    parameters, gradients and moments, Adam, lr multipliers 1 and 2) on the
    card, three ways from one state: ``adam_leaves`` over every leaf (one
    launch, the route with ``SOLVER.FUSED_ADAM`` off), ``fused_adam_leaf``
    on the leaves of at least MIN_FUSED_SIZE elements and the table on the
    rest (the route with it on), and ``adam_leaf_plain`` on every leaf (the
    per-op update): both routes bit for bit the per-op one. Each is timed
    as a train step runs it, replayed in a CUDA graph (``graph_ms``: the
    per-op update's ~2,900 launches outrun the launch queue that
    ``cuda_ms``'s sleep hides enqueueing behind), beside
    ``torch.optim.Adam(fused=True, capturable=True)`` over the same leaves
    (its math is not the port's, so it is timed, not compared) and the
    bound: 28 bytes an element (p, m, v, g read; p, m, v written) at the
    memory rate."""
    dev = torch.device("cuda")
    cfg = uniprompt_cfg()
    with torch.device("meta"):
        model = build_model_uniprompt(cfg, UNI_CLASSES, 14, UNI_VIEWS)
    opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    shapes = {k: p.shape for k, p in opt.partition(model)[0].items()}
    big = {k for k, s in shapes.items() if s.numel() >= adam.MIN_FUSED_SIZE}
    if (len(shapes), len(big)) != (STAGE2A_LEAVES, STAGE2A_BIG):
        raise AssertionError(f"stage 2a trains {len(shapes)} leaves, {len(big)} of at least "
                             f"{adam.MIN_FUSED_SIZE} elements; expected {STAGE2A_LEAVES}, "
                             f"{STAGE2A_BIG}")
    gen = torch.Generator(device=dev).manual_seed(5)
    p = {k: torch.randn(s, device=dev, generator=gen) * 0.02 for k, s in shapes.items()}
    g = {k: torch.randn(s, device=dev, generator=gen) * 1e-3 for k, s in shapes.items()}
    m = {k: torch.randn(s, device=dev, generator=gen) * 1e-4 for k, s in shapes.items()}
    v = {k: torch.rand(s, device=dev, generator=gen) * 1e-7 for k, s in shapes.items()}
    mult, wd, t = opt.lr_mult, opt.wd, 7
    scalars = {x: torch.tensor([5e-6 * x, 1 - 0.9 ** t, 1 - 0.999 ** t], device=dev)
               for x in set(mult.values())}
    b = (opt.b1, opt.b2, opt.eps)

    def table(ps, ms, vs, keys):
        adam.adam_leaves([(ps[k], ms[k], vs[k], g[k], scalars[mult[k]], wd[k]) for k in keys],
                         *b, False)

    def per_leaf(ps, ms, vs):
        for k in big:
            adam.fused_adam_leaf(ps[k], ms[k], vs[k], g[k], scalars[mult[k]], *b, wd[k], False)
        table(ps, ms, vs, [k for k in shapes if k not in big])

    def per_op(ps, ms, vs):
        for k in shapes:
            adam.adam_leaf_plain(ps[k], ms[k], vs[k], g[k], scalars[mult[k]], *b, wd[k], False)

    routes = {"ms": lambda *s: table(*s, shapes), "per_leaf_route_ms": per_leaf,
              "plain_ms": per_op}
    after = {}
    for name, fn in routes.items():
        state = tuple({k: x.clone() for k, x in d.items()} for d in (p, m, v))
        reset_counts()
        fn(*state)
        after[name] = (state, read_counts(), table_leaves())
    torch.cuda.synchronize()

    def equal(x, y):
        return all(torch.equal(a[k], c[k]) for a, c in zip(x, y) for k in shapes)

    n = sum(s.numel() for s in shapes.values())
    want = {"ms": {"adam_table": 1}, "per_leaf_route_ms": {"adam": len(big), "adam_table": 1},
            "plain_ms": {}}
    row = dict(leaves=len(shapes), elements=n, big_leaves=len(big),
               launches={name: a[1] for name, a in after.items()},
               table_leaves={name: a[2] for name, a in after.items()},
               table_bit_equal_per_op=equal(after["ms"][0], after["plain_ms"][0]),
               per_leaf_route_bit_equal_per_op=equal(after["per_leaf_route_ms"][0],
                                                     after["plain_ms"][0]),
               bound_ms=28 * n / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
    del after
    for name, fn in routes.items():
        state = tuple({k: x.clone() for k, x in d.items()} for d in (p, m, v))
        row[name] = graph_ms(lambda: fn(*state))
        del state
    leaves = [torch.nn.Parameter(p[k].clone()) for k in shapes]
    groups = {}
    for x, k in zip(leaves, shapes):
        x.grad = g[k]
        groups.setdefault(mult[k], []).append(x)
    library = torch.optim.Adam([{"params": xs, "lr": torch.tensor(5e-6 * mk, device=dev)}
                                for mk, xs in groups.items()],
                               weight_decay=1e-4, fused=True, capturable=True)
    row["library_ms"] = graph_ms(library.step)
    del leaves, groups, library
    log(f"  adam table {json.dumps(row)}")
    for name, counts in row["launches"].items():
        expect_counts(f"Adam table check, {name}", counts, want[name])
    if row["table_leaves"] != {"ms": len(shapes), "per_leaf_route_ms": len(shapes) - len(big),
                               "plain_ms": 0}:
        raise AssertionError(f"Adam table check: leaves updated {row['table_leaves']}")
    if not (row["table_bit_equal_per_op"] and row["per_leaf_route_bit_equal_per_op"]):
        raise AssertionError(f"an Adam route disagrees with the per-op update: {row}")
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
        row["floor_ms"] = cuda_ms(lambda: bh.launch_floor(f, lab))
        row["plain_ms"] = cuda_ms(lambda: bh.batch_hard_plain(f, lab))
        x = f.float()
        row["library_ms"] = cuda_ms(lambda: torch.cdist(x, x))
        row["library"] = "torch.cdist(x, x): the distance matrix alone"
        row["bound_ms"], row["bound_by"] = batch_hard_bound_ms(b, d, dtype)
        row["smem_bytes"] = bh.shared_bytes(b, d)
        row["shape_ms"] = {f"{rows}_rows": cuda_ms(lambda: bh.launch_at_shape(f, lab, shape))
                           for shape, rows in enumerate((8, 16))}
    log(f"  batch_hard {json.dumps(row)}")
    if not ok:
        raise AssertionError(f"batch-hard kernel disagrees with its plain version: {row}")
    return row


def batch_hard_rows() -> list:
    """Phase 3's batch-hard cases: the PK batch (64 × 768) in fp32 (timed)
    and bf16, a ragged 60-row batch, on grid features a batch with a
    singleton identity and a single-identity batch (no negatives), a batch
    of ``HARD_TILED`` rows in fp32 and bf16 (two tiles), and the fp32
    batches of ``HARD_TIMED`` (timed)."""
    b, d = HARD["b"], HARD["d"]
    singleton = [i // K_INST for i in range(b - 1)] + [b]
    return [check_batch_hard("pk", b, d, torch.float32, timed=True),
            check_batch_hard("pk", b, d, torch.bfloat16, timed=False),
            check_batch_hard("ragged", 60, d, torch.float32, timed=False),
            check_batch_hard("singleton", b, d, torch.float32, False, singleton, grid=True),
            check_batch_hard("one_identity", b, d, torch.bfloat16, False, [0] * b, grid=True),
            check_batch_hard("two_tiles", HARD_TILED, d, torch.float32, timed=False),
            check_batch_hard("two_tiles", HARD_TILED, d, torch.bfloat16, timed=False)] + [
        check_batch_hard("pk", n, d, torch.float32, timed=True) for n in HARD_TIMED]


def batch_hard_ptxas() -> dict:
    """Registers, spills and static shared memory that ptxas reported for each
    kernel of ``batch_hard.cu`` built in this process, by instantiation
    (``fp32_w8_rw1_rg2_cg1_m1``: the feature type, warps a block, anchor
    rows a warp, anchor rows and columns an item, items a thread;
    ``floor_fp32``: the empty kernel); raises on a spill. Its shared memory
    is dynamic: ``smem_bytes`` of each timed row."""
    text = build.LOGS.get("batch_hard")
    if text is None:
        return {"batch_hard": "built before this process: not reported"}
    out = {}
    kind = {"f": "fp32", "13__nv_bfloat16": "bf16"}
    for mangled, props in ptxas_entries(text):
        k = re.search(r"batch_hard_kernelI(f|13__nv_bfloat16)" + r"Li(\d+)E" * 5, mangled)
        e = re.search(r"empty_kernelI(f|13__nv_bfloat16)E", mangled)
        key = (kind[k.group(1)] + "".join(f"_{n}{v}" for n, v in zip(
                   ("w", "rw", "rg", "cg", "m"), k.groups()[1:])) if k
               else f"floor_{kind[e.group(1)]}" if e else mangled)
        out[key] = props
    log(f"  ptxas batch_hard {json.dumps(out)}")
    spilled = {k: v for k, v in out.items() if v.get("spill_stores") or v.get("spill_loads")}
    if spilled:
        raise AssertionError(f"batch_hard.cu spills registers: {spilled}")
    return out


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
# the same at MODEL.STRIDE_SIZE [12, 12], as train.py takes the key on the
# command line: 21 x 21 patches + 1, L 442
VERI_STRIDE12 = {**VERI, "MODEL": {**VERI["MODEL"], "STRIDE_SIZE": [12, 12]}}


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
        super().__init__(records, images.shape[1:3], batch_size, num_workers=4, native=False)
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
           "minsum_cross": pairwise.minsum_cross, "batch_hard": bh.fused_batch_hard,
           "adam_table": adam.adam_leaves}
ROUTED = {"attention_fwd": attn.fused_attention, "attention_bwd": attn.fused_attention_bwd}


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
    adam.adam_leaves.leaves = 0
    for fn in ROUTED.values():
        fn.launches_by_route = dict.fromkeys(attn.ROUTES, 0)


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def table_leaves() -> int:
    """The leaves the Adam table updated since ``reset_counts``."""
    return adam.adam_leaves.leaves


def routed_to_table(opt, params) -> int:
    """The trainable leaves of ``params`` that ``opt`` updates in the Adam
    table on the card."""
    train, _ = opt.partition(params)
    n = sum(opt.route(p) == "table" for p in train.values())
    if n > TABLE_LEAVES:
        raise AssertionError(f"{n} leaves in the Adam table: more than one launch an update")
    return n


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
    counts, leaves = read_counts(), table_leaves()
    expect_counts("train steps", counts, {"attention_fwd": depth * TRAIN_STEPS,
                                          "attention_bwd": depth * TRAIN_STEPS, "adam": 0,
                                          "adam_table": TRAIN_STEPS})
    if leaves != routed_to_table(optimizer, model) * TRAIN_STEPS:
        raise AssertionError(f"train steps: the Adam table updated {leaves} leaves in "
                             f"{TRAIN_STEPS} steps, expected every trainable leaf each step")
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
               launches_by_route=read_routes(), table_leaves=leaves,
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
                                                    "attention_bwd": depth * n_epoch, "adam": 0,
                                                    "adam_table": n_epoch})
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
    fused_counts, fused_leaves = read_counts(), table_leaves()
    expect_counts("fused-Adam steps", fused_counts, {
        "attention_fwd": depth * FUSED_STEPS, "attention_bwd": depth * FUSED_STEPS,
        "adam": len(big) * FUSED_STEPS, "adam_table": FUSED_STEPS})
    if fused_leaves != (len(train) - len(big)) * FUSED_STEPS:
        raise AssertionError(f"fused-Adam steps: the Adam table updated {fused_leaves} leaves "
                             f"in {FUSED_STEPS} steps, expected the {len(train) - len(big)} "
                             f"below MIN_FUSED_SIZE each step")
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError("non-finite loss with SOLVER.FUSED_ADAM")
    f_q1, f_med, f_q3 = (float(x) for x in np.percentile(sorted(BATCH / x for x in fused_s),
                                                         [25, 50, 75]))
    res_fused = dict(steps=FUSED_STEPS, big_leaves=len(big), launches=fused_counts,
                     table_leaves=fused_leaves,
                     step_ms_median=float(np.median(fused_s)) * 1e3, train_img_per_s=f_med,
                     train_img_per_s_q1=f_q1, train_img_per_s_q3=f_q3,
                     **fused_update_check(model, cfg, loss_fn, opt_fused, state_f, batches[0],
                                          lr))
    log(f"fused adam {json.dumps(res_fused)}")
    if profile:
        profile_train(step, state, batches, lr, gen)
    return dict(model=model, train=res, epoch=res_epoch, fused=res_fused, big_leaves=len(big))


def fused_update_check(model, cfg, loss_fn, opt, state_f, batch, lr) -> dict:
    """One update from the same state and gradients, ``SOLVER.FUSED_ADAM``'s
    routes (the per-leaf kernel and the table) against the per-op update of
    every leaf (``adam_leaf_plain``): parameters within ADAM_RTOL·|p| +
    ADAM_ATOL_LR·lr·mult (a step that differs in its last bits moves p by an
    ulp of p), moments within ADAM_RTOL relative; whether they are equal bit
    for bit is reported."""
    from mpreid_tpu_torch.solver import OptState

    x = eval_preprocess(batch["images"], mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD)
    _, _, grads, _ = loss_and_grads(model, cfg, loss_fn, opt, x, batch["pids"].long())
    train, _ = opt.partition(model)
    results = []
    for plain in (False, True):
        params = {k: p.detach().clone() for k, p in train.items()}
        st = OptState(step=state_f.opt_state.step.clone(),
                      mu={k: t.clone() for k, t in state_f.opt_state.mu.items()},
                      nu={k: t.clone() for k, t in state_f.opt_state.nu.items()},
                      lr=state_f.opt_state.lr.clone())
        if plain:
            opt.set_lr(st, lr)
            st.step.add_(1)
            scalars = opt.step_scalars(st)
            for k, p in params.items():
                adam.adam_leaf_plain(p, st.mu[k], st.nu[k], grads[k].contiguous(),
                                     scalars[opt.lr_mult[k]], opt.b1, opt.b2, opt.eps, opt.wd[k],
                                     opt.name == "AdamW")
        else:
            st = opt.update(grads, st, params, lr)
        results.append((params, st))
    torch.cuda.synchronize()
    (pf, sf), (pp, sp) = results

    def excess(a, b, atol):  # largest |a - b| over its allowance
        return ((a.float() - b.float()).abs() / (ADAM_RTOL * b.float().abs() + atol)).max().item()

    p_x = max(excess(pf[k], pp[k], ADAM_ATOL_LR * lr * opt.lr_mult[k]) for k in pf)
    m_x = max(excess(st_f[k], st_p[k], 1e-30) for st_f, st_p in ((sf.mu, sp.mu), (sf.nu, sp.nu))
              for k in pf)
    p_err = max(((pf[k] - pp[k]).abs().max() / (lr * opt.lr_mult[k])).item() for k in pf)
    bits = all(torch.equal(a[k], b[k]) for a, b in ((pf, pp), (sf.mu, sp.mu), (sf.nu, sp.nu))
               for k in pf)
    res = dict(fused_vs_plain_max_param_err_lr_units=p_err, param_err_over_allowance=p_x,
               moment_err_over_allowance=m_x, rtol=ADAM_RTOL, atol_lr_units=ADAM_ATOL_LR,
               fused_vs_plain_bit_equal=bits)
    if not (p_x <= 1.0 and m_x <= 1.0):
        raise AssertionError(f"fused Adam update disagrees with the per-op one: {res}")
    return res


def run_vehicle_train(settings: dict = VERI, case: dict = VEHICLE) -> tuple:
    """configs/veri/vit_base.yml (or ``settings``) at full width: ViT-B/16 at
    256×256 (L 257; ``case["l"]`` with ``settings``' stride), 576 classes,
    bf16 over fp32, VEHICLE_STEPS train steps on PK batches of seeded images
    (augmentation on, Adam): finite losses and 12 + 12 attention launches a
    step, all on the tensor-core route. Returns the result and the model."""
    cfg = vit_base_cfg(device=CARD, settings=settings)
    model = make_model(cfg, num_class=VEHICLE_CLASSES, camera_num=VEHICLE_CAMERAS, view_num=1)
    depth = len(model.image_encoder.transformer.resblocks)
    length = model.image_encoder.positional_embedding.shape[0]
    if length != case["l"]:
        raise AssertionError(f"vehicle ViT-B/16 sequence length {length}, expected {case['l']}")
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
                                                  "attention_bwd": depth * VEHICLE_STEPS,
                                                  "adam_table": VEHICLE_STEPS})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite vehicle train loss: {losses}")
    res = dict(config="configs/veri/vit_base.yml", stride=cfg.MODEL.STRIDE_SIZE,
               hw=list(VEHICLE_HW), seq_len=length, classes=VEHICLE_CLASSES,
               steps=VEHICLE_STEPS, batch=BATCH, losses=losses, step_seconds=seconds,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
               launches_by_route=read_routes())
    log(f"vehicle train {json.dumps(res)}")
    return res, model


@contextlib.contextmanager
def plain_attention():
    """bf16 attention on the card through the plain versions (no kernel, no
    launch counted) inside the block: a reference for the kernels."""
    launchers = attn._launch_cuda, attn._launch_bwd_cuda
    attn._launch_cuda = attn.attention_plain
    attn._launch_bwd_cuda = attn.attention_bwd_plain
    try:
        yield
    finally:
        attn._launch_cuda, attn._launch_bwd_cuda = launchers


def grad_cosines(got: dict, want: dict, leaves: list) -> dict:
    """Cosine of ``got`` against ``want``: over all ``leaves`` concatenated
    (``all``), and the lowest single leaf's (``min_leaf``, ``min_leaf_name``)."""
    per = {k: F.cosine_similarity(got[k].flatten(), want[k].flatten(), dim=0).item()
           for k in leaves}
    total = F.cosine_similarity(torch.cat([got[k].flatten() for k in leaves]),
                                torch.cat([want[k].flatten() for k in leaves]), dim=0).item()
    worst = min(per, key=per.get)
    return dict(all=total, min_leaf=per[worst], min_leaf_name=worst)


def run_stride12(model) -> dict:
    """The stride-12 VeRi model of phase 5 (L 442, past the rows the bf16
    backward stages whole) after its train steps: a train step's gradients
    (augmentation off, a PK batch of 2 × 4) in bf16 against fp32 on the card
    (fp32 launches the "tf32x3" kernels), cosine over the leaves of at least
    MIN_FUSED_SIZE elements taken together at least COSINE_FLOOR, and held
    to the same with the bf16 attention through the plain versions (the bf16
    model's own rounding, kernels aside): 1 - cosine over the leaves
    together at most PLAIN_GAP_RATIO times the plain path's, the lowest
    single leaf's at most LEAF_MARGIN under the plain path's lowest (a
    single leaf's floor of COSINE_FLOOR fails at L 442 on either path); then
    one ``do_inference`` over 64 + 64 seeded images: 12 attention launches a
    batch of 64, all on "tc", finite features of the eval width."""
    images, pids = train_images(seed=41, hw=VEHICLE_HW)
    batch = pk_batches(images, pids, 1, ids=CHECK_BATCH // K_INST, seed=42)[0]
    del images
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def grads(dtype):
        c = vit_base_cfg(dtype, CARD, VERI_STRIDE12)
        return step_loss_and_grads(weights, c, batch, CARD, VEHICLE_CLASSES, VEHICLE_CAMERAS)[1]

    depth = len(model.image_encoder.transformer.resblocks)
    fp32 = grads("float32")
    reset_counts()
    bf16 = grads("bfloat16")
    expect_counts("stride-12 bf16 step", read_counts(),
                  {"attention_fwd": depth, "attention_bwd": depth})
    with plain_attention():
        bf16_plain = grads("bfloat16")
    big = [k for k, g in fp32.items() if g.numel() >= adam.MIN_FUSED_SIZE]
    cos = grad_cosines(bf16, fp32, big)
    cos_plain = grad_cosines(bf16_plain, fp32, big)
    del fp32, bf16, bf16_plain
    torch.cuda.empty_cache()

    cfg = vit_base_cfg(device=CARD, settings=VERI_STRIDE12)
    loader = InMemoryBatcher(QUERY // 2, GALLERY // 2, BATCH, VEHICLE_HW, seed=43)
    reset_counts()
    t0 = time.perf_counter()
    r1, r5 = do_inference(cfg, model, loader, QUERY // 2)
    eval_s = time.perf_counter() - t0
    expect_counts("stride-12 do_inference", read_counts(),
                  {"attention_fwd": depth * (QUERY + GALLERY) // 2 // BATCH})
    eval_launches = read_counts()["attention_fwd"]
    feats = make_eval_step(model, cfg)({"images": torch.from_numpy(
        next(loader.iter_sequential())["images"]).to(CARD)})
    finite = bool(torch.isfinite(feats.float()).all().item())
    res = dict(bf16_vs_fp32_grad_cosine=cos, bf16_plain_attention_vs_fp32_grad_cosine=cos_plain,
               cosine_floor=COSINE_FLOOR, plain_gap_ratio=PLAIN_GAP_RATIO,
               leaf_margin=LEAF_MARGIN, large_leaves=len(big),
               eval_images=(QUERY + GALLERY) // 2,
               eval_seconds_first_call=eval_s, rank1=float(r1), rank5=float(r5),
               eval_feature_shape=list(feats.shape), eval_finite=finite,
               eval_launches=eval_launches)
    log(f"stride-12 checks {json.dumps(res)}")
    if not cos["all"] >= COSINE_FLOOR:
        raise AssertionError(f"stride 12: bf16 vs fp32 gradient cosine below {COSINE_FLOOR}: {res}")
    if not 1 - cos["all"] <= PLAIN_GAP_RATIO * (1 - cos_plain["all"]):
        raise AssertionError(f"stride 12: the kernels' bf16 gradients are more than "
                             f"{PLAIN_GAP_RATIO}x further from fp32 than the plain path's: {res}")
    if not cos["min_leaf"] >= cos_plain["min_leaf"] - LEAF_MARGIN:
        raise AssertionError(f"stride 12: the kernels' lowest leaf cosine is more than "
                             f"{LEAF_MARGIN} under the plain path's: {res}")
    if not finite or tuple(feats.shape) != (BATCH, model.in_planes + model.in_planes_proj):
        raise AssertionError(f"stride 12: bad eval features: {res}")
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


def step_loss_and_grads(weights: dict, c, batch: dict, device, classes: int = NUM_CLASSES,
                        cameras: int = 6) -> tuple:
    """(loss, {name: fp32 gradient on the CPU}) of one baseline train step of
    the model ``c`` builds, from ``weights``, augmentation off, on ``device``."""
    from mpreid_tpu_torch.engine.steps import augment_args
    from mpreid_tpu_torch.ops.augment import train_augment

    c.INPUT.PROB, c.INPUT.PADDING, c.INPUT.RE_PROB = 0.0, 0, 0.0
    m = build_model(c, classes, cameras, 1)
    m.load_state_dict(weights, strict=True)
    m = m.to(device)
    loss_fn, _ = make_loss(c, classes)
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
                                                       "attention_bwd": tdepth * n_steps,
                                                       "adam_table": n_steps})
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
    counts, leaves = read_counts(), table_leaves()
    expect_counts("stage 2a steps", counts, {"attention_fwd": vdepth * STAGE2A_STEPS,
                                             "attention_bwd": vdepth * STAGE2A_STEPS,
                                             "adam_table": STAGE2A_STEPS})
    if leaves != STAGE2A_LEAVES * STAGE2A_STEPS or \
            routed_to_table(opt_2a, model) != STAGE2A_LEAVES:
        raise AssertionError(f"stage 2a steps: the Adam table updated {leaves} leaves in "
                             f"{STAGE2A_STEPS} steps, expected {STAGE2A_LEAVES} a step")
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite stage-2a loss: {losses}")
    q1, med, q3 = (float(x) for x in np.percentile(sorted(BATCH / x for x in seconds),
                                                   [25, 50, 75]))
    res["stage2a"] = dict(steps=STAGE2A_STEPS, batch=BATCH, train_img_per_s=med,
                          train_img_per_s_q1=q1, train_img_per_s_q3=q3,
                          step_ms_median=float(np.median(seconds)) * 1e3, launches=counts,
                          table_leaves=leaves,
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
        "attention_fwd": tdepth * n_text + vdepth * n_2b, "attention_bwd": vdepth * n_2b,
        "adam_table": n_2b})
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


def adam_step_errors(p_got: dict, p_want: dict, g_got: dict, g_want: dict, weights: dict,
                     opt, lr: float) -> dict:
    """Parameters after Adam's first step, got against want, in units of
    lr·mult. Adam's first step is lr·g'/(|g'| + eps) with g' = g + wd·p:
    where |g'| < 100·eps, or where the two runs' g' differ in sign, rounding
    of g' moves it by up to lr either way, so those elements (counted) are
    held to 2·lr·mult and the rest to 0.25·lr·mult."""
    worst, worst_all, n_small, n_flip = 0.0, 0.0, 0, 0
    for k, p in p_want.items():
        err = (p_got[k] - p).abs() / (lr * opt.lr_mult[k])
        g_w, g_g = (g[k] + opt.wd[k] * weights[k] for g in (g_want, g_got))
        flip = torch.sign(g_w) != torch.sign(g_g)
        small = (g_w.abs() < 100 * opt.eps) | flip
        n_small += int(small.sum())
        n_flip += int(flip.sum())
        worst = max(worst, err[~small].max().item() if bool((~small).any()) else 0.0)
        worst_all = max(worst_all, err.max().item())
    return dict(worst_param_err_lr_units=worst, elements_near_zero_step=n_small,
                elements_with_flipped_step=n_flip,
                worst_param_err_lr_units_near_zero_step=worst_all,
                params_ok=worst <= 0.25 and worst_all <= 2.0)


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
        checks[stage] = dict(
            loss_rel=abs(l_gpu - l_cpu) / abs(l_cpu),
            worst_grad_rel=max(_rel_err(g_gpu[k], g, floor) for k, g in g_cpu.items()),
            zero_grad_leaves=len(zero), zero_on_card=all(not bool(g_gpu[k].any()) for k in zero),
            **adam_step_errors(p_gpu, p_cpu, g_gpu, g_cpu, weights, opt, lr),
            leaves=len(g_cpu))
        log(f"uniprompt step cross-check {stage} {json.dumps(checks[stage])}")
        if not (checks[stage]["loss_rel"] <= LOSS_RTOL and checks[stage]["worst_grad_rel"]
                <= GRAD_RTOL and checks[stage]["zero_on_card"] and checks[stage]["params_ok"]):
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


def query_agg(model, cfg, images: np.ndarray) -> torch.Tensor:
    """TTPT's query input for uint8 ``images``, as ``do_inference_ttpt`` builds it
    (``ttpt_query_input``: the query-input step kept on the model)."""
    labels = np.zeros(len(images), np.int32)
    return ttpt_query_input(model, cfg, {"images": images, "camids": labels, "trackids": labels})


def run_ttpt(model, profile: bool) -> dict:
    """The TTA / TTPT eval modes (``test_uniprompt``'s branches) on the
    Uni-Prompt model after stage 2, over TTPT_QUERY + TTPT_GALLERY seeded
    images at batch 64, bf16: Option A through ``do_inference_ttpt`` with
    TTA on and TTPT off (4 vision forwards a query batch; timed after a
    warm-up run, so every step replays a CUDA graph), then Option B with
    TTA on (2 vision forwards a query batch and, for each, TTPT_STEPS + 1
    text forwards and TTPT_STEPS backwards over all UNI_CLASSES classes;
    timed cold: two eager query batches, the tuner's capture, one replay);
    each with its launches, all on "tc". Then one query batch's
    tuning alone through the tuner ``do_inference_ttpt`` keeps (replays),
    timed, and its entropy trace (``profile``: a new tuner's first call,
    eager, traced by kernel and operator group, with the device's idle
    share)."""
    vdepth = len(model.image_encoder.transformer.resblocks)
    tdepth = len(model.text_encoder.transformer.resblocks)
    loader = InMemoryBatcher(TTPT_QUERY, TTPT_GALLERY, BATCH, HW, seed=13)
    nq, ng = TTPT_QUERY // BATCH, TTPT_GALLERY // BATCH
    n = TTPT_QUERY + TTPT_GALLERY
    res = {}
    cfg = ttpt_cfg(tta=True, ttpt=False)
    do_inference_ttpt(cfg, model, loader, TTPT_QUERY)  # warm-up and capture: the timed run replays
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
    tuner = cached_ttpt_tuner(model, cfg)
    agg = query_agg(model, cfg, loader.images[:BATCH])
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
                       timed="the first call: two eager query batches, the capture, a replay",
                       steps=TTPT_STEPS, classes=UNI_CLASSES, rank1=r1, rank5=r5,
                       peak_mem_gb=peak, launches=counts,
                       seconds_per_tuned_batch=statistics.median(tune_s),
                       tuned_batch_seconds=tune_s, entropy_trace=trace)
    if profile:
        res["tuner_profile"] = profile_idle(
            lambda: make_ttpt_tuner(model, cfg)(agg),
            f"one tuned query batch, eager ({TTPT_STEPS} steps, text B {UNI_CLASSES}, bf16)",
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
            agg = query_agg(m, c, images[:TTPT_CHECK_QUERIES])
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
            "adam": big * MARGIN_STEPS if fused else 0, "adam_table": MARGIN_STEPS})
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
    return identity_images(pids, ids, seed), pids, cams


def identity_images(pids: np.ndarray, ids: int, seed: int) -> np.ndarray:
    """Seeded uint8 images of ``HW``, one per entry of ``pids``: a pattern of
    its identity plus per-image noise, drawn on the card in chunks and held
    on the host, as a loader holds decoded images."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    base = torch.randint(40, 215, (ids, *HW, 3), generator=gen, device=CARD, dtype=torch.int16)
    images = np.empty((len(pids), *HW, 3), np.uint8)
    pid_t = torch.from_numpy(pids).to(CARD).long()
    for lo in range(0, len(pids), 1024):
        sel = pid_t[lo:lo + 1024]
        noise = torch.randint(-60, 61, (len(sel), *HW, 3), generator=gen, device=CARD,
                              dtype=torch.int16)
        images[lo:lo + len(sel)] = (base[sel] + noise).clamp_(0, 255).to(torch.uint8).cpu().numpy()
    return images


def trace_idle_share(path: str, span: str = None) -> dict:
    """The device's busy time and idle share over a Chrome trace that
    ``torch.profiler`` wrote: the union of its kernel, copy and memset spans
    against the span of every event in it, or of the events named ``span``
    (a ``record_function``), with the device spans clipped to it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e["name"] == span] if span is not None else events
    if not marks:
        raise AssertionError(f"the trace holds no span {span!r}")
    first = min(e["ts"] for e in marks)
    last = max(e["ts"] + e["dur"] for e in marks)
    device = sorted((max(e["ts"], first), min(e["ts"] + e["dur"], last)) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for lo, hi in device:
        if hi > end and hi > lo:
            busy += hi - max(lo, end)
            end = hi
    window = last - first
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
                                                    "attention_bwd": depth * 2 * n_epoch[0],
                                                    "adam_table": 2 * n_epoch[0]})
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
                     f"epoch, {EPOCH_TURNS} round(s)", img_per_s=rates,
                     median_img_per_s={k: float(np.median(v)) for k, v in rates.items()},
                     card=CARD_LINE)
    log(f"device epoch against the step loop, img/s in turns {json.dumps(res_rates)}")
    rate_line("device-epoch vs step-loop train img/s (configs/person/vit_base.yml, batch 64, "
              f"medians of {2 * EPOCH_TURNS} turns of {EPOCH_CHECK_STEPS} steps)",
              res_rates["median_img_per_s"])
    for r in runs.values():
        r["epoch"].release()
    del runs
    return dict(res=res, check=check, rates=res_rates, loader=loader, data=data)


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
            "attention_fwd": tdepth * n_text + vdepth * n, "attention_bwd": vdepth * n,
            "adam_table": n})
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
RN50_TRAIN_STEPS = 3  # timed, after the warm-up steps and the capture
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
    images (a warm-up run, then RN50_EVAL_RUNS timed), then three warm-up
    train steps (two eager, the third captures the step) and
    RN50_TRAIN_STEPS timed ones, replays, on PK 16 × 4 batches
    (augmentation on, Adam); no kernel of the port runs on this path."""
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
    warm = WARMUP_STEPS + 1  # two eager steps and the capture: the timed steps replay
    batches = pk_batches(images, pids, warm + RN50_TRAIN_STEPS, seed=14)
    state = initial_state(model, optimizer)
    step = make_train_step(model, cfg, loss_fn, optimizer)
    gen = torch.Generator(device=CARD).manual_seed(int(cfg.SOLVER.SEED))
    for batch in batches[:warm]:
        state, _ = step(state, batch, lr, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, losses = [], []
    for batch in batches[warm:]:
        (state, metrics), secs = timed(lambda: step(state, batch, lr, gen))
        seconds.append(secs)
        losses.append(float(metrics["loss"]))
    expect_counts("RN50 train steps", read_counts(), {"adam_table": RN50_TRAIN_STEPS})
    tracked = int(model.image_encoder.bn1.num_batches_tracked)
    if not all(np.isfinite(losses)) or tracked != warm + RN50_TRAIN_STEPS:
        raise AssertionError(f"RN50 train steps: losses {losses}, BN batches {tracked}")
    res.update(train_img_per_s=BATCH / statistics.median(seconds), step_seconds=seconds,
               losses=losses, bn_batches_tracked=tracked,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"RN50 baseline {json.dumps(res)}")
    if profile:
        res["train_profile"] = profile_idle(
            lambda: [step(state, batches[warm + i], lr, gen) for i in range(RN50_TRAIN_STEPS)],
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
                       "attention_bwd": tdepth * RN50_STAGE1_STEPS,
                       "adam_table": RN50_STAGE1_STEPS})
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
    expect_counts("RN50 stage 2a steps", launches["stage2a_steps"],
                  {"adam_table": RN50_STAGE2A_STEPS})
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
                  {"attention_fwd": tdepth * -(-VEHICLE_CLASSES // BATCH), "adam_table": 1})
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


# ---------------------------------------------------------------------------
# phase 14: data parallelism over torch.distributed (the data axis)
# ---------------------------------------------------------------------------

DP_RANKS = 2  # ranks sharing the one card over gloo (NCCL refuses two ranks on one device)
DP_TIMEOUT = 600  # seconds each spawned two-rank job may take
DP_TIMED_STEPS = 2  # after a warm-up step: two ranks over gloo time gloo, not the card
ZERO_STEPS = 3
DP_LR = 1e-3
DP_SEED = 17  # the global batch's images and the step generator
DP_STATS_RTOL = 1e-5  # BNNeck running statistics, data parallel against one process
DP_BF16_LOSS_RTOL = 1e-2
DP_TIES = 64  # gallery rows duplicated across the shard boundary in the tie case
RATE_NOTE = "two ranks sharing one card over gloo: not a scaling number"


def dp_plan(device: str = CARD) -> dict:
    """What every phase-14 job takes: its configs (built here), sizes and
    device, so a spawned rank needs nothing else of this script's state."""
    return dict(device=device, hw=HW, batch=BATCH, classes=NUM_CLASSES, ids=P_IDS,
                uni_classes=UNI_CLASSES, market=MARKET, cfg32=vit_base_cfg("float32", device),
                cfg16=vit_base_cfg("bfloat16", device), uni32=uniprompt_cfg("float32", device),
                moe32=tuned_cfg("float32", device))


def dp_batch(plan: dict, device) -> dict:
    """The global PK batch (``plan['ids']`` identities × K_INST seeded
    images), the same on every rank."""
    rng = np.random.default_rng(DP_SEED)
    n, (h, w) = plan["ids"] * K_INST, plan["hw"]
    bases = rng.integers(40, 215, (plan["ids"], h, w, 3), dtype=np.int16)
    pids = np.repeat(np.arange(plan["ids"]), K_INST)
    images = np.clip(bases[pids] + rng.integers(-60, 61, (n, h, w, 3)), 0, 255).astype(np.uint8)
    zeros = torch.zeros(n, dtype=torch.int32, device=device)
    return {"images": torch.from_numpy(images).to(device),
            "pids": torch.from_numpy(pids.astype(np.int32)).to(device),
            "camids": zeros, "trackids": zeros}


def dp_rank_setup(plan: dict) -> tuple:
    """A spawned rank's start: the plan's device (current, with TF32 off as
    ``header`` sets it) and the mesh over the group → (device, mesh)."""
    from mpreid_tpu_torch.parallel import make_mesh

    device = torch.device(plan["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())  # the one card
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device, make_mesh()


def dp_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dp_against_one_process(build, cfg, stage: str, plan: dict, mesh, with_text: bool) -> dict:
    """One fp32 data-parallel step of the model ``build()`` makes against
    the single-process step on the global batch, augmentation on (each rank
    its rows of the global draws): the loss, every gradient, the BatchNorm
    running statistics and the parameters after one Adam step. Both ranks
    run the data-parallel step; rank 0 then runs the single-process one and
    compares (rank 1 waits) → rank 0's checks."""
    from mpreid_tpu_torch.engine.steps import augment_args
    from mpreid_tpu_torch.ops.augment import train_augment
    from mpreid_tpu_torch.parallel import replicated, shard_batch

    device = torch.device(plan["device"])
    stage_cfg = cfg.SOLVER if stage == "baseline" else cfg.SOLVER.STAGE2
    classes = plan["classes"] if stage == "baseline" else plan["uni_classes"]
    model = build()
    replicated(model)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    text = precompute_text_features(cfg, model, classes) if with_text else None
    loss_fn, _ = make_loss(cfg, classes)
    batch = dp_batch(plan, device)

    def run(mesh_or_none):
        model.load_state_dict(w0)
        b = batch if mesh_or_none is None else shard_batch(batch, mesh_or_none)
        shard = None if mesh_or_none is None else (mesh_or_none.data, mesh_or_none.rank)
        gen = torch.Generator(device=device).manual_seed(DP_SEED)
        x = train_augment(b["images"], gen, **augment_args(cfg), shard=shard)
        opt = make_optimizer(stage_cfg, model, stage=stage)
        loss, _, grads, _ = loss_and_grads(model, cfg, loss_fn, opt, x, b["pids"].long(),
                                           text_features=text, gen=gen, mesh=mesh_or_none)
        stats = {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()
                 if "running" in k}
        grads = {k: g.float().cpu() for k, g in grads.items()}
        model.load_state_dict(w0)
        state = initial_state(model, opt)
        step = make_train_step(model, cfg, loss_fn, opt, uniprompt=with_text,
                               text_features=text, mesh=mesh_or_none)
        state, _ = step(state, b, DP_LR, torch.Generator(device=device).manual_seed(DP_SEED))
        train, _ = opt.partition(model)
        dp_sync(device)
        return float(loss), grads, stats, {k: p.detach().float().cpu() for k, p in train.items()}, opt

    got = run(mesh)
    res = {}
    if mesh.rank == 0:
        want = run(None)
        (l_g, g_g, s_g, p_g, opt), (l_w, g_w, s_w, p_w, _) = got, want
        weights = {k: v.float().cpu() for k, v in w0.items()}
        res = dict(loss=l_w, loss_rel=abs(l_g - l_w) / abs(l_w),
                   worst_grad_rel=worst_grad_rel(g_g, g_w), leaves=len(g_w),
                   bn_stats_worst_rel=max(((s_g[k] - v).abs() / v.abs().clamp(min=1e-6)).max().item()
                                          for k, v in s_w.items()),
                   bn_buffers=len(s_w),
                   **adam_step_errors(p_g, p_w, g_g, g_w, weights, opt, DP_LR))
    torch.distributed.barrier()
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def dp_steps(model, cfg, opt, plan: dict, mesh, n: int, w0: dict, timed: bool = False) -> dict:
    """``n`` steps through ``make_train_step`` from ``w0`` (data parallel
    under ``mesh``, else one process on the global batch), augmentation on →
    the last loss, the launch counts, the median step seconds, the final
    parameters and moments (gathered to the parameters' shapes) and this
    rank's optimizer-state bytes."""
    from mpreid_tpu_torch.engine.processor import checkpoint_state
    from mpreid_tpu_torch.parallel import shard_batch
    from mpreid_tpu_torch.parallel.zero import optimizer_state_bytes

    device = torch.device(plan["device"])
    model.load_state_dict(w0)
    loss_fn, _ = make_loss(cfg, plan["classes"])
    state = initial_state(model, opt)
    step = make_train_step(model, cfg, loss_fn, opt, mesh=mesh)
    batch = dp_batch(plan, device)
    local = batch if mesh is None else shard_batch(batch, mesh)
    gen = torch.Generator(device=device).manual_seed(DP_SEED)
    reset_counts()
    seconds = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, metrics = step(state, local, DP_LR, gen)
        dp_sync(device)
        seconds.append(time.perf_counter() - t0)
    counts, routes = read_counts(), read_routes()
    full = checkpoint_state(state, opt).opt_state
    return dict(loss=float(metrics["loss"]), launches=counts, launches_by_route=routes,
                step_s=float(np.median(seconds)), opt_bytes=optimizer_state_bytes(state.opt_state),
                params={k: p.detach().clone() for k, p in model.named_parameters()},
                mu=dict(full.mu), nu=dict(full.nu))


def dp_train_job(plan: dict) -> dict:
    """Phase 14b and 14c on one rank: the baseline step in fp32 against one
    process; in bf16 its loss, launches and rate, plain and fused Adam; then
    ZeRO-1 against replicated data parallelism, bitwise, for fp32 and bf16
    moments with the fused Adam off and on."""
    from mpreid_tpu_torch.parallel import replicated, zero_sharded

    device, mesh = dp_rank_setup(plan)
    out = {"rank": mesh.rank}
    cfg32, cfg16 = plan["cfg32"], plan["cfg16"]
    out["fp32"] = dp_against_one_process(
        lambda: make_model(cfg32, plan["classes"], 6, 1, device=device), cfg32, "baseline",
        plan, mesh, with_text=False)

    model = make_model(cfg16, plan["classes"], 6, 1, device=device)
    replicated(model)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out["depth"] = len(model.image_encoder.transformer.resblocks)

    def opt_for(fused=False, moment_dtype="float32", zero=False):
        c = cfg16.clone()
        c.SOLVER.FUSED_ADAM, c.SOLVER.MOMENT_DTYPE = fused, moment_dtype
        opt = make_optimizer(c.SOLVER, model, stage="baseline")
        return (zero_sharded(opt, mesh, model) if zero else opt), c

    opt, c = opt_for()
    dp = dp_steps(model, c, opt, plan, mesh, 1 + DP_TIMED_STEPS, w0)
    out["bf16"] = {k: dp[k] for k in ("loss", "launches", "launches_by_route", "step_s")}
    if mesh.rank == 0:  # the same steps in one process: the loss after them, and the rate
        one = dp_steps(model, c, opt_for()[0], plan, None, 1 + DP_TIMED_STEPS, w0)
        out["bf16"].update(one_process_loss=one["loss"], one_process_step_s=one["step_s"])
    torch.distributed.barrier()
    opt, c = opt_for(fused=True)
    fused = dp_steps(model, c, opt, plan, mesh, 1, w0)
    out["fused"] = {k: fused[k] for k in ("loss", "launches", "launches_by_route")}

    zero = {}
    for md in ("float32", "bfloat16"):
        for fused in (False, True):
            rep, zer = (dp_steps(model, c, o, plan, mesh, ZERO_STEPS, w0)
                        for o, c in (opt_for(fused, md, z) for z in (False, True)))
            zero[f"{md}_fused_{fused}"] = dict(
                params_equal=all(torch.equal(zer["params"][k], v) for k, v in rep["params"].items()),
                moments_equal=all(torch.equal(zer[m][k], v) for m in ("mu", "nu")
                                  for k, v in rep[m].items()),
                replicated_opt_bytes=rep["opt_bytes"], zero_opt_bytes=zer["opt_bytes"],
                launches=zer["launches"], launches_by_route=zer["launches_by_route"],
                loss=zer["loss"])
    out["zero"] = zero
    return out


def dp_uniprompt_job(plan: dict) -> dict:
    """Phase 14d on one rank: one fp32 data-parallel step of Uni-Prompt
    stage 2a (the i2t term) and of MoE stage 2b (distinct random experts and
    gates, the aux loss), each against the single-process step."""
    device, mesh = dp_rank_setup(plan)
    out = {}
    for name, cfg, stage in (("stage2a", plan["uni32"], "stage2a"),
                             ("moe_stage2b", plan["moe32"], "stage2b")):
        out[name] = dp_against_one_process(
            lambda c=cfg: make_model_uniprompt(c, plan["uni_classes"], 14, UNI_VIEWS,
                                               device=device),
            cfg, stage, plan, mesh, with_text=True)
    return out


def dp_eval_job(plan: dict) -> dict:
    """Phase 14e on one rank: gallery-sharded CMC / mAP at Market-1501's
    scale (seeded clustered features) through the evaluator's sharded path,
    each rank one block of the gallery, against the dense evaluator on rank
    0 (both timed after a warm-up call); then the same with DP_TIES gallery
    rows copied across the shard boundary (half of them under another
    identity: exact ties)."""
    from mpreid_tpu_torch.engine.processor import sharded_gallery_metrics

    device, mesh = dp_rank_setup(plan)
    m = plan["market"]
    feats, pids, camids = clustered_feats(m["q"], m["g"], m["ids"])
    out = {}
    for case in ("clustered", "ties"):
        if case == "ties":
            half = -(-m["g"] // mesh.data)
            rows = np.random.default_rng(3).choice(half, DP_TIES, replace=False)
            src, dst = m["q"] + rows, m["q"] + half + rows
            dst = dst[dst < len(pids)]
            src = src[:len(dst)]
            feats[dst], pids[dst] = feats[src], pids[src]
            pids[dst[::2]] = pids[src[::2]] + 1  # another identity at the same distance
        ev = R1mAPEvaluator(m["q"], max_rank=50, feat_norm=True, device=device)
        ev.update((torch.from_numpy(feats).to(device), pids, camids))
        if case == "clustered":  # warm-up: the first call of each kernel
            sharded_gallery_metrics(ev)
            if mesh.rank == 0:
                ev.compute()
        dp_sync(device)
        t0 = time.perf_counter()
        cmc, mAP = sharded_gallery_metrics(ev)
        dp_sync(device)
        res = dict(sharded_s=time.perf_counter() - t0, rank1=float(cmc[0]), mAP=mAP)
        if mesh.rank == 0:
            t0 = time.perf_counter()
            dcmc, dmap, *_ = ev.compute()
            dp_sync(device)
            res.update(dense_s=time.perf_counter() - t0, cmc_equal=bool(np.array_equal(cmc, dcmc)),
                       map_abs_diff=abs(mAP - dmap), dense_mAP=dmap)
        out[case] = res
        torch.distributed.barrier()
    return out


def rank_jobs(plan: dict, jobs: tuple) -> dict:
    """Each ``(key, job)`` of ``jobs`` on this rank in turn, in one spawned
    group (the ranks start once for all of them) → ``{key: job(plan)}``
    and each job's seconds under ``"seconds"``."""
    out, seconds = {}, {}
    for key, job in jobs:
        t0 = time.perf_counter()
        out[key] = job(plan)
        torch.distributed.barrier()
        seconds[key] = time.perf_counter() - t0
        if torch.device(plan["device"]).type == "cuda":
            torch.cuda.empty_cache()
    out["seconds"] = seconds
    return out


def dp_jobs(plan: dict) -> dict:
    """Phase 14b–e on one rank: ``dp_train_job``, ``dp_uniprompt_job`` and
    ``dp_eval_job`` in one group."""
    return rank_jobs(plan, (("14b", dp_train_job), ("14d", dp_uniprompt_job),
                            ("14e", dp_eval_job)))


def nccl_world_one(plan_path: str) -> None:
    """Phase 14a, in a process started with torchrun's variables for a world
    of 1: ``init_distributed`` makes the NCCL group (gloo on the CPU), one
    all-reduce of a device tensor, one ``do_train`` step at full width with
    the group, then the same step without it; prints one JSON line."""
    import torch.distributed as dist

    from mpreid_tpu_torch.parallel import init_distributed, world_size

    plan = torch.load(plan_path, weights_only=False)
    device = torch.device(plan["device"])
    rank = init_distributed(device=device)
    t = torch.full((4,), 3.0, device=device)
    dist.all_reduce(t)
    res = dict(rank=rank, world=world_size(), backend=dist.get_backend(),
               all_reduce_ok=bool((t == 3.0).all()))

    def one_step():
        cfg = plan["cfg16"]
        batch = dp_batch(plan, "cpu")
        images, pids = batch["images"].numpy(), batch["pids"].numpy()
        sampler = RandomIdentitySampler(list(zip(range(len(pids)), pids)), plan["batch"],
                                        K_INST, seed=int(cfg.SOLVER.SEED))
        loader = TrainLoader(MemoryBatcher(images, pids, plan["batch"]), sampler)
        model = make_model(cfg, plan["classes"], 6, 1, device=device)
        loss_fn, _ = make_loss(cfg, plan["classes"])
        opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
        reset_counts()
        _, history = do_train(cfg, model, loader, None, opt, lambda e: DP_LR, loss_fn, QUERY,
                              max_epochs=1)
        dp_sync(device)
        run = dict(steps=len(sampler.epoch_indices(1)) // plan["batch"], launches=read_counts(),
                   launches_by_route=read_routes(), history=history)
        return run, {k: p.detach().cpu() for k, p in model.named_parameters()}

    run, p_group = one_step()
    dist.destroy_process_group()
    alone, p_alone = one_step()
    res.update(run, history_equal=run["history"] == alone["history"],
               params_equal=all(torch.equal(v, p_alone[k]) for k, v in p_group.items()))
    print("NCCL_WORLD_ONE " + json.dumps(res), flush=True)


def run_data_parallel(plan: dict) -> dict:
    """Phase 14: 14a in a subprocess with torchrun's variables, then 14b–e
    in one spawned two-rank gloo job sharing the card (``dp_jobs``); every
    check raises on failure."""
    from mpreid_tpu_torch.parallel.launch import free_port, spawn

    res = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plan.pth")
        torch.save(plan, path)
        env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        code = f"import chip_smoke; chip_smoke.nccl_world_one({path!r})"
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                              text=True, timeout=DP_TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("NCCL_WORLD_ONE ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"14a failed (exit {proc.returncode}):\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    a = json.loads(lines[-1].split(" ", 1)[1])
    a["seconds"] = time.perf_counter() - t0
    log(f"  14a world 1 through init_distributed {json.dumps(a)}")
    want_backend = "nccl" if plan["device"] != "cpu" else "gloo"
    if not (a["backend"] == want_backend and a["world"] == 1 and a["all_reduce_ok"]
            and a["history_equal"] and a["params_equal"] and a["steps"] == 1):
        raise AssertionError(f"14a: the world-1 group changed the step: {a}")
    res["14a"] = a

    t0 = time.perf_counter()
    jobs = spawn(dp_jobs, DP_RANKS, (plan,), timeout=DP_TIMEOUT)
    log(f"  14b-e one two-rank job of {time.perf_counter() - t0:.1f} s, rank 0's jobs "
        f"{json.dumps(jobs[0]['seconds'])}")
    ranks = [job["14b"] for job in jobs]
    b = ranks[0]
    b_res = dict(fp32=b["fp32"], bf16=b["bf16"], fused=b["fused"],
                 seconds=jobs[0]["seconds"]["14b"])
    log(f"  14b data parallel, 2 ranks on one card over gloo {json.dumps(b_res)}")
    f32 = b["fp32"]
    if not (f32["loss_rel"] <= LOSS_RTOL and f32["worst_grad_rel"] <= GRAD_RTOL
            and f32["bn_stats_worst_rel"] <= DP_STATS_RTOL and f32["params_ok"]):
        raise AssertionError(f"14b: the fp32 data-parallel step differs from one process's: {f32}")
    bf = b["bf16"]
    if not abs(bf["loss"] - bf["one_process_loss"]) <= DP_BF16_LOSS_RTOL * abs(bf["one_process_loss"]):
        raise AssertionError(f"14b: the bf16 data-parallel loss differs from one process's: {bf}")
    depth, n = b["depth"], 1 + DP_TIMED_STEPS
    for r, out in enumerate(ranks):
        expect_dp_counts(f"14b rank {r} plain Adam", out["bf16"], {
            "attention_fwd": depth * n, "attention_bwd": depth * n, "adam_table": n})
        expect_dp_counts(f"14b rank {r} fused Adam", out["fused"], {
            "attention_fwd": depth, "attention_bwd": depth, "adam": ADAM_LEAVES,
            "adam_table": 1})
    rates = dict(two_ranks_img_per_s=plan["batch"] / bf["step_s"],
                 one_process_img_per_s=plan["batch"] / bf["one_process_step_s"], note=RATE_NOTE)
    rate_line("data-parallel train img/s (configs/person/vit_base.yml, global batch 64, "
              f"median of {DP_TIMED_STEPS + 1} steps; {RATE_NOTE})", rates)
    res["14b"] = dict(b_res, rates=rates)

    z = b["zero"]
    log(f"  14c ZeRO-1 against replicated data parallelism {json.dumps(z)}")
    for r, out in enumerate(ranks):
        for name, c in out["zero"].items():
            if not (c["params_equal"] and c["moments_equal"]):
                raise AssertionError(f"14c rank {r} {name}: ZeRO differs from replicated: {c}")
            if not c["zero_opt_bytes"] < 0.75 * c["replicated_opt_bytes"]:
                raise AssertionError(f"14c rank {r} {name}: no saving in optimizer state: {c}")
            fused = name.endswith("True")
            expect_dp_counts(f"14c rank {r} {name}", c, {
                "attention_fwd": depth * ZERO_STEPS, "attention_bwd": depth * ZERO_STEPS,
                "adam": ADAM_LEAVES * ZERO_STEPS if fused else 0, "adam_table": ZERO_STEPS})
    res["14c"] = {name: {k: c[k] for k in ("replicated_opt_bytes", "zero_opt_bytes")}
                  for name, c in z.items()}
    res["14c"]["launches"] = {r: out["zero"]["bfloat16_fused_True"]["launches"]
                              for r, out in enumerate(ranks)}

    d = jobs[0]["14d"]
    log(f"  14d Uni-Prompt stage 2a and MoE stage 2b, fp32 {json.dumps(d)} "
        f"({jobs[0]['seconds']['14d']:.1f} s)")
    for name, c in d.items():
        if not (c["loss_rel"] <= LOSS_RTOL and c["worst_grad_rel"] <= GRAD_RTOL
                and c["bn_stats_worst_rel"] <= DP_STATS_RTOL and c["params_ok"]):
            raise AssertionError(f"14d {name}: the data-parallel step differs from one "
                                 f"process's: {c}")
    res["14d"] = d

    e = jobs[0]["14e"]
    log(f"  14e gallery-sharded eval at Market-1501's scale {json.dumps(e)} "
        f"({jobs[0]['seconds']['14e']:.1f} s)")
    for name, c in e.items():
        if not (c["cmc_equal"] and c["map_abs_diff"] <= 1e-6):
            raise AssertionError(f"14e {name}: sharded metrics differ from the dense ones: {c}")
    res["14e"] = e
    return res


# ---------------------------------------------------------------------------
# phase 15: the model axis (tensor and expert parallelism), GPipe, the
# gallery-sharded sparse re-ranking and the multi-rank dry run
# ---------------------------------------------------------------------------

TP_RANKS = 2  # a 1 × 2 mesh: the model axis over two ranks sharing the card (gloo)
TP_TIMED_STEPS = 2  # after a warm-up step, as DP_TIMED_STEPS
# fp32 model-axis step against one process on the same card (15a, 15b): only
# the order of the sums across ranks differs (measured: loss ~2e-7 relative,
# gradients <= 7.1e-6 norm-relative), well below the card-vs-CPU limits
TP_LOSS_RTOL = 1e-6
TP_GRAD_RTOL = 5e-5
VISION_TP = dict(name="vision_tp", b=BATCH, l=129, heads=6, dh=64, masked=False)
TEXT_TP = dict(name="text_tp", b=BATCH, l=77, heads=4, dh=64, masked=True)
DRYRUN_RANKS = 4  # dryrun_multichip's (world/2) × 2 mesh
PP_STAGES, PP_MICRO, PP_LAYERS = 2, 4, 12  # the text tower (12 × 512, L 77, causal, B 64)
PP_TOL = 1e-5  # fp32 GPipe against the blocks in sequence, norm-relative: the card's
#                GEMMs over a microbatch of 16 rows may sum in another order than over 64
SPARSE_SHARD_TOL = 1e-5  # max abs, re_ranking_sparse_sharded against re_ranking_sparse


def tp_rank_setup(plan: dict) -> tuple:
    """A spawned rank of phase 15: the card as ``dp_rank_setup`` sets it,
    and the 1 × TP_RANKS mesh → (device, mesh)."""
    from mpreid_tpu_torch.parallel import make_mesh

    device, _ = dp_rank_setup(plan)
    return device, make_mesh(data=1, model=TP_RANKS)


def tp_run(model, cfg, stage_cfg, stage: str, plan: dict, mesh, w0: dict, text,
           loss_fn) -> tuple:
    """From the whole weights ``w0``: the loss and the whole gradients of
    one forward (augmentation on), then one Adam step through
    ``make_train_step`` → (loss, gradients, parameters after the step,
    launches and routes of the step, optimizer). ``mesh`` None: one process
    on an unsliced model."""
    from mpreid_tpu_torch.engine.steps import augment_args
    from mpreid_tpu_torch.ops.augment import train_augment
    from mpreid_tpu_torch.parallel import gather_whole, load_full_state_dict

    device = torch.device(plan["device"])
    batch = dp_batch(plan, device)
    load_full_state_dict(model, w0)
    gen = torch.Generator(device=device).manual_seed(DP_SEED)
    x = train_augment(batch["images"], gen, **augment_args(cfg))
    opt = make_optimizer(stage_cfg, model, stage=stage)
    loss, _, grads, _ = loss_and_grads(model, cfg, loss_fn, opt, x, batch["pids"].long(),
                                       text_features=text, gen=gen, mesh=mesh)
    grads = {k: g.float().cpu() for k, g in gather_whole(grads, model).items()}
    load_full_state_dict(model, w0)
    state = initial_state(model, opt)
    step = make_train_step(model, cfg, loss_fn, opt, uniprompt=text is not None,
                           text_features=text, mesh=mesh)
    reset_counts()
    state, _ = step(state, batch, DP_LR, torch.Generator(device=device).manual_seed(DP_SEED))
    dp_sync(device)
    counts, routes = read_counts(), read_routes()
    train, _ = opt.partition(model)
    params = {k: p.detach().float().cpu() for k, p in gather_whole(
        {k: p.detach() for k, p in train.items()}, model).items()}
    return float(loss), grads, params, dict(launches=counts, launches_by_route=routes), opt


def tp_against_one_process(build, cfg, stage: str, plan: dict, mesh, with_text: bool,
                           classes: int, fused: bool = False) -> dict:
    """One fp32 step of the model ``build()`` makes, sliced over the model
    axis (tensor-parallel towers, the classifiers by class, the experts and
    ``ctx_generic`` where it has them), against one process on an unsliced
    copy: the loss, every gathered gradient and the parameters after one
    Adam step (plain, or with ``SOLVER.FUSED_ADAM``). Both ranks run the
    sliced step; rank 0 then the unsliced one (rank 1 waits) → this rank's
    launches, and on rank 0 the checks."""
    from mpreid_tpu_torch.parallel import replicated, shard_module

    device = torch.device(plan["device"])
    cfg = cfg.clone()
    cfg.SOLVER.FUSED_ADAM = cfg.SOLVER.STAGE2.FUSED_ADAM = fused
    stage_cfg = cfg.SOLVER if stage == "baseline" else cfg.SOLVER.STAGE2
    model = build()
    replicated(model)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    weights = {k: p.detach().float().cpu().clone() for k, p in model.named_parameters()}
    text = precompute_text_features(cfg, model, classes) if with_text else None
    loss_fn, _ = make_loss(cfg, classes)
    shard_module(model, mesh, tp_towers=True)
    local_heads = sorted({m.num_heads // m.tp.size for m in model.modules()
                          if isinstance(m, MultiHeadAttention)})
    l_g, g_g, p_g, runs, opt = tp_run(model, cfg, stage_cfg, stage, plan, mesh, w0, text,
                                      loss_fn)
    res = dict(runs, local_heads=local_heads)
    if mesh.model_rank == 0:
        del model
        ref = build()
        l_w, g_w, p_w, _, _ = tp_run(ref, cfg, stage_cfg, stage, plan, None, w0, text, loss_fn)
        res.update(loss=l_w, loss_rel=abs(l_g - l_w) / abs(l_w),
                   worst_grad_rel=worst_grad_rel(g_g, g_w), leaves=len(g_w),
                   **adam_step_errors(p_g, p_w, g_g, g_w, weights, opt, DP_LR))
        del ref
    torch.distributed.barrier()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def tp_timed(model, cfg, plan: dict, mesh, n: int, w0: dict) -> dict:
    """``n`` bf16 baseline steps from ``w0`` through ``make_train_step``
    (``mesh`` None: one process) → the last loss, launches, median step s."""
    from mpreid_tpu_torch.parallel import load_full_state_dict

    device = torch.device(plan["device"])
    load_full_state_dict(model, w0)
    loss_fn, _ = make_loss(cfg, plan["classes"])
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    state = initial_state(model, opt)
    step = make_train_step(model, cfg, loss_fn, opt, mesh=mesh)
    batch = dp_batch(plan, device)
    gen = torch.Generator(device=device).manual_seed(DP_SEED)
    reset_counts()
    seconds = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, DP_LR, gen)
        dp_sync(device)
        seconds.append(time.perf_counter() - t0)
    return dict(loss=float(metrics["loss"]), launches=read_counts(),
                launches_by_route=read_routes(), step_s=float(np.median(seconds)))


def tp_train_job(plan: dict) -> dict:
    """Phase 15a on one rank: configs/person/vit_base.yml at full width and
    depth (751 classes: 376 + 375 rows a rank) on the 1 × 2 mesh with
    tensor-parallel towers: the fp32 step against one process, plain and
    fused Adam; then bf16 steps, their loss, launches and step time beside
    one process's; then 15b: the MoE stage-2b step (4 experts, top-2, 2 MoE
    layers) under expert parallelism and TP towers, fp32, against one process."""
    from mpreid_tpu_torch.parallel import replicated, shard_module

    device, mesh = tp_rank_setup(plan)
    out = {"rank": mesh.model_rank}
    cfg32, cfg16 = plan["cfg32"], plan["cfg16"]

    def vit(cfg):
        return lambda: make_model(cfg, plan["classes"], 6, 1, device=device)

    for fused in (False, True):
        out[f"fp32_fused_{fused}"] = tp_against_one_process(
            vit(cfg32), cfg32, "baseline", plan, mesh, False, plan["classes"], fused)

    model = vit(cfg16)()
    replicated(model)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out["depth"] = len(model.image_encoder.transformer.resblocks)
    shard_module(model, mesh, tp_towers=True)
    out["bf16"] = tp_timed(model, cfg16, plan, mesh, 1 + TP_TIMED_STEPS, w0)
    del model
    if mesh.model_rank == 0:
        one = tp_timed(vit(cfg16)(), cfg16, plan, None, 1 + TP_TIMED_STEPS, w0)
        out["bf16"].update(one_process_loss=one["loss"], one_process_step_s=one["step_s"])
    torch.distributed.barrier()
    torch.cuda.empty_cache() if device.type == "cuda" else None

    moe = plan["moe32"]
    out["moe_stage2b"] = tp_against_one_process(
        lambda: make_model_uniprompt(moe, plan["uni_classes"], 14, UNI_VIEWS, device=device),
        moe, "stage2b", plan, mesh, True, plan["uni_classes"])
    return out


def pp_job(plan: dict) -> dict:
    """Phase 15d on one rank: a PP_STAGES-stage GPipe over a full-width text
    tower's blocks (seeded, fp32, causal, B 64, L 77, PP_MICRO
    microbatches), forward and gradients against the blocks applied in
    sequence in one process, and both times."""
    from mpreid_tpu_torch.models.layers import ResidualAttentionBlock
    from mpreid_tpu_torch.models.text import causal_mask
    from mpreid_tpu_torch.parallel import collectives as C
    from mpreid_tpu_torch.parallel.pipeline import pipe_mesh, pipelined_blocks

    device, _ = dp_rank_setup(plan)
    width, heads, length = VIT_B16.transformer_width, VIT_B16.transformer_heads, 77
    gen = torch.Generator().manual_seed(5)
    blocks = torch.nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(PP_LAYERS))
    for blk in blocks:
        blk.init_(gen)
    blocks = blocks.to(device)
    x = torch.randn(plan["batch"], length, width, generator=gen).to(device)
    w = torch.randn(plan["batch"], length, width, generator=gen).to(device)
    mask = causal_mask(length, device)
    params = {f"resblocks.{i}.{k}": p for i, b in enumerate(blocks)
              for k, p in b.named_parameters()}
    pipe = pipe_mesh(PP_STAGES)

    def pipelined():
        xi = x.clone().requires_grad_(True)
        y = pipelined_blocks(blocks[0], params, PP_LAYERS, xi, pipe, microbatches=PP_MICRO,
                             mask=mask)
        (y * w).sum().backward()
        return y.detach(), xi.grad

    def sequential():
        xi = x.clone().requires_grad_(True)
        h = xi
        for blk in blocks:
            h = blk(h, mask)
        (h * w).sum().backward()
        return h.detach(), xi.grad

    pipelined()  # warm-up
    blocks.zero_grad(set_to_none=True)
    reset_counts()
    dp_sync(device)
    t0 = time.perf_counter()
    y, dx = pipelined()
    dp_sync(device)
    pp_s = time.perf_counter() - t0
    counts, routes = read_counts(), read_routes()
    # the stage's gradients; the other stage's blocks have none here
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
             for k, p in params.items()}
    for g in grads.values():
        C.all_reduce_sum(g)
    res = dict(stage=pipe.stage, launches=counts, launches_by_route=routes, pipelined_s=pp_s)
    blocks.zero_grad(set_to_none=True)
    sequential()  # warm-up
    blocks.zero_grad(set_to_none=True)
    dp_sync(device)
    t0 = time.perf_counter()
    y_s, dx_s = sequential()
    dp_sync(device)
    res.update(sequential_s=time.perf_counter() - t0, y_rel=_rel_err(y, y_s),
               dx_rel=_rel_err(dx, dx_s),
               worst_grad_rel=worst_grad_rel({k: g for k, g in grads.items()},
                                             {k: p.grad for k, p in params.items()}))
    return res


def sparse_sharded_job(plan: dict) -> dict:
    """Phase 15e on one rank: ``re_ranking_sparse_sharded`` over the two
    ranks' gallery halves at Market-1501's scale (seeded clustered features)
    → its time and this rank's min-sum launches; rank 0 also runs
    ``re_ranking_sparse`` on the whole gallery and compares."""
    from mpreid_tpu_torch.ops.reranking_sparse import re_ranking_sparse, re_ranking_sparse_sharded
    from mpreid_tpu_torch.parallel import make_mesh

    device, mesh = dp_rank_setup(plan)
    mesh = make_mesh(data=TP_RANKS)
    m = plan["market"]
    feats = torch.from_numpy(clustered_feats(m["q"], m["g"], m["ids"])[0]).to(device)
    qf, gf = feats[:m["q"]], feats[m["q"]:]
    re_ranking_sparse_sharded(qf[:256], gf[:1024], mesh)  # warm-up
    reset_counts()
    dp_sync(device)
    t0 = time.perf_counter()
    d_sh = re_ranking_sparse_sharded(qf, gf, mesh)
    dp_sync(device)
    res = dict(rank=mesh.rank, sharded_s=time.perf_counter() - t0, launches=read_counts(),
               shape=list(d_sh.shape))
    if mesh.rank == 0:
        t0 = time.perf_counter()
        d_one = re_ranking_sparse(qf, gf)
        dp_sync(device)
        res.update(one_rank_s=time.perf_counter() - t0,
                   max_abs_diff=(d_sh - d_one).abs().max().item())
    del d_sh
    torch.distributed.barrier()
    return res


def tp_jobs(plan: dict) -> dict:
    """Phase 15a–b, d and e on one rank: ``tp_train_job``, ``pp_job`` and
    ``sparse_sharded_job`` in one group (PP_STAGES = TP_RANKS ranks)."""
    return rank_jobs(plan, (("15a", tp_train_job), ("15d", pp_job),
                            ("15e", sparse_sharded_job)))


def run_model_axis(plan: dict) -> dict:
    """Phase 15: (a, b) the model axis at full width, (d) GPipe over the
    text tower and (e) the gallery-sharded sparse re-ranking in one spawned
    two-rank gloo job sharing the card (``tp_jobs``), (c) the dry run over
    four ranks; every check raises on failure."""
    from mpreid_tpu_torch.parallel.dryrun import dryrun_multichip
    from mpreid_tpu_torch.parallel.launch import spawn

    res = {}
    t0 = time.perf_counter()
    jobs = spawn(tp_jobs, TP_RANKS, (plan,), timeout=DP_TIMEOUT)
    log(f"  15a-b, d, e one two-rank job of {time.perf_counter() - t0:.1f} s, rank 0's jobs "
        f"{json.dumps(jobs[0]['seconds'])}")
    ranks = [job["15a"] for job in jobs]
    a = ranks[0]
    res["15a"] = {k: a[k] for k in ("fp32_fused_False", "fp32_fused_True", "bf16")}
    res["15a"]["seconds"] = jobs[0]["seconds"]["15a"]
    log(f"  15a configs/person/vit_base.yml on a 1x2 mesh, TP towers {json.dumps(res['15a'])}")
    for fused in (False, True):
        c = a[f"fp32_fused_{fused}"]
        if not (c["loss_rel"] <= TP_LOSS_RTOL and c["worst_grad_rel"] <= TP_GRAD_RTOL
                and c["params_ok"]):
            raise AssertionError(f"15a fused {fused}: the model-axis step differs from one "
                                 f"process's: {c}")
    bf = a["bf16"]
    if not abs(bf["loss"] - bf["one_process_loss"]) <= DP_BF16_LOSS_RTOL * abs(bf["one_process_loss"]):
        raise AssertionError(f"15a: the bf16 model-axis loss differs from one process's: {bf}")
    depth, n = a["depth"], 1 + TP_TIMED_STEPS
    for r, out in enumerate(ranks):
        if out["fp32_fused_False"]["local_heads"] != [VISION_TP["heads"]]:
            raise AssertionError(f"15a rank {r}: local heads {out['fp32_fused_False']['local_heads']}")
        expect_dp_counts(f"15a rank {r} bf16 steps", out["bf16"], {
            "attention_fwd": depth * n, "attention_bwd": depth * n, "adam_table": n})
        fused = out["fp32_fused_True"]
        if plan["device"] != "cpu" and (fused["launches"]["adam"] != ADAM_LEAVES
                                        or fused["launches"]["adam_table"] != 1):
            raise AssertionError(f"15a rank {r}: fused Adam launches {fused['launches']}, "
                                 f"expected {ADAM_LEAVES} and one of the table")
    rates = dict(two_ranks_img_per_s=plan["batch"] / bf["step_s"],
                 one_process_img_per_s=plan["batch"] / bf["one_process_step_s"], note=RATE_NOTE)
    rate_line("model-axis (TP towers, 1x2 mesh) train img/s (configs/person/vit_base.yml, "
              f"batch 64, median of {TP_TIMED_STEPS + 1} steps; {RATE_NOTE})", rates)
    res["15a"].update(rates=rates, launches={r: out["bf16"]["launches"]
                                              for r, out in enumerate(ranks)},
                      adam_launches={r: out["fp32_fused_True"]["launches"]["adam"]
                                     for r, out in enumerate(ranks)})
    b = a["moe_stage2b"]
    log(f"  15b MoE stage 2b, EP + TP towers, fp32 {json.dumps(b)}")
    if not (b["loss_rel"] <= TP_LOSS_RTOL and b["worst_grad_rel"] <= TP_GRAD_RTOL
            and b["params_ok"]):
        raise AssertionError(f"15b: the EP + TP step differs from one process's: {b}")
    res["15b"] = b

    t0 = time.perf_counter()
    dry = dryrun_multichip(DRYRUN_RANKS, device=plan["device"], timeout=DP_TIMEOUT)
    c = dict(seconds=time.perf_counter() - t0, lines=dry[0]["lines"],
             launches={r["rank"] * 2 + r["model_rank"]: r["launches"] for r in dry})
    log(f"  15c dryrun_multichip({DRYRUN_RANKS}) {json.dumps(c)}")
    for r, out in c["launches"].items():
        if plan["device"] != "cpu" and not (out["l1_cross"] > 0 and out["minsum_cross"] > 0):
            raise AssertionError(f"15c rank {r}: no re-ranking kernel launch: {out}")
    res["15c"] = c

    pp = [job["15d"] for job in jobs]
    d = dict(seconds=jobs[0]["seconds"]["15d"], ranks=pp)
    log(f"  15d GPipe, {PP_STAGES} stages over the text tower {json.dumps(d)}")
    for out in pp:
        if not (out["y_rel"] <= PP_TOL and out["dx_rel"] <= PP_TOL
                and out["worst_grad_rel"] <= PP_TOL):
            raise AssertionError(f"15d stage {out['stage']}: GPipe differs from sequential: {out}")
        per = PP_LAYERS // PP_STAGES * PP_MICRO
        if plan["device"] != "cpu" and not (out["launches"]["attention_fwd"] == per
                                            and out["launches"]["attention_bwd"] == per):
            raise AssertionError(f"15d stage {out['stage']}: attention launches {out['launches']}, "
                                 f"expected {per} each way")
    res["15d"] = d

    e = [job["15e"] for job in jobs]
    res["15e"] = dict(seconds=jobs[0]["seconds"]["15e"], ranks=e)
    log(f"  15e re_ranking_sparse_sharded at Market-1501's scale {json.dumps(res['15e'])}")
    if not e[0]["max_abs_diff"] <= SPARSE_SHARD_TOL:
        raise AssertionError(f"15e: the sharded sparse re-ranking differs: {e[0]}")
    for out in e:
        if plan["device"] != "cpu" and not out["launches"]["minsum_cross"] > 0:
            raise AssertionError(f"15e rank {out['rank']}: no min-sum launch: {out}")
    return res


# ---------------------------------------------------------------------------
# phase 16: TPU.REMAT (rematerialised vision blocks) and TPU.ASYNC_CHECKPOINT
# ---------------------------------------------------------------------------

REMAT_STEPS = 8  # timed steps of each mode at L 129 (L 257: VEHICLE_STEPS)
REMAT_SEED = 23  # the step generator of both modes
REMAT_TURNS = 4  # steps a turn when the two modes are timed in turns (off, on, on, off)
REMAT_MOE_DROPOUT = 0.1


def remat_cfg(cfg, on: bool):
    """``cfg`` with ``TPU.REMAT`` set to ``on``."""
    cfg = cfg.clone()
    cfg.TPU.REMAT = on
    return cfg


def host_copy(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def first_difference(got: dict, want: dict) -> str:
    """'' when every tensor of ``got`` equals ``want``'s bit for bit, else the
    largest difference and where it is."""
    if set(got) != set(want):
        return f"other keys: {sorted(set(got) ^ set(want))[:5]}"
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if not differ:
        return ""
    worst, key = max(((got[k].float() - want[k].float()).abs().max().item(), k) for k in differ)
    return f"{len(differ)} differ, max |difference| {worst:.3e} in {key}"


def remat_grads(model, cfg, loss_fn, optimizer, batch, depth: int, on: bool, what: str,
                text=None) -> dict:
    """One forward and its gradients from the seeded step generator
    (augmentation on, the MoE experts' dropout where the model has it), the
    attention launches of exactly that, and the generator's state after."""
    from mpreid_tpu_torch.engine.steps import augment_args
    from mpreid_tpu_torch.ops.augment import train_augment

    gen = torch.Generator(device=CARD).manual_seed(REMAT_SEED)
    x = train_augment(batch["images"], gen, **augment_args(cfg))
    torch.cuda.synchronize()
    reset_counts()
    loss, _, grads, _ = loss_and_grads(model, cfg, loss_fn, optimizer, x, batch["pids"].long(),
                                       text_features=text, gen=gen)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts(f"16 {what} remat {'on' if on else 'off'}: one forward and backward", counts,
                  {"attention_fwd": 2 * depth if on else depth, "attention_bwd": depth})
    return dict(loss=loss.detach().cpu(), grads=host_copy(grads), gen=gen.get_state(),
                launches=counts, launches_by_route=read_routes())


def remat_steps(model, cfg, loss_fn, optimizer, batches, depth: int, on: bool,
                what: str, profile: bool = False) -> dict:
    """A warm-up step, then ``len(batches) - 1`` timed steps through
    ``make_train_step`` from the seeded generator: their times, the peak of
    allocated device memory over them and what they leave, with ``profile``
    then the device's busy time and idle share over three traced steps →
    (that, the step, its state)."""
    state = initial_state(model, optimizer)
    step = make_train_step(model, cfg, loss_fn, optimizer)
    gen = torch.Generator(device=CARD).manual_seed(REMAT_SEED)
    state, _ = step(state, batches[0], 1e-4, gen)  # warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, losses = [], []
    for batch in batches[1:]:
        (state, metrics), secs = timed(lambda: step(state, batch, 1e-4, gen))
        seconds.append(secs)
        losses.append(float(metrics["loss"]))
    n = len(batches) - 1
    counts = read_counts()
    expect_counts(f"16 {what} remat {'on' if on else 'off'}: {n} train steps", counts,
                  {"attention_fwd": (2 if on else 1) * depth * n, "attention_bwd": depth * n,
                   "adam_table": n})
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"16 {what}: non-finite losses {losses}")
    res = dict(step_seconds=seconds, losses=losses, peak_mem_gb=peak / 1e9,
               held_gb=held / 1e9, peak_above_held_gb=(peak - held) / 1e9, launches=counts,
               launches_by_route=read_routes(),
               params=host_copy(dict(model.named_parameters())), gen=gen.get_state())
    if profile:
        def three_steps():
            for batch in batches[1:4]:
                step(state, batch, 1e-4, gen)

        res["profile"] = profile_idle(three_steps, f"3 steps of {what}, remat "
                                                   f"{'on' if on else 'off'}")
    return res, step, state


def remat_turns(model, make_step, state, batches) -> dict:
    """The two modes timed in turns on one model (off, on, on, off), the
    flag switched between turns, REMAT_TURNS steps a turn over ``batches``
    → {mode: step seconds}. Each mode steps through a train step of its
    own (``make_step()``), warmed up and captured with its flag set before
    the turns: a captured step keeps the flag it was captured with. The
    model is left rematerialising."""
    gen = torch.Generator(device=CARD).manual_seed(REMAT_SEED)
    steps = {}
    for on in (False, True):
        model.image_encoder.remat = on
        steps[on] = make_step()
        for i in range(WARMUP_STEPS + 1):
            steps[on](state, batches[i % len(batches)], 1e-4, gen)
    seconds = {"off": [], "on": []}
    for on in (False, True, True, False):
        model.image_encoder.remat = on
        for i in range(REMAT_TURNS):
            batch = batches[i % len(batches)]
            _, secs = timed(lambda: steps[on](state, batch, 1e-4, gen))
            seconds["on" if on else "off"].append(secs)
    model.image_encoder.remat = True
    for step in steps.values():
        step.release()
    return seconds


def run_remat_vision(settings: dict, classes: int, cameras: int, hw, n_steps: int,
                     what: str, profile: bool = False) -> dict:
    """16a: ``settings`` (a ViT-B/16 config at full width and depth) with
    ``TPU.REMAT`` off, then on, each model built by ``make_model`` from the
    same seed and alone on the card: one forward and backward (loss and
    every gradient bit for bit, 12 + 12 against 24 + 12 attention launches,
    all "tc"), then ``n_steps`` train steps from one state and generator
    state (every parameter after them bit for bit; the peak memory of each
    mode), and both modes' steps timed in turns on the second model."""
    images, pids = train_images(seed=41, hw=hw)
    batches = pk_batches(images, pids, n_steps + 1, seed=42)
    del images
    out = {}
    for on in (False, True):
        cfg = remat_cfg(vit_base_cfg(device=CARD, settings=settings), on)
        model = make_model(cfg, num_class=classes, camera_num=cameras, view_num=1)
        if model.image_encoder.remat is not on:
            raise AssertionError(f"16 {what}: TPU.REMAT {on} did not reach the tower")
        depth = len(model.image_encoder.transformer.resblocks)
        loss_fn, _ = make_loss(cfg, classes)
        optimizer = make_optimizer(cfg.SOLVER, model, stage="baseline")
        grads = remat_grads(model, cfg, loss_fn, optimizer, batches[0], depth, on, what)
        steps, step, state = remat_steps(model, cfg, loss_fn, optimizer, batches, depth, on,
                                         what, profile)
        if on:  # each model was checked and measured alone; now both modes in turns
            turns = remat_turns(model, lambda: make_train_step(model, cfg, loss_fn, optimizer),
                                state, batches[1:])
        out[on] = dict(grads=grads, steps=steps)
        del model, optimizer, step, state
        torch.cuda.empty_cache()
    off, on = out[False], out[True]
    diffs = {"loss": first_difference({"l": on["grads"]["loss"]}, {"l": off["grads"]["loss"]}),
             "gradients": first_difference(on["grads"]["grads"], off["grads"]["grads"]),
             "generator": "" if torch.equal(on["grads"]["gen"], off["grads"]["gen"]) else "differs",
             "parameters_after_steps": first_difference(on["steps"]["params"],
                                                        off["steps"]["params"])}
    res = dict(config=what, hw=list(hw), seq_len=hw[0] // 16 * (hw[1] // 16) + 1,
               classes=classes, batch=BATCH, steps=n_steps,
               loss=float(off["grads"]["loss"]), gradient_leaves=len(off["grads"]["grads"]),
               bit_for_bit={k: not v for k, v in diffs.items()},
               **{f"{mode}_{k}": out[m]["steps"][k] for mode, m in (("off", False), ("on", True))
                  for k in ("step_seconds", "peak_mem_gb", "peak_above_held_gb")},
               **{f"turns_{mode}_step_ms_median": float(np.median(turns[mode])) * 1e3
                  for mode in ("off", "on")},
               turns_step_seconds=turns,
               launches_one_step={"off": off["grads"]["launches"],
                                  "on": on["grads"]["launches"]},
               launches_by_route_one_step={"off": off["grads"]["launches_by_route"],
                                           "on": on["grads"]["launches_by_route"]},
               launches_steps={"off": off["steps"]["launches"], "on": on["steps"]["launches"]})
    if profile:
        res.update({f"{mode}_3_steps_{k}": out[m]["steps"]["profile"][k]
                    for mode, m in (("off", False), ("on", True))
                    for k in ("device_busy_ms", "device_idle_share", "wall_ms_traced")})
    res["peak_saved_gb"] = res["off_peak_mem_gb"] - res["on_peak_mem_gb"]
    res["turns_step_time_ratio"] = (res["turns_on_step_ms_median"]
                                    / res["turns_off_step_ms_median"])
    log(f"  16a remat {json.dumps(res)}")
    rate_line(f"16a TPU.REMAT off/on, {what} (median step, peak allocated memory)",
              {k: res[k] for k in ("turns_off_step_ms_median", "turns_on_step_ms_median",
                                   "off_peak_mem_gb", "on_peak_mem_gb", "peak_saved_gb")})
    bad = {k: v for k, v in diffs.items() if v}
    if bad:
        raise AssertionError(f"16a {what}: remat on differs from off: {bad}")
    return res


def run_remat_moe() -> dict:
    """16b: one stage-2b step of configs/tpu/uniprompt_tuned.yml with
    bench.py's MoE (4 experts, top-2, 2 MoE layers; distinct random experts
    and gates) and ``MODEL.MOE.DROPOUT`` 0.1, ``TPU.REMAT`` off then on, from
    one set of weights and one generator state: the loss (the aux loss in
    it), the aux loss alone, every gradient (the gates') and the step
    generator's state after, bit for bit; 12 + 12 against 24 + 12
    attention launches."""
    images, pids = train_images(seed=43, hw=HW)
    batch = pk_batches(images, pids, 1, seed=44)[0]
    del images
    out, text, weights = {}, None, None
    for on in (False, True):
        cfg = remat_cfg(tuned_cfg(), on)
        cfg.MODEL.MOE.DROPOUT = REMAT_MOE_DROPOUT
        if weights is None:
            model = make_model_uniprompt(cfg, UNI_CLASSES, 14, UNI_VIEWS)
            weights = host_copy(model.state_dict())
            text = precompute_text_features(cfg, model, UNI_CLASSES)
        else:
            model = build_model_uniprompt(cfg, UNI_CLASSES, 14, UNI_VIEWS)
            model.load_state_dict(weights, strict=True)
            model = model.to(CARD).eval()
        if model.image_encoder.remat is not on or not model.image_encoder.use_moe:
            raise AssertionError(f"16b: the MoE tower with remat {on} was not built")
        depth = len(model.image_encoder.transformer.resblocks)
        loss_fn, _ = make_loss(cfg, UNI_CLASSES)
        optimizer = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2b")
        res = remat_grads(model, cfg, loss_fn, optimizer, batch, depth, on, "MoE stage 2b",
                          text=text)
        gen = torch.Generator(device=CARD).manual_seed(REMAT_SEED + 1)
        x = eval_preprocess(batch["images"], mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD)
        with torch.enable_grad():
            logits = model.forward_train(x, batch["pids"].long(), gen=gen)["router_logits"]
            res["aux"] = torch.stack([load_balancing_loss(rl, cfg.MODEL.MOE.TOP_K)
                                      for rl in logits]).mean().detach().cpu()
        out[on] = res
        del model, optimizer, logits
        torch.cuda.empty_cache()
    off, on = out[False], out[True]
    gates = [k for k in off["grads"] if k.endswith("gate.weight")]
    diffs = {"loss": first_difference({"l": on["loss"]}, {"l": off["loss"]}),
             "aux_loss": first_difference({"a": on["aux"]}, {"a": off["aux"]}),
             "gradients": first_difference(on["grads"], off["grads"]),
             "generator": "" if torch.equal(on["gen"], off["gen"]) else "differs"}
    res = dict(config="configs/tpu/uniprompt_tuned.yml + MoE 4/2/2, dropout "
                      f"{REMAT_MOE_DROPOUT}", classes=UNI_CLASSES, batch=BATCH,
               loss=float(off["loss"]), aux_loss=float(off["aux"]),
               gradient_leaves=len(off["grads"]),
               gate_grad_norms=[off["grads"][k].norm().item() for k in gates],
               bit_for_bit={k: not v for k, v in diffs.items()},
               launches={"off": off["launches"], "on": on["launches"]},
               launches_by_route={"off": off["launches_by_route"], "on": on["launches_by_route"]})
    log(f"  16b remat MoE stage 2b {json.dumps(res)}")
    bad = {k: v for k, v in diffs.items() if v}
    if bad or len(gates) != MOE_BENCH["MOE_LAYERS"]:
        raise AssertionError(f"16b: remat on differs from off: {bad}, gates {gates}")
    return res


def run_async_checkpoint(tmp: str) -> dict:
    """16c: ``do_train`` over one short epoch of configs/person/vit_base.yml
    (512 seeded images, PK 16 × 4) with ``SOLVER.CHECKPOINT_PERIOD`` 1,
    ``TPU.ASYNC_CHECKPOINT`` off then on: the seconds the loop spends in
    ``save_checkpoint`` and in the final join, the file's size, the file
    loaded back equal bit for bit to the state it was saved from (the state
    ``do_train`` returns: nothing trains after the save); then a write to a
    path under a file, whose failure must surface at
    ``wait_for_pending_saves``."""
    from mpreid_tpu_torch.engine import processor
    from mpreid_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from mpreid_tpu_torch.utils.checkpoint import wait_for_pending_saves

    images, pids = train_images(seed=45, hw=HW)
    real_save, real_wait = processor.save_checkpoint, processor.wait_for_pending_saves
    res = {}
    for on in (False, True):
        cfg = vit_base_cfg(device=CARD)
        cfg.SOLVER.CHECKPOINT_PERIOD = 1
        cfg.TPU.ASYNC_CHECKPOINT = on
        cfg.OUTPUT_DIR = os.path.join(tmp, "async" if on else "blocking")
        model = make_model(cfg, num_class=NUM_CLASSES, camera_num=6, view_num=1)
        depth = len(model.image_encoder.transformer.resblocks)
        loss_fn, _ = make_loss(cfg, NUM_CLASSES)
        optimizer = make_optimizer(cfg.SOLVER, model, stage="baseline")
        sampler = RandomIdentitySampler(list(zip(range(len(pids)), pids)), BATCH, K_INST,
                                        seed=int(cfg.SOLVER.SEED))
        loader = TrainLoader(MemoryBatcher(images, pids, BATCH), sampler)
        n_epoch = len(sampler.epoch_indices(1)) // BATCH
        spent = {"save": 0.0, "join": 0.0}

        def clocked(fn, key):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spent[key] += time.perf_counter() - t0
            return run

        processor.save_checkpoint = clocked(real_save, "save")
        processor.wait_for_pending_saves = clocked(real_wait, "join")
        reset_counts()
        t0 = time.perf_counter()
        try:
            state, history = do_train(cfg, model, loader, None, optimizer, lambda e: 1e-4,
                                      loss_fn, QUERY, max_epochs=1)
        finally:
            processor.save_checkpoint, processor.wait_for_pending_saves = real_save, real_wait
        loop_s = time.perf_counter() - t0
        counts = read_counts()
        expect_counts(f"16c do_train epoch, async {on}", counts,
                      {"attention_fwd": depth * n_epoch, "attention_bwd": depth * n_epoch,
                       "adam_table": n_epoch})
        path = os.path.join(cfg.OUTPUT_DIR, f"{cfg.MODEL.NAME}_1.pth")
        payload = load_checkpoint(path)
        want = {"model": host_copy(model.state_dict()), "mu": host_copy(state.opt_state.mu),
                "nu": host_copy(state.opt_state.nu)}
        got = {"model": payload["model"], "mu": payload["opt_state"]["mu"],
               "nu": payload["opt_state"]["nu"]}
        diffs = {k: first_difference(got[k], want[k]) for k in want}
        mode = "async" if on else "blocking"
        res[mode] = dict(batches=n_epoch, loop_seconds=loop_s, in_save_seconds=spent["save"],
                         final_join_seconds=spent["join"], file_bytes=os.path.getsize(path),
                         loss=history[0]["loss"], bit_for_bit=not any(diffs.values()),
                         launches=counts)
        if any(diffs.values()) or payload["opt_state"]["step"] != state.opt_state.step:
            raise AssertionError(f"16c {mode}: the file differs from the state saved: {diffs}")
        if on:  # a write that fails surfaces at the join
            blocker = os.path.join(tmp, "blocker")
            with open(blocker, "w") as f:
                f.write("x")
            t0 = time.perf_counter()
            save_checkpoint(os.path.join(blocker, "ckpt.pth"), state, 1, cfg)
            res[mode]["failing_save_returned_seconds"] = time.perf_counter() - t0
            try:
                wait_for_pending_saves()
            except RuntimeError as e:
                if "async checkpoint write" not in str(e):
                    raise
                res[mode]["failed_write_raised"] = str(e).replace(tmp, "<tmp>")
            else:
                raise AssertionError("16c: a failed async write did not raise at the join")
        os.remove(path)
        del model, optimizer, state, payload, want, got
        torch.cuda.empty_cache()
    log(f"  16c async checkpoint {json.dumps(res)}")
    rate_line("16c TPU.ASYNC_CHECKPOINT off/on: seconds inside save_checkpoint in the epoch loop",
              {f"{m}_{k}": res[m][k] for m in ("blocking", "async")
               for k in ("in_save_seconds", "final_join_seconds", "file_bytes")})
    return res


# ---------------------------------------------------------------------------
# phase 17: the compiled epochs (make_stage1_epoch, make_train_epoch) as CUDA
# graphs: each against the eager step loop bit for bit, launches per replayed
# step, rates in turns, the idle share of a traced graphed epoch, pool memory
# ---------------------------------------------------------------------------

GRAPH_LRS = (1e-4, 3e-5)  # the two checked epochs' lr: a baked-in lr would show
GRAPH_ROWS = {"stage1": 24, "vit": 8}  # rows of each checked epoch and of each timed turn
GRAPH_TRACED_ROWS = {"stage1": 8, "vit": 4}  # replays of each traced graphed epoch
# rounds of timed turns (graph, loop or eager, twice, graph) of phases 17-19:
# medians of 2 turns a mode
TURN_ROUNDS = 1
GRAPH_SEED = 29  # the step generator of both modes
GRAPH_MOE_DROPOUT = 0.1


def per_replay_counts(epoch) -> dict:
    """The kernel launches one replay of ``epoch``'s captured step adds."""
    from mpreid_tpu_torch.engine.compiled import COUNTED as GRAPH_COUNTED

    if epoch.compiled.per_replay is None:
        raise AssertionError(f"{epoch} captured no graph")
    return {name: epoch.compiled.per_replay[GRAPH_COUNTED.index(fn), None]
            for name, fn in COUNTED.items()}


def replay_table_leaves(epoch, opt, params) -> int:
    """The leaves one replay of ``epoch``'s captured step updates in the Adam
    table, held to those ``opt`` routes there."""
    from mpreid_tpu_torch.engine.compiled import COUNTED as GRAPH_COUNTED

    got = epoch.compiled.per_replay.get((GRAPH_COUNTED.index(adam.adam_leaves), "leaves"), 0)
    want = routed_to_table(opt, params)
    if got != want:
        raise AssertionError(f"{epoch}: the Adam table updates {got} leaves a replay, "
                             f"expected {want}")
    return got


# the kernel each counted wrapper launches once a call, as a trace names it
TRACE_KERNELS = {"attention_fwd": r"\bmha_fwd(_tc)?_kernel<",
                 "attention_bwd": r"\bmha_bwd_tc_kernel<|\bmha_bwd_rows<",
                 "adam": r"\badam_kernel<", "l1_cross": r"\bcross_kernel<L1Op>",
                 "minsum_cross": r"\bcross_kernel<MinOp>", "batch_hard": r"\bbatch_hard_kernel<",
                 "adam_table": r"\bmulti_adam_kernel<"}


def trace_kernel_counts(path: str, span: str = None) -> dict:
    """How many times each counted wrapper's kernel ran in each CUDA graph
    launch of a Chrome trace that ``torch.profiler`` wrote (with ``span``,
    each launch made inside the events of that name): ``{launch's
    correlation id: {name: count}}`` in launch order (``TRACE_KERNELS``;
    every kernel of one replay carries its launch's correlation id)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    marks = [(e["ts"], e["ts"] + e["dur"]) for e in events if span is not None
             and e["name"] == span]
    events = [e for e in events if e.get("cat") in ("kernel", "cuda_runtime")]
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e["cat"] == "cuda_runtime" and e["name"].startswith("cudaGraphLaunch")
                      and (span is None or any(lo <= e["ts"] <= hi for lo, hi in marks)))
    out = {c: dict.fromkeys(TRACE_KERNELS, 0) for _, c in launches}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e["cat"] != "kernel" or c not in out:
            continue
        for k, pat in TRACE_KERNELS.items():
            if re.search(pat, e["name"]):
                out[c][k] += 1
    return out


def traced_graphed_epoch(fn, compiled, attempts: int = 3) -> dict:
    """``trace_idle_share`` of one ``fn()``, a graphed epoch (or calls of a
    compiled step) of ``compiled`` that only replays, under
    ``torch.profiler``, and the counted kernels each replay launched, read
    from the trace's kernel records. The idle share is taken over the
    span of ``fn()`` and a synchronize;
    the profiler runs on 50 ms past it, since it keeps only device records
    that end inside its window, and one traced epoch lacked 5 of its 416
    Adam kernel records without that margin. Now and then the profiler
    keeps no record of a kernel inside the window too (two runs lost 1 and
    2 of one replay's 12 attention records). The first graph launch of a
    profiling session lost one of its 12 attention records in all three
    traced runs of phase 18b's text step in two runs of this script, with
    the window opened 50 ms before it or not; so each profiling session
    runs ``fn()`` once before the checked span, and only the launches
    inside the span are checked. A run whose checked replays'
    traced kernels disagree is logged, with the launches that differ by
    their place in launch order, and traced again; one of ``attempts``
    must agree."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, attempts + 1):
        captures = compiled.stats["captures"]
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
                time.sleep(0.05)
                replays = compiled.stats["replays"]
                with record_function("graphed_epoch"):
                    fn()
                    torch.cuda.synchronize()
                replays = compiled.stats["replays"] - replays
                time.sleep(0.05)
            path = os.path.join(tmp, "graphed_epoch.json")
            prof.export_chrome_trace(path)
            res = trace_idle_share(path, span="graphed_epoch")
            per_launch = trace_kernel_counts(path, span="graphed_epoch")
        if res["device_spans"] <= 0:
            raise AssertionError(f"the traced graphed epoch shows no device work: {res}")
        if compiled.stats["captures"] != captures or replays <= 0:
            raise AssertionError(f"the traced graphed epoch captured again or replayed nothing: "
                                 f"{compiled.stats}")
        seen = {json.dumps(c, sort_keys=True): c for c in per_launch.values()}
        if len(per_launch) == replays and len(seen) == 1:
            break
        counts = list(per_launch.values())
        common = max(counts, key=counts.count)
        what = (f"the trace shows {len(per_launch)} graph launches for {replays} replays, "
                f"{common} in most, other counts at launches (place, counts) "
                f"{[(i, c) for i, c in enumerate(counts) if c != common]}")
        if attempt == attempts:
            raise AssertionError(what)
        log(f"  traced run {attempt} of {attempts}: {what}; tracing again")
    res.update(replays=replays, launches_per_replay_traced=next(iter(seen.values())),
               trace_attempts=attempt, fn_calls=2 * attempt)
    return res


def graph_turns(turn, rows_of, per_turn: int, other: str = "loop", rounds: int = TURN_ROUNDS,
                first: str = "graph") -> dict:
    """Both modes' rates (rows or images a second), in turns: (``first``,
    ``other``, ``other``, ``first``), ``rounds`` times, or four turns of
    ``first`` a round with ``other`` None; ``turn(mode, rows)`` runs one
    turn."""
    order = (first, other, other, first) if other else (first,) * 4
    rates = {mode: [] for mode in order}
    for rnd in range(rounds):
        for i, mode in enumerate(order):
            rows = rows_of(100 + 4 * rnd + i)
            _, secs = timed(lambda: turn(mode, rows))
            rates[mode].append(len(rows) * per_turn / secs)
    res = dict(order=f"{' '.join(order)}, {rounds} round(s)", per_s=rates,
               median_per_s={k: float(np.median(v)) for k, v in rates.items()})
    if other:
        res[f"{first}_over_{other}"] = res["median_per_s"][first] / res["median_per_s"][other]
    return res


def graph_report(what: str, diffs: dict, per_step: dict, want: dict, counts: dict,
                 n_steps: int, rates: dict, trace: dict, pool_bytes: int, unit: str,
                 extra: dict, phase: str = "17", against: str = "the step loop") -> dict:
    """Phase 17's or 18's verdict on one case: the graphed mode bit for bit
    against the eager one, one capture replayed, the counted kernels of a
    replay as ``want`` says and as its trace shows, the checked run's
    launches those of ``n_steps`` steps, bf16 attention on "tc"."""
    traced = trace["launches_per_replay_traced"]
    other = "loop" if phase == "17" else "eager"
    res = dict(case=what, bit_for_bit={k: not v for k, v in diffs.items()},
               launches_per_replayed_step=traced, launches_per_replay_counted=per_step,
               launches_checked_epochs=counts, checked_steps=n_steps, rates=rates, unit=unit,
               traced_graphed_epoch={k: trace[k] for k in ("window_ms", "device_busy_ms",
                                                           "device_idle_share", "trace_bytes",
                                                           "replays")},
               graph_pool_gb=pool_bytes / 1e9, card=CARD_LINE, **extra)
    log(f"  {phase} {json.dumps(res)}")
    rate_line(f"{phase} {what}: graphed against {against} ({unit}, medians of "
              f"{len(rates['per_s']['graph'])} turns)",
              {"graph": rates["median_per_s"]["graph"], other: rates["median_per_s"][other],
               "idle_share_graphed": trace["device_idle_share"],
               "graph_pool_gb": pool_bytes / 1e9})
    bad = {k: v for k, v in diffs.items() if v}
    if bad:
        raise AssertionError(f"{phase} {what}: the graphed run differs from {against}: {bad}")
    stats = extra["stats"]
    if stats["captures"] != 1 or stats["replays"] <= 0 or pool_bytes <= 0:
        raise AssertionError(f"{phase} {what}: not one captured graph replayed: {stats}")
    if per_step != {name: want.get(name, 0) for name in per_step}:
        raise AssertionError(f"{phase} {what}: launches per replayed step {per_step}, "
                             f"expected {want}")
    if traced != per_step:
        raise AssertionError(f"{phase} {what}: the trace shows {traced} kernels a replay, the "
                             f"counters {per_step}")
    if counts != {name: n_steps * per_step[name] for name in counts}:
        raise AssertionError(f"{phase} {what}: {counts} launches in {n_steps} steps, expected "
                             f"{per_step} a step")
    if read_routes()["attention_fwd"]["tf32x3"] or read_routes()["attention_bwd"]["tf32x3"]:
        raise AssertionError(f"{phase} {what}: bf16 attention off the tensor-core route")
    return res


def graph_stage1(model, cfg, bank, stage: str) -> dict:
    """17a: ``make_stage1_epoch`` against its step body
    (``_make_stage1_body``) called eagerly over the same rows of the bank,
    from one set of contexts: two epochs at GRAPH_LRS, every step's loss, the
    contexts, the moments and the step bit for bit."""
    stage_cfg = cfg.SOLVER[f"STAGE{stage.upper()}"].clone()
    feats = bank[0]
    labels, views = (torch.as_tensor(a).to(CARD).long() for a in bank[1:])
    n = GRAPH_ROWS["stage1"]

    def rows_of(seed):
        return np.random.default_rng(seed).permutation(len(labels))[:n * BATCH].reshape(n, BATCH)

    probe = make_optimizer(stage_cfg, model, stage=f"stage{stage}")
    contexts = {k: p.detach().clone() for k, p in probe.partition(model)[0].items()}
    params = dict(model.named_parameters())
    modes = {}

    def turn(mode, rows, lr=GRAPH_LRS[-1]):
        r = modes[mode]
        if mode == "graph":
            r["state"], losses = r["epoch"](r["state"], feats, labels, views, rows, lr)
            return losses
        r["opt"].set_lr(r["state"].opt_state, lr)
        out = []
        for row in rows:
            sel = torch.as_tensor(row, device=CARD)
            out.append(r["body"](r["state"], feats[sel], labels[sel],
                                 views[sel] if stage == "1b" else None)[None])
        return torch.cat(out)

    for mode in ("graph", "loop"):
        with torch.no_grad():
            for k, v in contexts.items():
                params[k].copy_(v)
        opt = make_optimizer(stage_cfg, model, stage=f"stage{stage}")
        modes[mode] = dict(opt=opt, state=initial_state(model, opt),
                           epoch=make_stage1_epoch(model, cfg, opt, stage),
                           body=_make_stage1_body(opt, stage))
        torch.cuda.synchronize()
        reset_counts()
        losses = torch.cat([turn(mode, rows_of(e), lr) for e, lr in enumerate(GRAPH_LRS)])
        torch.cuda.synchronize()
        r, st = modes[mode], modes[mode]["state"].opt_state
        r.update(counts=read_counts(), losses=losses.cpu(),
                 contexts=host_copy({k: params[k] for k in contexts}),
                 moments=host_copy({**st.mu, **{f"nu.{k}": v for k, v in st.nu.items()}}),
                 steps_taken=int(st.step))
    g, lp = modes["graph"], modes["loop"]
    diffs = {"losses": first_difference({"l": g["losses"]}, {"l": lp["losses"]}),
             "contexts": first_difference(g["contexts"], lp["contexts"]),
             "moments": first_difference(g["moments"], lp["moments"]),
             "step": "" if g["steps_taken"] == lp["steps_taken"] == 2 * n
             else f"{g['steps_taken']} / {lp['steps_taken']}"}
    per_step = per_replay_counts(g["epoch"])
    rates = graph_turns(turn, rows_of, BATCH)
    traced_rows = rows_of(200)[:GRAPH_TRACED_ROWS["stage1"]]
    trace = traced_graphed_epoch(lambda: turn("graph", traced_rows), g["epoch"].compiled)
    pool = g["epoch"].compiled.stats["pool_bytes"]
    tdepth = len(model.text_encoder.transformer.resblocks)
    res = graph_report(f"17a stage {stage} (configs/ours/cctv_ir_cctv_rgb.yml, text tower "
                       f"12 x 512, L 77, {UNI_CLASSES} classes, bank {len(labels)}, batch "
                       f"{BATCH})", diffs, per_step,
                       {"attention_fwd": tdepth, "attention_bwd": tdepth, "adam_table": 1},
                       g["counts"], 2 * n, rates, trace, pool, "bank rows/s",
                       dict(loss=float(g["losses"][0]), stats=g["epoch"].compiled.stats))
    for r in modes.values():
        r["epoch"].release()
    return res


def eager_train_body(model, cfg, loss_fn, optimizer, kwargs: dict):
    """``body(state, batch, gen)``: the train step's body
    (``_make_step_body``) called eagerly on ``batch`` (numpy arrays or
    tensors) moved to the card, at the lr in the state's buffer, the eager
    reference of phases 17 and 18."""
    step_body = _make_step_body(model, cfg, loss_fn, optimizer, None, None,
                                kwargs.get("uniprompt", False), kwargs.get("text_features"))

    def body(state, batch, gen):
        def dev(a):
            return None if a is None else torch.as_tensor(a).to(CARD, non_blocking=True)

        cam, view = labels_for(cfg, batch)
        return step_body(state, dev(batch["images"]), dev(batch["pids"]), dev(cam), dev(view),
                         gen)

    return body


def graph_train(what: str, cfg, model, loss_fn, stage: str, opt_cfg, kwargs: dict, data,
                rows_of, want: dict) -> dict:
    """17b-d: ``make_train_epoch`` against its step body (``_make_step_body``)
    called eagerly over the same rows of the resident ``data``, each mode on
    its own copy of ``model`` from one generator state: two epochs at
    GRAPH_LRS, every step's loss and accuracy, every parameter and buffer
    (the BN running statistics), the moments, the step and the generator
    state bit for bit."""
    n = GRAPH_ROWS["vit"]
    modes = {}
    for mode in ("graph", "loop"):
        m = copy.deepcopy(model)
        opt = make_optimizer(opt_cfg, m, stage=stage)
        modes[mode] = dict(model=m, opt=opt, state=initial_state(m, opt),
                           gen=torch.Generator(device=CARD).manual_seed(GRAPH_SEED),
                           epoch=make_train_epoch(m, cfg, loss_fn, opt, **kwargs),
                           body=eager_train_body(m, cfg, loss_fn, opt, kwargs))

    def turn(mode, rows, lr=GRAPH_LRS[-1]):
        r = modes[mode]
        if mode == "graph":
            r["state"], (losses, accs) = r["epoch"](r["state"], *data, rows, lr, r["gen"])
            return torch.stack([losses, accs])
        r["opt"].set_lr(r["state"].opt_state, lr)
        out = []
        for row in rows:
            idx = torch.as_tensor(row, device=CARD)
            batch = dict(zip(("images", "pids", "camids", "trackids"),
                             (t.index_select(0, idx) for t in data)))
            r["state"], metrics = r["body"](r["state"], batch, r["gen"])
            out.append(torch.stack([metrics["loss"], metrics["acc"]]))
        return torch.stack(out, dim=1)

    for mode, r in modes.items():
        torch.cuda.synchronize()
        reset_counts()
        out = torch.cat([turn(mode, rows_of(e)[:n], lr) for e, lr in enumerate(GRAPH_LRS)], dim=1)
        torch.cuda.synchronize()
        st = r["state"].opt_state
        r.update(counts=read_counts(), out=out.cpu(), weights=host_copy(r["model"].state_dict()),
                 moments=host_copy({**st.mu, **{f"nu.{k}": v for k, v in st.nu.items()}}),
                 steps_taken=int(st.step), gen_state=r["gen"].get_state())
    g, lp = modes["graph"], modes["loop"]
    diffs = {"losses_and_accuracies": first_difference({"o": g["out"]}, {"o": lp["out"]}),
             "parameters_and_buffers": first_difference(g["weights"], lp["weights"]),
             "moments": first_difference(g["moments"], lp["moments"]),
             "step": "" if g["steps_taken"] == lp["steps_taken"] == 2 * n
             else f"{g['steps_taken']} / {lp['steps_taken']}",
             "generator": "" if torch.equal(g["gen_state"], lp["gen_state"]) else "differs"}
    per_step = per_replay_counts(g["epoch"])
    rates = graph_turns(turn, lambda e: rows_of(e)[:n], BATCH)
    traced_rows = rows_of(200)[:GRAPH_TRACED_ROWS["vit"]]
    trace = traced_graphed_epoch(lambda: turn("graph", traced_rows), g["epoch"].compiled)
    pool = g["epoch"].compiled.stats["pool_bytes"]
    res = graph_report(what, diffs, per_step, want, g["counts"], 2 * n, rates, trace, pool,
                       "img/s", dict(loss=float(g["out"][0, 0]), stats=g["epoch"].compiled.stats,
                                     remat=bool(cfg.TPU.REMAT),
                                     fused_adam=bool(getattr(opt_cfg, "FUSED_ADAM", False)),
                                     table_leaves_per_replay=replay_table_leaves(
                                         g["epoch"], g["opt"], g["model"])))
    for r in modes.values():
        r["epoch"].release()
    del modes
    torch.cuda.empty_cache()
    return res


def pk_rows(pids: np.ndarray, n: int, seed: int) -> np.ndarray:
    """``n`` PK rows (P_IDS identities × K_INST images) of indices into ``pids``."""
    rng = np.random.default_rng(seed)
    ids = np.unique(pids)
    return np.stack([np.concatenate([rng.choice(np.flatnonzero(pids == i), K_INST, replace=False)
                                     for i in rng.choice(ids, P_IDS, replace=False)])
                     for _ in range(n)])


def run_compiled_epochs(market_loader, market_data) -> dict:
    """Phase 17 (module docstring): 17a stage 1a and 1b; 17b
    configs/person/vit_base.yml over phase 11's resident Market-1501-size
    set, SOLVER.FUSED_ADAM off and on; 17c MoE 2a and 2b under
    configs/tpu/uniprompt_tuned.yml, 2b with MODEL.MOE.DROPOUT; 17d 17b and
    the MoE 2b case with TPU.REMAT on."""
    out = {}
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    cfg = uniprompt_cfg()
    model = make_model_uniprompt(cfg, num_class=UNI_CLASSES, camera_num=14, view_num=UNI_VIEWS)
    images, pids, views = uniprompt_images()
    bank = build_image_bank(cfg, model, ShuffledLoader(MemoryBatcher(images, pids, BATCH, views),
                                                       int(cfg.SOLVER.SEED)))
    for stage in ("1a", "1b"):
        out[f"17a_{stage}"] = graph_stage1(model, cfg, bank, stage)
    del model, bank
    torch.cuda.empty_cache()
    log(f"  17a seconds {time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    seed = int(vit_base_cfg().SOLVER.SEED)

    def market_rows(e):
        return epoch_perm(market_loader, e, seed)

    for remat, fused in ((False, False), (False, True), (True, False)):
        cfg = remat_cfg(vit_base_cfg(device=CARD), remat)
        cfg.TPU.DEVICE_DATASET = True
        cfg.SOLVER.FUSED_ADAM = fused
        model = make_model(cfg, num_class=MARKET_TRAIN["ids"], camera_num=MARKET_TRAIN["cams"],
                           view_num=1)
        depth = len(model.image_encoder.transformer.resblocks)
        loss_fn, _ = make_loss(cfg, MARKET_TRAIN["ids"])
        key = "17d_vit_remat" if remat else f"17b_vit_fused_adam_{'on' if fused else 'off'}"
        out[key] = graph_train(
            f"{key[:3]} configs/person/vit_base.yml + TPU.DEVICE_DATASET (Market-1501 size), "
            f"FUSED_ADAM {'on' if fused else 'off'}, REMAT {'on' if remat else 'off'}",
            cfg, model, loss_fn, "baseline", cfg.SOLVER, {}, market_data, market_rows,
            {"attention_fwd": depth * (2 if remat else 1), "attention_bwd": depth,
             "adam": ADAM_LEAVES if fused else 0, "adam_table": 1})
        del model
        torch.cuda.empty_cache()
    log(f"  17b/17d ViT seconds {time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    images, pids = train_images(seed=47)
    data = [torch.from_numpy(images).to(CARD), torch.from_numpy(pids).to(CARD),
            *(torch.zeros(len(pids), dtype=torch.int32, device=CARD) for _ in range(2))]
    del images
    weights, text = None, None
    for key, stage, dropout, remat in (("17c_moe_2a", "2a", 0.0, False),
                                       ("17c_moe_2b_dropout", "2b", GRAPH_MOE_DROPOUT, False),
                                       ("17d_moe_2b_dropout_remat", "2b", GRAPH_MOE_DROPOUT, True)):
        cfg = remat_cfg(tuned_cfg(), remat)
        cfg.MODEL.MOE.DROPOUT = dropout
        if weights is None:
            model = make_model_uniprompt(cfg, UNI_CLASSES, 14, UNI_VIEWS)
            weights = host_copy(model.state_dict())
            text = precompute_text_features(cfg, model, UNI_CLASSES)
        else:
            model = build_model_uniprompt(cfg, UNI_CLASSES, 14, UNI_VIEWS)
            model.load_state_dict(weights, strict=True)
            model = model.to(CARD).eval()
        depth = len(model.image_encoder.transformer.resblocks)
        loss_fn, _ = make_loss(cfg, UNI_CLASSES)
        out[key] = graph_train(
            f"{key[:3]} MoE stage {stage} (configs/tpu/uniprompt_tuned.yml, MoE 4/2/2, bf16 "
            f"moments), dropout {dropout}, REMAT {'on' if remat else 'off'}",
            cfg, model, loss_fn, f"stage{stage}", cfg.SOLVER.STAGE2,
            dict(uniprompt=True, text_features=text), data,
            lambda e: pk_rows(pids, GRAPH_ROWS["vit"], seed=e),
            {"attention_fwd": depth * (2 if remat else 1), "attention_bwd": depth,
             "adam_table": 1})
        del model
        torch.cuda.empty_cache()
    log(f"  17c/17d MoE seconds {time.perf_counter() - t0:.1f}")
    del data, text
    torch.cuda.synchronize()
    log(f"  17 allocated before the phase {held / 1e9:.3f} GB, after it "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB (the resident Market set included)")
    return out


# ---------------------------------------------------------------------------
# phase 18: the compiled steps, each against its eager body, bit for bit
# ---------------------------------------------------------------------------

STEP_CHECK_ROWS = 3  # checked train steps at each of STEP_LRS: two warm-up, a capture, 3 replays
STEP_LRS = (1e-4, 3e-5)
STEP_TURN_ROWS = 8  # train steps a timed turn
STEP_TRACED = 4  # replays a traced run
EVAL_TURN_BATCHES = 76  # 18a's batches a timed turn: a quarter of Market-1501's 302
STAGE1_TAIL = 40  # rows of stage 1's trailing partial batch (a bank of 4,096 + 40)
STAGE1_TAIL_EPOCHS = 4


class PaddedBatcher:
    """``ImageBatcher.iter_sequential``'s contract over uint8 images held in
    memory, the last batch padded to full width as data/loader.py pads it
    (zero images, the last record repeated)."""

    def __init__(self, images: np.ndarray, pids: np.ndarray, camids: np.ndarray,
                 batch_size: int):
        self.images, self.pids, self.camids = images, pids, camids
        self.batch_size = batch_size

    def iter_sequential(self):
        for lo in range(0, len(self.pids), self.batch_size):
            idx = np.arange(lo, min(lo + self.batch_size, len(self.pids)))
            count, pad = len(idx), self.batch_size - len(idx)
            images = self.images[lo:lo + count]
            if pad:
                images = np.concatenate([images, np.zeros((pad, *images.shape[1:]), np.uint8)])
                idx = np.concatenate([idx, np.full(pad, idx[-1])])
            yield {"images": images, "pids": self.pids[idx], "camids": self.camids[idx],
                   "trackids": np.zeros(len(idx), np.int32), "count": count}


def market_eval_set(seed: int = 37):
    """Seeded uint8 query + gallery images at Market-1501's test size (3,368
    + 15,913 of 256×128, 750 identities on both sides, the query on camera
    0 and the gallery on camera 1)."""
    nq, ng, ids = MARKET["q"], MARKET["g"], MARKET["ids"]
    pids = np.concatenate([np.arange(nq) % ids, np.arange(ng) % ids]).astype(np.int32)
    camids = np.concatenate([np.zeros(nq), np.ones(ng)]).astype(np.int32)
    return identity_images(pids, ids, seed), pids, camids


@contextlib.contextmanager
def made_by(module, name: str):
    """The objects ``module.name`` (a step factory) makes while the block
    runs, in a list."""
    real, made = getattr(module, name), []

    def spy(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    setattr(module, name, spy)
    try:
        yield made
    finally:
        setattr(module, name, real)


def to_card(a):
    return None if a is None else torch.as_tensor(a).to(CARD, non_blocking=True)


def step_case(what: str, step, eager, calls: list, unit: str, per_call: int, want: dict,
              diffs: dict, counts: dict, n_calls: int, stats: dict, extra: dict) -> dict:
    """Phase 18's report of one step: the rates of ``step(call)`` against
    ``eager(call)`` over ``calls`` in turns (graph, eager, eager, graph,
    TURN_ROUNDS times; ``per_call`` units a call), the kernels of STEP_TRACED traced
    replays against the counters, the idle share over them, and
    ``graph_report``'s checks of the bit-for-bit ``diffs`` and the checked
    run's ``counts`` over ``n_calls`` calls."""
    def turn(mode, chunk):
        fn = step if mode == "graph" else eager
        return [fn(c) for c in chunk]

    rates = graph_turns(turn, lambda i: calls, per_call, other="eager")
    per_step = per_replay_counts(step)
    trace = traced_graphed_epoch(lambda: turn("graph", calls[:STEP_TRACED]), step.compiled)
    return graph_report(f"{what}", diffs, per_step, want, counts, n_calls, rates, trace,
                        stats["pool_bytes"], unit, dict(stats=stats, **extra), phase="18",
                        against="its eager body")


def compiled_eval() -> dict:
    """18a: ``run_validation`` on configs/person/vit_base.yml at Market-1501's
    query + gallery size, batch 64, the last batch padded: every batch's
    features, CMC and mAP against the eager body's bit for bit; the eval
    feats/s of both modes in turns over the first EVAL_TURN_BATCHES batches."""
    cfg = vit_base_cfg()
    model = make_model(cfg, num_class=NUM_CLASSES, camera_num=6, view_num=1)
    depth = len(model.image_encoder.transformer.resblocks)
    t0 = time.perf_counter()
    images, pids, camids = market_eval_set()
    loader = PaddedBatcher(images, pids, camids, BATCH)
    n_batches = -(-len(pids) // BATCH)
    log(f"  18a {len(pids)} images ({MARKET['q']} query), {n_batches} batches, made in "
        f"{time.perf_counter() - t0:.1f} s")
    kept = []

    class Kept(R1mAPEvaluator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    torch.cuda.synchronize()
    reset_counts()
    real, processor.R1mAPEvaluator = processor.R1mAPEvaluator, Kept
    try:
        (cmc, mAP), secs = timed(lambda: run_validation(cfg, model, loader, MARKET["q"]))
    finally:
        processor.R1mAPEvaluator = real
    counts = read_counts()
    step = processor.cached_eval_step(model, cfg)
    body = _make_eval_body(lambda: model, cfg)

    def eager(batch):
        return body(to_card(batch["images"]), *map(to_card, labels_for(cfg, batch)))[0]

    reference = copy.copy(kept[0])
    reference.reset()
    differ = []
    for i, batch in enumerate(loader.iter_sequential()):
        n = batch["count"]
        feat = eager(batch)[:n]
        if not torch.equal(kept[0].feats[i], feat.float()):
            differ.append(i)
        reference.update((feat, batch["pids"][:n], batch["camids"][:n]))
    r_cmc, r_map, *_ = reference.compute()
    diffs = {"features": f"{len(differ)} of {n_batches} batches differ, first {differ[:5]}"
             if differ else "",
             "cmc": "" if np.array_equal(cmc, r_cmc) else "differs",
             "mAP": "" if mAP == r_map else f"{mAP!r} against {r_map!r}"}
    del kept, reference
    res = step_case(f"18a run_validation, configs/person/vit_base.yml, Market-1501 query + "
                    f"gallery ({MARKET['q']} + {MARKET['g']}), batch {BATCH}, padded tail",
                    step, eager, list(loader.iter_sequential())[:EVAL_TURN_BATCHES], "feats/s",
                    len(pids) / n_batches,
                    {"attention_fwd": depth}, diffs, counts, n_batches,
                    dict(step.compiled.stats), dict(run_validation_seconds=secs,
                                                    rank1=float(cmc[0]), mAP=float(mAP)))
    release_eval_steps(model)
    return res


def compiled_bank_and_text() -> tuple:
    """18b: ``build_image_bank`` over BANK_IMAGES images and
    ``precompute_text_features`` over UNI_CLASSES classes on
    configs/ours/cctv_ir_cctv_rgb.yml, each against its eager body bit for
    bit, both modes' rates in turns → (results, model, cfg, bank)."""
    cfg = uniprompt_cfg()
    model = make_model_uniprompt(cfg, num_class=UNI_CLASSES, camera_num=14, view_num=UNI_VIEWS)
    vdepth = len(model.image_encoder.transformer.resblocks)
    tdepth = len(model.text_encoder.transformer.resblocks)
    images, pids, views = uniprompt_images()
    loader = ShuffledLoader(MemoryBatcher(images, pids, BATCH, views), int(cfg.SOLVER.SEED))
    out = {}

    torch.cuda.synchronize()
    reset_counts()
    with made_by(uni_engine, "make_image_bank_step") as made:
        bank, secs = timed(lambda: build_image_bank(cfg, model, loader))
    counts = read_counts()
    batches = list(loader.epoch(0, drop_last=False))
    bank_body = _make_bank_body(model, cfg)

    def eager_bank(batch):
        return bank_body(to_card(batch["images"]))[0]

    want = torch.cat([eager_bank(b)[:b["count"]] for b in batches])
    step = make_image_bank_step(model, cfg)
    for b in batches[:3]:  # warm-up, capture: the turns time replays
        step(b)
    out["bank"] = step_case(
        f"18b build_image_bank, configs/ours/cctv_ir_cctv_rgb.yml, {BANK_IMAGES} images, batch "
        f"{BATCH}", step, eager_bank, batches, "feats/s", BATCH, {"attention_fwd": vdepth},
        {"bank": first_difference({"bank": bank[0]}, {"bank": want})}, counts, len(batches),
        dict(made[0].compiled.stats), dict(build_image_bank_seconds=secs))
    step.release()

    torch.cuda.synchronize()
    reset_counts()
    with made_by(uni_engine, "make_text_step") as made:
        text, secs = timed(lambda: precompute_text_features(cfg, model, UNI_CLASSES))
    counts = read_counts()
    label_batches = [torch.arange(lo, min(lo + BATCH, UNI_CLASSES), device=CARD)
                     for lo in range(0, UNI_CLASSES, BATCH)]
    text_body = _make_text_body(model, "2")

    def eager_text(labels):
        return text_body(labels, None)[0]

    want = torch.cat([eager_text(lb) for lb in label_batches])
    stats = dict(made[0].compiled.stats)
    full = UNI_CLASSES // BATCH
    if stats["eager_steps"] != 2 + bool(UNI_CLASSES % BATCH) or stats["replays"] != full - 2:
        raise AssertionError(f"18b text features: the tail did not run eagerly beside the "
                             f"full-width graph: {stats}")
    step = make_text_step(model, "2")
    for lb in label_batches[:3]:
        step(lb)
    out["text"] = step_case(
        f"18b precompute_text_features, configs/ours/cctv_ir_cctv_rgb.yml, {UNI_CLASSES} "
        f"classes in batches of {BATCH} (text tower 12 x 512, L 77, causal)", step, eager_text,
        label_batches[:full], "classes/s", BATCH, {"attention_fwd": tdepth},
        {"text_features": first_difference({"t": text}, {"t": want})}, counts,
        len(label_batches), stats, dict(precompute_seconds=secs, tail=UNI_CLASSES % BATCH))
    step.release()
    return out, model, cfg, bank


def compiled_train(what: str, cfg, model, loss_fn, stage: str, opt_cfg, kwargs: dict,
                   loader, want: dict) -> dict:
    """18c: ``make_train_step`` over host batches of phase 11's loader (the
    PK sampler's rows decoded from memory, as ``train_epochs`` feeds it)
    against its body called eagerly on the same batches, each mode on its
    own copy of ``model`` from one generator state: STEP_CHECK_ROWS steps at
    each of STEP_LRS, every loss and accuracy, parameter and buffer, the
    moments, the step and the generator bit for bit; img/s in turns."""
    seed = int(cfg.SOLVER.SEED)
    modes = {}
    for mode in ("graph", "eager"):
        m = copy.deepcopy(model)
        opt = make_optimizer(opt_cfg, m, stage=stage)
        modes[mode] = dict(model=m, opt=opt, state=initial_state(m, opt),
                           gen=torch.Generator(device=CARD).manual_seed(GRAPH_SEED))
    graph, eager = modes["graph"], modes["eager"]
    step = make_train_step(graph["model"], cfg, loss_fn, graph["opt"], **kwargs)
    body = eager_train_body(eager["model"], cfg, loss_fn, eager["opt"], kwargs)

    def host_batches(rows):
        return list(loader.batcher.iter_indices(np.asarray(rows).reshape(-1), drop_last=True))

    def run(mode, batches, lr):
        r, out = modes[mode], []
        if mode == "eager":
            r["opt"].set_lr(r["state"].opt_state, lr)
        for batch in batches:
            if mode == "graph":
                r["state"], metrics = step(r["state"], batch, lr, r["gen"])
            else:
                r["state"], metrics = body(r["state"], batch, r["gen"])
            out.append(torch.stack([metrics["loss"], metrics["acc"]]))
        return torch.stack(out, dim=1)

    checked = [host_batches(epoch_perm(loader, 50 + e, seed)[:STEP_CHECK_ROWS])
               for e in range(len(STEP_LRS))]
    for mode, r in modes.items():
        torch.cuda.synchronize()
        reset_counts()
        out = torch.cat([run(mode, b, lr) for b, lr in zip(checked, STEP_LRS)], dim=1)
        torch.cuda.synchronize()
        st = r["state"].opt_state
        r.update(counts=read_counts(), out=out.cpu(), weights=host_copy(r["model"].state_dict()),
                 moments=host_copy({**st.mu, **{f"nu.{k}": v for k, v in st.nu.items()}}),
                 steps_taken=int(st.step), gen_state=r["gen"].get_state())
    n = STEP_CHECK_ROWS * len(STEP_LRS)
    diffs = {"losses_and_accuracies": first_difference({"o": graph["out"]}, {"o": eager["out"]}),
             "parameters_and_buffers": first_difference(graph["weights"], eager["weights"]),
             "moments": first_difference(graph["moments"], eager["moments"]),
             "step": "" if graph["steps_taken"] == eager["steps_taken"] == n
             else f"{graph['steps_taken']} / {eager['steps_taken']}",
             "generator": "" if torch.equal(graph["gen_state"], eager["gen_state"]) else "differs"}
    stats = dict(step.compiled.stats)

    def turn(mode, rows):  # the loader decodes while the steps run, as in train_epochs
        return run(mode, loader.batcher.iter_indices(rows.reshape(-1), drop_last=True),
                   STEP_LRS[-1])

    rates = graph_turns(turn, lambda i: epoch_perm(loader, i, seed)[:STEP_TURN_ROWS], BATCH,
                        other="eager")
    trace = traced_graphed_epoch(lambda: turn("graph", epoch_perm(loader, 200, seed)[
        :STEP_TRACED]), step.compiled)
    res = graph_report(what, diffs, per_replay_counts(step), want, graph["counts"], n, rates,
                       trace, stats["pool_bytes"], "img/s",
                       dict(stats=stats, loss=float(graph["out"][0, 0]),
                            remat=bool(cfg.TPU.REMAT),
                            fused_adam=bool(getattr(opt_cfg, "FUSED_ADAM", False)),
                            table_leaves_per_replay=replay_table_leaves(
                                step, graph["opt"], graph["model"])),
                       phase="18", against="its eager body")
    step.release()
    del modes
    torch.cuda.empty_cache()
    return res


def compiled_stage1_tail(model, cfg, bank) -> dict:
    """18d: stage 1b's trailing partial batch (STAGE1_TAIL bank rows) through
    ``make_stage1_step`` over STAGE1_TAIL_EPOCHS epochs (eager in the first
    two, captured in the third) against ``_make_stage1_body`` from one set of
    contexts: losses, contexts, moments and the step bit for bit; then
    ``do_train_stage1`` over three epochs of a bank with such a tail, whose
    trailing step replays in the third."""
    stage_cfg = cfg.SOLVER.STAGE1B.clone()
    feats = bank[0]
    labels, views = (torch.as_tensor(a).to(CARD).long() for a in bank[1:])
    tdepth = len(model.text_encoder.transformer.resblocks)
    probe = make_optimizer(stage_cfg, model, stage="stage1b")
    contexts = {k: p.detach().clone() for k, p in probe.partition(model)[0].items()}
    params = dict(model.named_parameters())
    calls = [(feats[sel], labels[sel], views[sel]) for sel in (
        torch.as_tensor(np.random.default_rng(300 + e).permutation(len(labels))[:STAGE1_TAIL],
                        device=CARD) for e in range(STAGE1_TAIL_EPOCHS))]
    lrs = [STEP_LRS[e % 2] for e in range(STAGE1_TAIL_EPOCHS)]
    modes = {}

    def run(mode, chunk, lrs=lrs):
        r, losses = modes[mode], []
        for (f, lb, v), lr in zip(chunk, lrs):
            if mode == "graph":
                r["state"], metrics = r["step"](r["state"], f, lb, v, lr)
                losses.append(metrics["loss"][None])
            else:
                r["opt"].set_lr(r["state"].opt_state, lr)
                losses.append(r["body"](r["state"], f, lb, v)[None])
        return torch.cat(losses)

    for mode in ("graph", "eager"):
        with torch.no_grad():
            for k, v in contexts.items():
                params[k].copy_(v)
        opt = make_optimizer(stage_cfg, model, stage="stage1b")
        r = modes[mode] = dict(opt=opt, state=initial_state(model, opt))
        if mode == "graph":
            r["step"] = make_stage1_step(model, cfg, opt, "1b")
        else:
            r["body"] = _make_stage1_body(opt, "1b")
        torch.cuda.synchronize()
        reset_counts()
        losses = run(mode, calls)
        torch.cuda.synchronize()
        st = r["state"].opt_state
        r.update(counts=read_counts(), losses=losses.cpu(),
                 contexts=host_copy({k: params[k] for k in contexts}),
                 moments=host_copy({**st.mu, **{f"nu.{k}": v for k, v in st.nu.items()}}),
                 steps_taken=int(st.step))
    g, e = modes["graph"], modes["eager"]
    diffs = {"losses": first_difference({"l": g["losses"]}, {"l": e["losses"]}),
             "contexts": first_difference(g["contexts"], e["contexts"]),
             "moments": first_difference(g["moments"], e["moments"]),
             "step": "" if g["steps_taken"] == e["steps_taken"] == STAGE1_TAIL_EPOCHS
             else f"{g['steps_taken']} / {e['steps_taken']}"}
    step = g["step"]
    stats = dict(step.compiled.stats)
    if stats["eager_steps"] != 2 or stats["replays"] != STAGE1_TAIL_EPOCHS - 2:
        raise AssertionError(f"18d: the trailing step did not replay from the third epoch on: "
                             f"{stats}")
    rates = graph_turns(lambda mode, chunk: run(mode, chunk, [lrs[-1]] * len(chunk)),
                        lambda i: calls, STAGE1_TAIL, other="eager")
    trace = traced_graphed_epoch(lambda: run("graph", calls), step.compiled)
    per_step = per_replay_counts(step)
    step.release()

    # the real path: do_train_stage1 over three epochs of a bank with a tail
    tail_bank = (torch.cat([feats, feats[:STAGE1_TAIL]]),
                 np.concatenate([bank[1], bank[1][:STAGE1_TAIL]]),
                 np.concatenate([bank[2], bank[2][:STAGE1_TAIL]]))
    stage_cfg.MAX_EPOCHS = 3
    opt = make_optimizer(stage_cfg, model, stage="stage1b")
    with made_by(uni_engine, "make_stage1_step") as made:
        (_, history), secs = timed(lambda: do_train_stage1(
            cfg, model, None, opt, make_scheduler(stage_cfg, "cosine"), is_stage1b=True,
            bank=tail_bank, stage_cfg=stage_cfg))
    loop_stats = dict(made[0].compiled.stats)
    if loop_stats["captures"] != 1 or loop_stats["replays"] != 1 or \
            not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"18d do_train_stage1 over 3 epochs: the trailing step "
                             f"{loop_stats}, history {history}")
    return graph_report(
        f"18d stage 1b trailing step, configs/ours/cctv_ir_cctv_rgb.yml, {STAGE1_TAIL} bank "
        f"rows, {STAGE1_TAIL_EPOCHS} epochs", diffs, per_step,
        {"attention_fwd": tdepth, "attention_bwd": tdepth, "adam_table": 1}, g["counts"],
        STAGE1_TAIL_EPOCHS,
        rates, trace, stats["pool_bytes"], "bank rows/s",
        dict(stats=stats, do_train_stage1_3_epochs=dict(
            bank_rows=len(labels) + STAGE1_TAIL, seconds=secs, trailing_step=loop_stats)),
        phase="18", against="its eager body")


def run_compiled_steps(market_loader) -> dict:
    """Phase 18 (module docstring): 18a run_validation; 18b the bank and the
    text features; 18c the host-loader train step (vit_base.yml with
    FUSED_ADAM off and on, cnn_base.yml, the MoE stage-2b step of
    uniprompt_tuned.yml with dropout and TPU.REMAT); 18d stage 1's trailing
    step."""
    out, t0 = {}, time.perf_counter()
    out["18a_eval"] = compiled_eval()
    torch.cuda.empty_cache()
    log(f"  18a seconds {time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    res, model, cfg, bank = compiled_bank_and_text()
    out["18b_bank"], out["18b_text"] = res["bank"], res["text"]
    out["18d_stage1_tail"] = compiled_stage1_tail(model, cfg, bank)
    del model, bank
    torch.cuda.empty_cache()
    log(f"  18b/18d seconds {time.perf_counter() - t0:.1f}")

    for key, settings, fused in (("18c_vit_fused_adam_off", VIT_BASE, False),
                                 ("18c_vit_fused_adam_on", VIT_BASE, True),
                                 ("18c_rn50", CNN_BASE, False)):
        t0 = time.perf_counter()
        cfg = vit_base_cfg(settings=settings)
        cfg.SOLVER.FUSED_ADAM = fused
        model = make_model(cfg, num_class=MARKET_TRAIN["ids"], camera_num=MARKET_TRAIN["cams"],
                           view_num=1)
        vit = cfg.MODEL.NAME == "ViT-B-16"
        depth = len(model.image_encoder.transformer.resblocks) if vit else 0
        loss_fn, _ = make_loss(cfg, MARKET_TRAIN["ids"])
        out[key] = compiled_train(
            f"{key[:3]} configs/person/{'vit' if vit else 'cnn'}_base.yml, host loader "
            f"(Market-1501 size), FUSED_ADAM {'on' if fused else 'off'}", cfg, model, loss_fn,
            "baseline", cfg.SOLVER, {}, market_loader,
            {"attention_fwd": depth, "attention_bwd": depth, "adam": ADAM_LEAVES if fused else 0,
             "adam_table": 1})
        del model
        torch.cuda.empty_cache()
        log(f"  {key} seconds {time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    cfg = remat_cfg(tuned_cfg(), True)
    cfg.MODEL.MOE.DROPOUT = GRAPH_MOE_DROPOUT
    model = make_model_uniprompt(cfg, UNI_CLASSES, 14, UNI_VIEWS)
    text = precompute_text_features(cfg, model, UNI_CLASSES)
    depth = len(model.image_encoder.transformer.resblocks)
    out["18c_moe_2b_dropout_remat"] = compiled_train(
        f"18c MoE stage 2b (configs/tpu/uniprompt_tuned.yml, MoE 4/2/2, bf16 moments), dropout "
        f"{GRAPH_MOE_DROPOUT}, REMAT on, host loader", cfg, model, make_loss(cfg, UNI_CLASSES)[0],
        "stage2b", cfg.SOLVER.STAGE2, dict(uniprompt=True, text_features=text), market_loader,
        {"attention_fwd": 2 * depth, "attention_bwd": depth, "adam_table": 1})
    del model, text
    torch.cuda.empty_cache()
    log(f"  18c MoE seconds {time.perf_counter() - t0:.1f}")
    return out


# ---------------------------------------------------------------------------
# phase 19: the TTA / TTPT steps as CUDA graphs against their eager bodies
# ---------------------------------------------------------------------------

TTPT_GRAPH_QUERY = TTPT_QUERY - BATCH // 2  # phase 19's queries: the fourth batch straddles
# engine/ttpt.py's steps, by the getter do_inference_tta / do_inference_ttpt takes each from
TTPT_STEP_GETTERS = {"tta_query": "cached_tta_query_step", "plain": "cached_eval_step",
                     "ttpt_query": "cached_ttpt_query_step", "tuner": "cached_ttpt_tuner"}


def batch_on_card(cfg, batch) -> tuple:
    """A numpy batch's images and labels on the card, as a compiled step uploads them."""
    return (to_card(batch["images"]), *map(to_card, labels_for(cfg, batch)))


def eager_ttpt_step(kind: str, model, cfg, feat_norm: bool = False):
    """Step ``kind`` of engine/ttpt.py as its eager body, called on the card
    with the compiled step's signature."""
    def model_of():
        return model

    if kind == "tuner":
        return ttpt_engine._make_tuner_body(model_of, cfg)
    if kind == "tta_query":
        body = ttpt_engine._make_tta_query_body(model_of, cfg)
        return lambda batch, boundary: body(*batch_on_card(cfg, batch),
                                            torch.tensor(boundary, device=CARD))[0]
    body = (_make_eval_body(model_of, cfg, feat_norm) if kind == "plain"
            else ttpt_engine._make_ttpt_query_body(model_of, cfg))
    return lambda batch: body(*batch_on_card(cfg, batch))[0]


@contextlib.contextmanager
def ttpt_steps(mode: str, seen: dict):
    """Inside, ``do_inference_tta`` / ``do_inference_ttpt`` take their steps
    as ``mode`` says ("graph": the compiled steps kept on the model; "eager":
    their bodies), and each call's outputs land in ``seen[kind]``, the
    metrics in ``seen["metrics"]`` and Option B's distances in
    ``seen["distmat"]``."""
    real = {kind: getattr(ttpt_engine, name) for kind, name in TTPT_STEP_GETTERS.items()}
    real_evaluator, real_cmc_map = ttpt_engine.R1mAPEvaluator, ttpt_engine.cmc_map

    def getter(kind):
        def get(model, cfg, **kwargs):
            step = (real[kind](model, cfg, **kwargs) if mode == "graph"
                    else eager_ttpt_step(kind, model, cfg, **kwargs))

            def call(*args):
                out = step(*args)
                seen.setdefault(kind, []).append(out if isinstance(out, tuple) else (out,))
                return out

            return call

        return get

    class Recording(real_evaluator):
        def compute(self):
            out = super().compute()
            seen["metrics"] = (out[0], out[1])
            return out

    def cmc_map(distmat, *args, **kwargs):
        out = real_cmc_map(distmat, *args, **kwargs)
        seen["distmat"], seen["metrics"] = distmat, (out[0].cpu().numpy(), float(out[1]))
        return out

    for kind, name in TTPT_STEP_GETTERS.items():
        setattr(ttpt_engine, name, getter(kind))
    ttpt_engine.R1mAPEvaluator, ttpt_engine.cmc_map = Recording, cmc_map
    try:
        yield
    finally:
        for kind, name in TTPT_STEP_GETTERS.items():
            setattr(ttpt_engine, name, real[kind])
        ttpt_engine.R1mAPEvaluator, ttpt_engine.cmc_map = real_evaluator, real_cmc_map


def seen_diffs(got: dict, want: dict) -> dict:
    """{what: '' when bit-equal, else how} between two ``ttpt_steps`` records."""
    out = {}
    for key, calls in want.items():
        if key == "metrics":
            (cmc, m_ap), (want_cmc, want_map) = got[key], calls
            out["cmc"] = "" if np.array_equal(cmc, want_cmc) else "differs"
            out["mAP"] = "" if m_ap == want_map else f"{m_ap!r} against {want_map!r}"
        elif key == "distmat":
            out[key] = first_difference({key: got[key]}, {key: calls})
        elif len(got.get(key, [])) != len(calls):
            out[key] = f"{len(got.get(key, []))} calls against {len(calls)}"
        else:
            def flat(c):
                return {f"call {i} output {j}": t for i, outs in enumerate(c)
                        for j, t in enumerate(outs)}
            out[key] = first_difference(flat(got[key]), flat(calls))
    return out


def run_compiled_ttpt(model) -> dict:
    """Phase 19 (module docstring): Option A and Option B through
    ``do_inference_ttpt`` on phase 12's model and images with
    TTPT_GRAPH_QUERY queries, each step graphed against its eager body."""
    vdepth = len(model.image_encoder.transformer.resblocks)
    tdepth = len(model.text_encoder.transformer.resblocks)
    loader = InMemoryBatcher(TTPT_QUERY, TTPT_GALLERY, BATCH, HW, seed=13)
    nq = TTPT_GRAPH_QUERY
    batches = list(loader.iter_sequential())
    bounds = [int(np.clip(nq - BATCH * i, 0, BATCH)) for i in range(len(batches))]
    n_query = sum(k > 0 for k in bounds)  # query batches (the straddling one included)
    n_gallery_only = bounds.count(0)
    n_with_gallery = sum(k < BATCH for k in bounds)
    options = {"19a": ttpt_cfg(tta=True, ttpt=False), "19b": ttpt_cfg(tta=True, ttpt=True)}
    per_call = {"19a": {"attention_fwd": vdepth * (4 * n_query + n_gallery_only)},
                "19b": {"attention_fwd": vdepth * (2 * n_query + n_with_gallery)
                        + tdepth * (TTPT_STEPS + 1) * n_query,
                        "attention_bwd": tdepth * TTPT_STEPS * n_query}}
    per_replay = {"tta_query": {"attention_fwd": 4 * vdepth}, "plain": {"attention_fwd": vdepth},
                  "ttpt_query": {"attention_fwd": 2 * vdepth},
                  "tuner": {"attention_fwd": (TTPT_STEPS + 1) * tdepth,
                            "attention_bwd": TTPT_STEPS * tdepth}}
    what = {"tta_query": "the TTA query step (4 views, boundary an input)",
            "plain": "the plain step, norm fused (the gallery-only batches)",
            "ttpt_query": "the TTPT query input (plain + h-flip, projected, norm)",
            "tuner": f"the TTPT tuner ({TTPT_STEPS} steps over {UNI_CLASSES} classes)"}
    release_eval_steps(model)  # phase 12's steps: this phase captures its own
    torch.cuda.empty_cache()
    out = {}
    for phase, cfg in options.items():
        t0 = time.perf_counter()
        option = "Option A" if phase == "19a" else "Option B"
        kinds = ("tta_query", "plain") if phase == "19a" else ("ttpt_query", "tuner", "plain")
        reported = kinds[:2]  # 19b's plain step is 19a's (one key), reported there
        feat_norm = cfg.TEST.FEAT_NORM == "yes"

        def step_of(kind):
            return getattr(ttpt_engine, TTPT_STEP_GETTERS[kind])(
                model, cfg, **({"feat_norm": feat_norm} if kind == "plain" else {}))

        def entry(mode, seen=None):
            with ttpt_steps(mode, {} if seen is None else seen):
                return do_inference_ttpt(cfg, model, loader, nq)

        runs, seen, peak = [], {}, {}
        for i, mode in enumerate(("graph", "graph", "eager")):
            seen[i] = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            runs.append(entry(mode, seen[i]))
            torch.cuda.synchronize()
            expect_counts(f"{phase} {option}, {mode} call {i + 1}", read_counts(), per_call[phase])
            peak[f"{mode}_call_{i + 1}_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if i == 0:
                first_stats = {k: dict(step_of(k).compiled.stats) for k in kinds}
        stats = {k: dict(step_of(k).compiled.stats) for k in kinds}
        recaptured = {k: stats[k]["captures"] - first_stats[k]["captures"] for k in kinds}
        if any(recaptured.values()) or any(s["captures"] != 1 for s in stats.values()):
            raise AssertionError(f"{phase}: the second do_inference_ttpt call captured again or a "
                                 f"step captured other than once: {stats}")
        if not runs[0] == runs[1] == runs[2]:
            raise AssertionError(f"{phase}: ranks {runs}")
        # the graphed call that only replays against the eager bodies, bit for bit
        diffs = seen_diffs(seen[1], seen[2])
        query_calls = len(seen[1]["tta_query" if phase == "19a" else "ttpt_query"])
        if query_calls != n_query:  # the straddling batch's among them, replayed
            raise AssertionError(f"{phase}: {query_calls} query-step calls, not {n_query}")
        rates = graph_turns(lambda mode, rows: entry(mode), lambda i: range(nq), 1,
                            other="eager")
        if phase == "19b":
            aggs = [a for (a,) in seen[1]["ttpt_query"]]
            tuner, eager_tuner = step_of("tuner"), eager_ttpt_step("tuner", model, cfg)
            tuned = graph_turns(lambda mode, rows: [(tuner if mode == "graph" else eager_tuner)(a)
                                                    for a in rows],
                                lambda i: aggs[i % len(aggs):][:1], 1, other="eager")
            tuned["seconds_per_tuned_batch"] = {
                k: 1 / v for k, v in tuned["median_per_s"].items()}
        calls = {"tta_query": [(b, k) for b, k in zip(batches, bounds) if k > 0],
                 "plain": [(b,) for b, k in zip(batches, bounds) if k == 0],
                 "ttpt_query": [(b,) for b, k in zip(batches, bounds) if k > 0]}
        if phase == "19b":
            calls["tuner"] = [(a,) for a in aggs]
        for kind in reported:
            step = step_of(kind)
            reset_counts()
            trace = traced_graphed_epoch(lambda: [step(*c) for c in calls[kind]], step.compiled)
            counts = read_counts()
            extra = dict(stats=dict(step.compiled.stats), recaptured_by_second_call=recaptured,
                         ranks=runs[1], peak_allocated=peak, queries=nq,
                         query_images_per_s=rates["median_per_s"])
            kind_rates, unit = rates, f"query images/s through do_inference_ttpt, {option}"
            if kind == "tuner":
                kind_rates, unit = tuned, "tuned batches/s (one tuner call of 64 queries)"
                extra["seconds_per_tuned_batch"] = tuned["seconds_per_tuned_batch"]
            out[f"{phase}_{kind}"] = graph_report(
                f"{phase} {option}: {what[kind]}, configs/ours/cctv_ir_cctv_rgb.yml, "
                f"{nq} + {len(loader.pids) - nq} images, batch {BATCH}", diffs,
                per_replay_counts(step), per_replay[kind], counts,
                len(calls[kind]) * trace["fn_calls"], kind_rates, trace,
                step.compiled.stats["pool_bytes"], unit, extra, phase=phase[:2],
                against="its eager body")
        log(f"  {phase} seconds {time.perf_counter() - t0:.1f}")
    release_eval_steps(model)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 20: from image files, DATALOADER.NATIVE_DECODE off against on
# ---------------------------------------------------------------------------

# 3,000 train, query and gallery images each: the writer numbers the test
# identities after the train ones, and the Market-1501 parser takes ids up
# to 1501, so 750 train identities (Market-1501 has 751)
FILE_IDS, FILE_IMGS_PER_ID = 750, 4
FILE_SOURCE_HW = (128, 64)  # Market-1501's own image size, resized to HW
FILE_WORKERS = 8  # vit_base.yml's DATALOADER.NUM_WORKERS: the PIL side's threads
FILE_CHECK_STEPS = 6  # checked train steps: two warm-up, a capture, three replays
FILE_RERANK = dict(q=512, g=2048, k1=K1, k2=15, lam=0.3)  # 20d: the evaluator's k1, k2, λ


def native_probe() -> dict:
    """20-probe: what the native path needs on this host: g++, the libjpeg
    and libpng headers, Pillow (its self-check and the tree's writer), the
    host's cores, and what the two native libraries say."""
    from mpreid_tpu_torch.native import imageio as native_io
    from mpreid_tpu_torch.native import rerank as native_rr

    def gxx(args, stdin=None):
        try:
            p = subprocess.run(["g++", *args], input=stdin, capture_output=True, text=True,
                               timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            return None
        return p.stdout.splitlines()[0] if p.returncode == 0 and p.stdout else p.returncode == 0

    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = None
    res = dict(gxx=gxx(["--version"]) or None,
               jpeglib_and_png_headers=bool(gxx(["-fsyntax-only", "-x", "c++", "-"],
                                                "#include <cstdio>\n#include <jpeglib.h>\n"
                                                "#include <png.h>\n")),
               pillow=pillow, cpu_count=os.cpu_count(),
               native_imageio=native_io.native_imageio_available(),
               native_imageio_why=native_io.why_unavailable(),
               native_rerank=native_rr.native_available(),
               native_rerank_why=native_rr.why_unavailable(), card=CARD_LINE)
    log(f"  20-probe {json.dumps(res)}")
    return res


def decoder_turns(turn, modes: tuple, rows_of, per_turn: int) -> dict:
    """``graph_turns`` over the decoders: (native, pil, pil, native) twice,
    or four turns of the one decoder."""
    return graph_turns(turn, rows_of, per_turn, other=modes[1] if len(modes) == 2 else None,
                       rounds=len(modes), first=modes[0])


def files_decode(records: list, modes: tuple) -> dict:
    """20a: ``ImageBatcher.decode_records`` over the train files, CACHE_IMAGES
    off, each decoder; the arrays byte for byte; images/s in turns."""
    batchers = {m: ImageBatcher(records, HW, BATCH, FILE_WORKERS, native=m == "native")
                for m in modes}
    if [b.native for b in batchers.values()] != [m == "native" for m in modes]:
        raise AssertionError(f"20a: the batchers took other paths than {modes}")
    out = {}

    def turn(mode, recs):
        out[mode] = np.stack(batchers[mode].decode_records(recs))

    rates = decoder_turns(turn, modes, lambda i: records, 1)
    res = dict(images=len(records), size=list(HW), source_size=list(FILE_SOURCE_HW),
               pil_workers=FILE_WORKERS, cpu_count=os.cpu_count(), rates=rates,
               byte_equal=all(np.array_equal(out[m], out[modes[0]]) for m in modes),
               card=CARD_LINE)
    log(f"  20a decode {json.dumps(res)}")
    rate_line(f"20a decode_records over {len(records)} JPEG files ({FILE_SOURCE_HW[0]}x"
              f"{FILE_SOURCE_HW[1]} to {HW[0]}x{HW[1]}), images/s, medians of 4 turns, "
              f"{os.cpu_count()} host CPUs", rates["median_per_s"])
    if not res["byte_equal"]:
        raise AssertionError(f"20a: the decoders' arrays differ: {res}")
    return dict(res=res, images=out[modes[0]])


def files_train(model, cfg, loaders: dict) -> dict:
    """20b: the graphed ``make_train_step`` fed by each decoder's
    ``TrainLoader`` from the files (``make_dataloader``), each on its own
    copy of ``model`` from one generator state: FILE_CHECK_STEPS steps, the
    losses and accuracies, parameters and buffers, moments, step and
    generator bit for bit between the decoders; img/s in turns of
    STEP_TURN_ROWS steps (the loader decoding while the steps run); the
    traced idle share and the kernels of STEP_TRACED replays by decoder."""
    seed = int(cfg.SOLVER.SEED)
    loss_fn, _ = make_loss(cfg, FILE_IDS)
    depth = len(model.image_encoder.transformer.resblocks)
    want = {"attention_fwd": depth, "attention_bwd": depth, "adam": ADAM_LEAVES, "adam_table": 1}
    modes = {}
    for mode, loader in loaders.items():
        m = copy.deepcopy(model)
        opt = make_optimizer(cfg.SOLVER, m, stage="baseline")
        modes[mode] = dict(model=m, opt=opt, state=initial_state(m, opt), loader=loader,
                           gen=torch.Generator(device=CARD).manual_seed(GRAPH_SEED),
                           step=make_train_step(m, cfg, loss_fn, opt))
    orders = {mode: epoch_perm(r["loader"], 0, seed) for mode, r in modes.items()}
    if any(not np.array_equal(o, orders["pil"]) for o in orders.values()):
        raise AssertionError("20b: the decoders' loaders sample other rows")

    def turn(mode, rows, lr=STEP_LRS[-1]):
        r, out = modes[mode], []
        for batch in r["loader"].batcher.iter_indices(rows.reshape(-1), drop_last=True):
            r["state"], metrics = r["step"](r["state"], batch, lr, r["gen"])
            out.append(torch.stack([metrics["loss"], metrics["acc"]]))
        return torch.stack(out, dim=1)

    for mode, r in modes.items():
        torch.cuda.synchronize()
        reset_counts()
        out = turn(mode, orders[mode][:FILE_CHECK_STEPS], STEP_LRS[0])
        torch.cuda.synchronize()
        st = r["state"].opt_state
        r.update(counts=read_counts(), out=out.cpu(), weights=host_copy(r["model"].state_dict()),
                 moments=host_copy({**st.mu, **{f"nu.{k}": v for k, v in st.nu.items()}}),
                 steps_taken=int(st.step), gen_state=r["gen"].get_state())
        expect_counts(f"20b {mode}: {FILE_CHECK_STEPS} steps", r["counts"],
                      {k: v * FILE_CHECK_STEPS for k, v in want.items()})
    pil = modes["pil"]
    diffs = {}
    if "native" in modes:
        nat = modes["native"]
        diffs = {"losses_and_accuracies": first_difference({"o": nat["out"]}, {"o": pil["out"]}),
                 "parameters_and_buffers": first_difference(nat["weights"], pil["weights"]),
                 "moments": first_difference(nat["moments"], pil["moments"]),
                 "step": "" if nat["steps_taken"] == pil["steps_taken"] else "differs",
                 "generator": "" if torch.equal(nat["gen_state"], pil["gen_state"])
                 else "differs"}
    rates = decoder_turns(turn, tuple(modes), lambda i: epoch_perm(
        pil["loader"], i, seed)[:STEP_TURN_ROWS], BATCH)
    traced = {}
    for mode, r in modes.items():
        trace = traced_graphed_epoch(lambda: turn(mode, epoch_perm(r["loader"], 200, seed)[
            :STEP_TRACED]), r["step"].compiled)
        per_step = per_replay_counts(r["step"])
        traced[mode] = dict(launches_per_replay_counted=per_step,
                            launches_per_replay_traced=trace["launches_per_replay_traced"],
                            **{k: trace[k] for k in ("window_ms", "device_busy_ms",
                                                     "device_idle_share", "replays")},
                            stats=dict(r["step"].compiled.stats))
        if not per_step == trace["launches_per_replay_traced"] == {
                name: want.get(name, 0) for name in per_step}:
            raise AssertionError(f"20b {mode}: launches a replay {traced[mode]}, expected {want}")
        if r["step"].compiled.stats["captures"] != 1:
            raise AssertionError(f"20b {mode}: not one captured graph: {traced[mode]}")
    res = dict(config="configs/person/vit_base.yml + SOLVER.FUSED_ADAM, host loader from "
                      f"{len(pil['loader'].batcher.records)} JPEG files",
               checked_steps=FILE_CHECK_STEPS, loss=float(pil["out"][0, 0]),
               losses_finite=bool(torch.isfinite(pil["out"]).all()),
               bit_for_bit={k: not v for k, v in diffs.items()}, rates=rates, traced=traced,
               card=CARD_LINE)
    log(f"  20b {json.dumps(res)}")
    rate_line("20b host-loader train step from JPEG files, img/s (configs/person/vit_base.yml, "
              f"batch {BATCH}, medians of 4 turns of {STEP_TURN_ROWS} steps; "
              f"{os.cpu_count()} host CPUs)",
              {**rates["median_per_s"],
               **{f"idle_share_{m}": t["device_idle_share"] for m, t in traced.items()}})
    bad = {k: v for k, v in diffs.items() if v}
    if bad or not res["losses_finite"]:
        raise AssertionError(f"20b: the native-decoded steps differ from the PIL-decoded ones, "
                             f"or a loss is not finite: {bad} {res}")
    for r in modes.values():
        r["step"].release()
    return dict(res=res, model=pil["model"])


def files_eval(model, cfg, loaders: dict, num_query: int) -> dict:
    """20c: ``run_validation`` over the query and gallery files, each decoder
    twice in turns: the features of every batch, CMC and mAP bit for bit
    between the decoders; feats/s."""
    kept = []

    class Kept(R1mAPEvaluator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    depth = len(model.image_encoder.transformer.resblocks)
    n_images = len(loaders["pil"].records)
    n_batches = len(loaders["pil"])
    modes = tuple(loaders)
    order = (modes[0], modes[1], modes[1], modes[0]) if len(modes) == 2 else modes * 2
    runs = {m: [] for m in modes}
    real, processor.R1mAPEvaluator = processor.R1mAPEvaluator, Kept
    try:
        for mode in order:
            torch.cuda.synchronize()
            reset_counts()
            (cmc, mAP), secs = timed(lambda: run_validation(cfg, model, loaders[mode], num_query))
            counts = read_counts()
            expect_counts(f"20c {mode} run_validation", counts,
                          {"attention_fwd": depth * n_batches})
            runs[mode].append(dict(feats=torch.cat(kept[-1].feats).float(), cmc=cmc, mAP=mAP,
                                   feats_per_s=n_images / secs))
    finally:
        processor.R1mAPEvaluator = real
    first = {m: r[0] for m, r in runs.items()}
    base = first["pil"]
    diffs = {}
    if "native" in first:
        nat = first["native"]
        diffs = {"features": "" if torch.equal(nat["feats"], base["feats"]) else "differ",
                 "cmc": "" if np.array_equal(nat["cmc"], base["cmc"]) else "differs",
                 "mAP": "" if nat["mAP"] == base["mAP"] else f"{nat['mAP']!r} / {base['mAP']!r}"}
    rates = {m: [r["feats_per_s"] for r in rs] for m, rs in runs.items()}
    res = dict(images=n_images, query=num_query, batches=n_batches, order=" ".join(order),
               feats_per_s=rates, median_feats_per_s={m: float(np.median(v))
                                                      for m, v in rates.items()},
               rank1=float(base["cmc"][0]), mAP=float(base["mAP"]),
               features_finite=bool(torch.isfinite(base["feats"]).all()),
               feature_shape=list(base["feats"].shape),
               bit_for_bit={k: not v for k, v in diffs.items()}, launches=counts,
               card=CARD_LINE)
    log(f"  20c {json.dumps(res)}")
    rate_line(f"20c run_validation from {n_images} JPEG files ({num_query} query), feats/s, "
              f"medians of 2 runs, {os.cpu_count()} host CPUs", res["median_feats_per_s"])
    bad = {k: v for k, v in diffs.items() if v}
    if bad or not res["features_finite"] or base["feats"].shape[0] != n_images:
        raise AssertionError(f"20c: the decoders' eval results differ, or the features are "
                             f"not whole and finite: {bad} {res}")
    return dict(res=res, feats=base["feats"])


def files_rerank(feats: torch.Tensor, num_query: int) -> dict:
    """20d: ``native/rerank.py`` on the host against the card's dense
    ``re_ranking`` (one L1 kernel launch a call) at FILE_RERANK's query ×
    gallery shape, both timed. (a) On seeded clustered features
    (``clustered_feats``, four rows an identity, as real ReID features
    spread), whose neighbour sets no rounding moves: held to RERANK_TOL.
    (b) On 20c's normalised features: a random-weight model's features lie
    in a narrow band of distances where neighbours tie at the k1 and k2
    boundaries, and tie order then decides the sets (the native
    re-ranker's ``std::partial_sort``, the dense one's lower index first;
    the JAX package's own pair differs there as much). So the host-vs-card
    difference is reported beside the host's native against the port's
    dense re-ranking on the host's CPU (the same inputs, no card), and the
    card's dense against the CPU's dense on the features rounded to
    multiples of 2⁻¹⁰ (exact distance products, one tie order: see
    ``rerank_entry``) is held to RERANK_TOL."""
    from mpreid_tpu_torch.native import re_ranking_native
    from mpreid_tpu_torch.ops.reranking import re_ranking

    p = FILE_RERANK
    q, g = p["q"], p["g"]

    def rerank(x):
        return re_ranking(x[:q], x[q:], k1=p["k1"], k2=p["k2"], lambda_value=p["lam"])

    def host_and_card(x):
        rerank(x)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        card, card_s = timed(lambda: rerank(x).cpu())
        counts = read_counts()
        expect_counts("20d dense re_ranking on the card", counts, {"l1_cross": 1})
        t0 = time.perf_counter()
        host = re_ranking_native(x[:q].cpu().numpy(), x[q:].cpu().numpy(), k1=p["k1"],
                                 k2=p["k2"], lambda_value=p["lam"])
        return host, card.numpy(), dict(
            card_seconds=card_s, host_seconds=time.perf_counter() - t0, launches=counts,
            host_vs_card_max_abs=float(np.abs(host - card.numpy()).max()),
            finite=bool(np.isfinite(host).all() and np.isfinite(card.numpy()).all()))

    seeded = torch.from_numpy(clustered_feats(q, g, (q + g) // 4, seed=3)[0]).to(CARD)
    _, _, clustered = host_and_card(seeded)
    f = feats / torch.linalg.norm(feats, dim=1, keepdim=True)
    f = torch.cat([f[:q], f[num_query:num_query + g]]).to(CARD)
    host, _, real = host_and_card(f)
    grid = torch.round(f * 1024) / 1024
    real.update(host_vs_host_dense_max_abs=float(np.abs(host - rerank(f.cpu()).numpy()).max()),
                grid_card_vs_cpu_dense_max_abs=float(
                    (rerank(grid).cpu() - rerank(grid.cpu())).abs().max()),
                rows_with_other_neighbours=neighbour_flips(f, p["k1"] + 1))
    res = dict(shape=[q, g], dim=f.shape[1], k1=p["k1"], k2=p["k2"], lam=p["lam"],
               tol=RERANK_TOL, cpu_count=os.cpu_count(), card=CARD_LINE,
               clustered=clustered, features_20c=real)
    log(f"  20d re-ranking, host (native) against the card (dense) {json.dumps(res)}")
    if not (clustered["host_vs_card_max_abs"] <= RERANK_TOL
            and real["grid_card_vs_cpu_dense_max_abs"] <= RERANK_TOL
            and clustered["finite"] and real["finite"]):
        raise AssertionError(f"20d: re-ranked distances differ: {res}")
    return res


def files_device_dataset(loaders: dict, images: np.ndarray) -> dict:
    """20e: ``build_device_dataset`` (TPU.DEVICE_DATASET's uint8 train set on
    the card) from the files, each decoder, held to 20a's bytes."""
    out = {}
    for mode, loader in loaders.items():
        torch.cuda.synchronize()
        data, secs = timed(lambda: build_device_dataset(loader, torch.device(CARD)))
        out[mode] = dict(seconds=secs, images=list(data[0].shape),
                         equal_to_20a=bool(np.array_equal(data[0].cpu().numpy(), images)))
        del data
    res = dict(cpu_count=os.cpu_count(), card=CARD_LINE, **out)
    log(f"  20e build_device_dataset from the files {json.dumps(res)}")
    if not all(o["equal_to_20a"] for o in out.values()):
        raise AssertionError(f"20e: the device-resident set differs from the decoded bytes: {res}")
    return res


def run_from_files() -> dict:
    """Phase 20 (module docstring): a synthetic Market-1501 tree of JPEG
    files; 20a decode alone, 20b the host-loader train step, 20c
    run_validation, 20d the native re-ranker against the card's, 20e the
    device-resident set; each with the native decoder off and, where it
    builds and self-checks on this host, on."""
    from mpreid_tpu_torch.data import make_dataloader
    from mpreid_tpu_torch.data.synthetic import make_market1501

    probe = native_probe()
    missing = [what for what, ok in (("g++", probe["gxx"]),
                                     ("the libjpeg / libpng headers",
                                      probe["jpeglib_and_png_headers"]),
                                     ("Pillow", probe["pillow"])) if not ok]
    res = dict(probe=probe, missing=missing)
    if probe["pillow"] is None:
        log(f"  20: {', '.join(missing)} missing on this host: no file can be written; 20a, "
            f"20b, 20c, 20d, 20e did not run")
        return res
    modes = ("native", "pil") if probe["native_imageio"] else ("pil",)
    skipped = [] if probe["native_imageio"] else ["20a", "20b", "20c", "20e"]
    if not probe["native_rerank"]:
        skipped.append("20d")
    log(f"  20: native decode {probe['native_imageio']} on this host"
        + (f" ({probe['native_imageio_why']}; missing: {', '.join(missing) or 'nothing'}): "
           f"the PIL side of 20a, 20b, 20c, 20e ran, their native side did not"
           if not probe["native_imageio"] else "")
        + (f"; 20d did not run ({probe['native_rerank_why']})"
           if not probe["native_rerank"] else ""))
    res["native_side_not_run"] = skipped
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_market1501(tmp, n_ids=FILE_IDS, imgs_per_id=FILE_IMGS_PER_ID, size=FILE_SOURCE_HW,
                        identity_signal=True)
        res["tree_seconds"] = time.perf_counter() - t0
        cfgs, loaders = {}, {}
        for mode in modes:
            cfg = vit_base_cfg()
            cfg.DATASETS.ROOT_DIR = tmp
            cfg.DATALOADER.NUM_WORKERS = FILE_WORKERS
            cfg.DATALOADER.NATIVE_DECODE = mode == "native"
            cfg.SOLVER.FUSED_ADAM = True
            cfgs[mode], loaders[mode] = cfg, make_dataloader(cfg)
        train, _, _, num_query, classes, cams, _ = loaders["pil"]
        if classes != FILE_IDS or [b.native for m in modes for b in (
                loaders[m][0].batcher, loaders[m][2])] != [m == "native" for m in modes
                                                             for _ in (0, 1)]:
            raise AssertionError(f"20: the tree's loaders: {classes} classes, decoders "
                                 f"{[loaders[m][2].native for m in modes]} for {modes}")
        log(f"  20 tree of {len(train.batcher.records)} train, {num_query} query and "
            f"{len(loaders['pil'][2].records) - num_query} gallery JPEG files written in "
            f"{res['tree_seconds']:.1f} s")
        t0 = time.perf_counter()
        decoded = files_decode(train.batcher.records, modes)
        res["20a"] = decoded["res"]
        model = make_model(cfgs["pil"], num_class=classes, camera_num=cams, view_num=1)
        trained = files_train(model, cfgs["pil"], {m: loaders[m][0] for m in modes})
        res["20b"], model = trained["res"], trained["model"]
        evaluated = files_eval(model, cfgs["pil"], {m: loaders[m][2] for m in modes}, num_query)
        res["20c"] = evaluated["res"]
        release_eval_steps(model)
        del model, trained
        if probe["native_rerank"]:
            res["20d"] = files_rerank(evaluated.pop("feats"), num_query)
        res["20e"] = files_device_dataset({m: loaders[m][0] for m in modes},
                                          decoded["images"])
        res["seconds_20a_to_20e"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 21: the measured programs (utils/benchkit.py) at bench.py's widths
# ---------------------------------------------------------------------------

# bench.py's full-run sizes (bench.py:262-268; its TTA section's loader,
# :819): 1,000 classes, batch 64, stage-1 epochs of 50 rows, step windows of
# 20 steps, eval scans of 40 forwards of 128, the TTA scan 10 of 128, 4 + 4
# val batches of 128
BENCH = dict(classes=1000, batch=64, stage1_iters=50, step_iters=20, eval_batch=128,
             eval_iters=40, tta_iters=10, val_batches=(4, 4))
BENCH_WINDOWS = 2  # the windows best_of times, as bench.py's
BENCH_MEMORY_SLACK = 2 ** 20  # bytes a released harness may leave allocated


def allocated() -> int:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def prime_streams() -> None:
    """Make the cuBLAS and cuBLASLt workspaces of the current stream and of
    the compiled steps' side stream, which the first product of each kind
    on a stream allocates and the process keeps (32 MiB each on this card):
    phase 21's memory checks then see only what a harness holds."""
    from mpreid_tpu_torch.engine.compiled import side_stream

    device = torch.device(CARD, torch.cuda.current_device())
    for stream in (torch.cuda.current_stream(device), side_stream(device)):
        with torch.cuda.stream(stream):
            for dtype in (torch.bfloat16, torch.float32):
                w = torch.ones(64, 64, device=device, dtype=dtype, requires_grad=True)
                b = torch.ones(64, device=device, dtype=dtype, requires_grad=True)
                x = torch.ones(8, 64, device=device, dtype=dtype)
                F.linear(x, w, b).float().sum().backward()  # addmm (Lt), mm
                torch.bmm(x[None], w[None]).sum().item()
    torch.cuda.synchronize()


def bench_best_of(what: str, run, per_window: dict) -> dict:
    """``benchkit.best_of(run)`` over BENCH_WINDOWS windows after the
    runner's own warm-up; every window's kernel launches (the warm-up's
    too) held to ``per_window``, the counters set to 0 before each."""
    seconds = []

    def counted():
        reset_counts()
        secs = run()
        expect_counts(f"21 {what}, window {len(seconds) + 1}", read_counts(), per_window)
        seconds.append(secs)
        return secs

    counted.warmup = run.warmup
    best = benchkit.best_of(counted, windows=BENCH_WINDOWS)
    return dict(best_s=best, window_s=seconds, warmup_windows=run.warmup,
                launches_per_window={k: per_window.get(k, 0) for k in COUNTED})


def bench_report(case: str, what: str, timing: dict, items: int, unit: str, stats: dict,
                 before: int, extra: dict) -> dict:
    """Phase 21's report of one program: its rate over the best window,
    the capture's seconds and the graph pool's bytes apart from it, and the
    memory allocated before the harness and after its release, which must
    agree to BENCH_MEMORY_SLACK; every compiled runner captured once."""
    after = allocated()
    res = dict(case=case, program=what, rate=items / timing["best_s"], unit=unit,
               items_per_window=items, **timing, graph=stats, allocated_before=before,
               allocated_after_release=after, card=CARD_LINE, **extra)
    log(f"  21 {json.dumps(res)}")
    rate_line(f"21 {case} {what}: best of {BENCH_WINDOWS} windows after "
              f"{timing['warmup_windows']} ({unit})",
              dict(rate=res["rate"], capture_seconds=stats["capture_seconds"],
                   graph_pool_gb=stats["pool_bytes"] / 1e9,
                   allocated_after_release_minus_before=after - before))
    if stats["captures"] != 1 or stats["pool_bytes"] <= 0:
        raise AssertionError(f"21 {case}: not one captured graph: {stats}")
    if after - before > BENCH_MEMORY_SLACK:
        raise AssertionError(f"21 {case}: {after - before} bytes still allocated after release")
    return res


def bench_epochs(cfg, model, stage: str) -> dict:
    """21a / 21b: ``stage1_harness`` + ``epoch_window``, stage 1a or 1b."""
    iters, batch = BENCH["stage1_iters"], BENCH["batch"]
    depth = len(model.text_encoder.transformer.resblocks)
    before = allocated()
    h = benchkit.stage1_harness(cfg, model, stage=stage, iters=iters, batch=batch,
                                num_classes=BENCH["classes"],
                                embed_dim=model.clip_config.embed_dim,
                                random_views=stage == "1b", rng=np.random.RandomState(0))
    timing = bench_best_of(f"stage {stage} epoch", benchkit.epoch_window(h),
                           {"attention_fwd": depth * iters, "attention_bwd": depth * iters,
                            "adam_table": iters})
    steps, losses = int(h["state"].opt_state.step), h["losses"].tolist()
    if steps != len(timing["window_s"]) * iters or not np.isfinite(losses).all():
        raise AssertionError(f"21 stage {stage}: step {steps} after {timing['window_s']} "
                             f"windows of {iters}, losses {losses}")
    stats = benchkit.graph_stats(h)
    benchkit.release(h)
    return bench_report("21a" if stage == "1a" else "21b",
                        f"stage-{stage} epoch window ({iters} × {batch} bank rows, "
                        f"{BENCH['classes']} classes)", timing, iters * batch, "bank rows/s",
                        stats, before, dict(step=steps, last_losses=losses[-3:]))


def bench_steps(case: str, what: str, h, before: int, depth: int) -> dict:
    """21c / 21g: ``step_window`` over a built harness."""
    iters = BENCH["step_iters"]
    timing = bench_best_of(what, benchkit.step_window(h, iters=iters),
                           {"attention_fwd": depth * iters, "attention_bwd": depth * iters,
                            "adam_table": iters})
    steps, loss = int(h["state"].opt_state.step), float(h["metrics"]["loss"])
    if steps != len(timing["window_s"]) * iters or not np.isfinite(loss):
        raise AssertionError(f"21 {case}: step {steps} after {timing['window_s']} windows of "
                             f"{iters}, loss {loss}")
    stats = benchkit.graph_stats(h)
    benchkit.release(h)
    return bench_report(case, f"{what} step window ({iters} steps, batch {BENCH['batch']})",
                        timing, iters * BENCH["batch"], "img/s", stats, before,
                        dict(step=steps, last_loss=loss))


def bench_scan(case: str, what: str, make, cfg, model, iters: int, per_forward: int) -> dict:
    """21d / 21e / 21h: an eval or TTA scan; its timed windows' values equal
    bit for bit, and equal to the same chained forwards run eagerly."""
    before = allocated()
    scan = make(cfg, model, batch=BENCH["eval_batch"], iters=iters, rng=np.random.RandomState(0))
    values = []

    def run():
        values.append(scan())

    run.warmup = scan.warmup
    per_window = {"attention_fwd": per_forward * iters}
    timing = bench_best_of(what, benchkit.timed(run), per_window)
    reset_counts()
    eager = scan.eager()
    expect_counts(f"21 {case} eager window", read_counts(), per_window)
    timed_values = values[-BENCH_WINDOWS:]
    if not (np.isfinite(eager) and all(v == eager for v in timed_values)):
        raise AssertionError(f"21 {case}: window values {values}, eager {eager}")
    stats = benchkit.graph_stats(scan)
    benchkit.release(scan)
    return bench_report(case, f"{what} ({iters} forwards of {BENCH['eval_batch']})", timing,
                        iters * BENCH["eval_batch"], "img/s", stats, before,
                        dict(window_values=values, eager_value=eager,
                             warmup_window_equal=values[0] == eager))


def bench_tta_inference(cfg, model) -> dict:
    """21f: ``do_inference_tta`` over a ``SyntheticValLoader`` (its images
    on the card), timed as bench.py's TTA section."""
    nq, ng = BENCH["val_batches"]
    depth = len(model.image_encoder.transformer.resblocks)
    before = allocated()
    loader = benchkit.SyntheticValLoader(cfg, nq, ng, BENCH["eval_batch"],
                                         rng=np.random.RandomState(3))
    ranks = []

    def run():
        ranks.append(ttpt_engine.do_inference_tta(cfg, model, loader, loader.num_query))

    run.warmup = benchkit.warmup_windows(min(nq, ng))  # the query and plain steps' calls
    timing = bench_best_of("do_inference_tta", benchkit.timed(run),
                           {"attention_fwd": depth * (4 * nq + ng)})
    if len(set(ranks)) != 1 or not all(np.isfinite(ranks[0])):
        raise AssertionError(f"21f: ranks {ranks}")
    steps = [ttpt_engine.cached_tta_query_step(model, cfg),
             processor.cached_eval_step(model, cfg, feat_norm=cfg.TEST.FEAT_NORM == "yes")]
    each = [benchkit.graph_stats(s) for s in steps]
    stats = {k: sum(e[k] for e in each) for k in each[0]}
    stats["captures"] = max(e["captures"] for e in each)  # one a step
    if [e["captures"] for e in each] != [1, 1]:
        raise AssertionError(f"21f: the query and plain steps captured {each}")
    release_eval_steps(model)
    del loader
    return bench_report("21f", f"do_inference_tta over SyntheticValLoader ({nq} + {ng} "
                        f"batches of {BENCH['eval_batch']} on the card)", timing,
                        (nq + ng) * BENCH["eval_batch"], "query + gallery img/s", stats,
                        before, dict(ranks=ranks[0], steps={"tta_query": each[0],
                                                            "plain": each[1]}))


def run_benchkit() -> dict:
    """Phase 21 (module docstring): the port's ``utils/benchkit.py`` at
    bench.py's widths on seeded weights."""
    prime_streams()
    t0 = time.perf_counter()
    cfg, model = benchkit.uniprompt_env(num_classes=BENCH["classes"])
    vdepth = len(model.image_encoder.transformer.resblocks)
    log(f"  21 uniprompt_env: {sum(p.numel() for p in model.parameters())} parameters, "
        f"{cfg.TPU.COMPUTE_DTYPE}, set up in {time.perf_counter() - t0:.1f} s")
    out = {"21a": bench_epochs(cfg, model, "1a"), "21b": bench_epochs(cfg, model, "1b")}
    before = allocated()
    h = benchkit.stage2_harness(cfg, model, num_classes=BENCH["classes"], batch=BENCH["batch"],
                                embed_dim=model.clip_config.embed_dim)
    out["21c"] = bench_steps("21c", "stage-2a", h, before, vdepth)
    out["21d"] = bench_scan("21d", "ViT-B/16 eval scan", benchkit.make_eval_scan, cfg, model,
                            BENCH["eval_iters"], vdepth)
    out["21e"] = bench_scan("21e", "TTA scan", benchkit.make_tta_scan, cfg, model,
                            BENCH["tta_iters"], 4 * vdepth)
    out["21f"] = bench_tta_inference(cfg, model)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, model = benchkit.rn50_env(num_classes=BENCH["classes"])
    log(f"  21 rn50_env: {sum(p.numel() for p in model.parameters())} parameters, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    before = allocated()
    h = benchkit.baseline_harness(cfg, model, num_classes=BENCH["classes"], batch=BENCH["batch"])
    out["21g"] = bench_steps("21g", "RN50 baseline", h, before, 0)
    out["21h"] = bench_scan("21h", "RN50 eval scan", benchkit.make_eval_scan, cfg, model,
                            BENCH["eval_iters"], 0)
    del model
    torch.cuda.empty_cache()
    return out


def expect_dp_counts(what: str, run: dict, want: dict) -> None:
    """A spawned rank's launch counts as ``want`` says (0 where it says
    nothing), every attention launch on "tc" (the runs are bf16)."""
    got = run["launches"]
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
    routes = run["launches_by_route"]
    for name, by_route in routes.items():
        if by_route != {r: got[name] if r == "tc" else 0 for r in attn.ROUTES}:
            raise AssertionError(f"{what}: attention launches by route {routes}")


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
    hard_ptxas = batch_hard_ptxas()

    log("kernels against their plain versions on the card:")
    rows, bwd_rows = [], []
    cases = [(VISION, torch.bfloat16), (VISION, torch.float32), (TEXT, torch.bfloat16),
             (TEXT, torch.float32), (VEHICLE, torch.bfloat16), (SYSU, torch.float32),
             (VEHICLE, torch.float32), (STRIDE12, torch.bfloat16), (STRIDE12, torch.float32),
             (TTPT_TEXT, torch.bfloat16), (VISION_TP, torch.bfloat16), (TEXT_TP, torch.bfloat16),
             (LONG64, torch.bfloat16), (LONG128, torch.bfloat16)]
    t0 = time.perf_counter()
    for case, dtype in cases:
        for layout in attn.LAYOUTS:
            timed_here = (layout == "packed" or case is VISION and dtype == torch.bfloat16) \
                and case not in (LONG64, LONG128)
            rows.append(check_attention(case, dtype, layout, timed=timed_here))
            bwd_rows.append(check_attention_bwd(case, dtype, layout, timed=timed_here))
    log(f"  attention kernels {time.perf_counter() - t0:.1f} s")
    adam_rows = [check_adam(md, decoupled, timed=md == torch.float32 and not decoupled)
                 for md in (torch.float32, torch.bfloat16) for decoupled in (False, True)]
    table_row = check_adam_table()
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
    vehicle_res, _ = run_vehicle_train()
    log("vehicle training slice at MODEL.STRIDE_SIZE [12, 12] (256×256, L 442), full width:")
    t0 = time.perf_counter()
    stride12_res, stride12_model = run_vehicle_train(VERI_STRIDE12, STRIDE12)
    stride12_res["checks"] = run_stride12(stride12_model)
    del stride12_model
    torch.cuda.empty_cache()
    log(f"  stride-12 phase seconds {time.perf_counter() - t0:.1f}")

    log("cross-checks:")
    t0 = time.perf_counter()
    reset_counts()
    cross_checks(model)
    train_cross_checks(train_res.pop("model"))
    fp32_routes = read_routes()
    if not all(fp32_routes[name]["tf32x3"] > 0 for name in ROUTED):
        raise AssertionError(f"the fp32 checks launched no fp32 attention kernel: {fp32_routes}")
    log(f"  cross-check phase seconds {time.perf_counter() - t0:.1f}, launches by route "
        f"{json.dumps(fp32_routes)}")
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
    log(f"  TTA / TTPT phase seconds {time.perf_counter() - t0:.1f}")
    log("compiled TTA / TTPT steps (19a Option A, 19b Option B) as CUDA graphs against their "
        "eager bodies, on phase 12's model:")
    t0 = time.perf_counter()
    ttpt_graph_res = run_compiled_ttpt(uni_model)
    del uni_model
    log(f"  compiled TTA / TTPT phase seconds {time.perf_counter() - t0:.1f}")
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

    log("compiled epochs (17a stage 1, 17b ViT device epoch, 17c MoE 2a/2b, 17d remat) as "
        "CUDA graphs against the step loop, full width:")
    t0 = time.perf_counter()
    market_loader = epoch_res.pop("loader")
    graph_res = run_compiled_epochs(market_loader, epoch_res.pop("data"))
    torch.cuda.empty_cache()
    log(f"  compiled-epoch phase seconds {time.perf_counter() - t0:.1f}")

    log("compiled steps (18a run_validation, 18b the bank and the text features, 18c the "
        "host-loader train step, 18d stage 1's trailing step) as CUDA graphs against their "
        "eager bodies, full width:")
    t0 = time.perf_counter()
    step_res = run_compiled_steps(market_loader)
    del market_loader
    torch.cuda.empty_cache()
    log(f"  compiled-step phase seconds {time.perf_counter() - t0:.1f}")

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

    log("data parallelism over torch.distributed (14a NCCL at world 1; 14b–e two ranks "
        "sharing the card over gloo), full width:")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    dp_res = run_data_parallel(dp_plan())
    expect_dp_counts("14a world 1", dp_res["14a"], {
        "attention_fwd": 12 * dp_res["14a"]["steps"], "attention_bwd": 12 * dp_res["14a"]["steps"],
        "adam_table": dp_res["14a"]["steps"]})
    log(f"  data-parallel phase seconds {time.perf_counter() - t0:.1f}")

    log("the model axis, GPipe and the sharded sparse re-ranking (15a-b, d-e: ranks sharing "
        "the card over gloo; 15c: dryrun_multichip over four):")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mp_res = run_model_axis(dp_plan())
    log(f"  model-axis phase seconds {time.perf_counter() - t0:.1f}")

    log("TPU.REMAT and TPU.ASYNC_CHECKPOINT (16a vit_base.yml and veri/vit_base.yml, 16b MoE "
        "stage 2b, 16c do_train with checkpoints), full width:")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    remat_res = {"16a": run_remat_vision(VIT_BASE, NUM_CLASSES, 6, HW, REMAT_STEPS,
                                         "configs/person/vit_base.yml", args.profile),
                 "16a_vehicle": run_remat_vision(VERI, VEHICLE_CLASSES, VEHICLE_CAMERAS,
                                                 VEHICLE_HW, VEHICLE_STEPS,
                                                 "configs/veri/vit_base.yml", args.profile),
                 "16b": run_remat_moe()}
    with tempfile.TemporaryDirectory() as tmp:
        async_res = run_async_checkpoint(tmp)
    log(f"  remat and async-checkpoint phase seconds {time.perf_counter() - t0:.1f}")

    log("from image files (20a decode, 20b the host-loader train step, 20c run_validation, "
        "20d the native re-ranker, 20e the device-resident set), DATALOADER.NATIVE_DECODE off "
        "and on, full width:")
    t0 = time.perf_counter()
    files_res = run_from_files()
    log(f"  from-files phase seconds {time.perf_counter() - t0:.1f}")

    log("the measured programs of mpreid_tpu_torch/utils/benchkit.py at bench.py's widths (21a-b "
        "stage-1 epochs, 21c stage-2a steps, 21d-e eval and TTA scans, 21f do_inference_tta, "
        "21g-h RN50), best of 2 windows after each runner's warm-up:")
    t0 = time.perf_counter()
    bench_res = run_benchkit()
    log(f"  benchkit phase seconds {time.perf_counter() - t0:.1f}")

    def timing(row):
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    def files_launches(name):
        """Phase 20's launches of kernel ``name`` on the PIL side (0 where a
        sub-phase did not run): a replayed train step, one run_validation
        over the files, the two dense re-rankings of 20d."""
        b, c, d = (files_res.get(k) for k in ("20b", "20c", "20d"))
        return {"per_replayed_train_step": b["traced"]["pil"]["launches_per_replay_traced"][name]
                if b else 0, "run_validation": c["launches"][name] if c else 0,
                "rerank_20d": sum(d[k]["launches"][name] for k in ("clustered", "features_20c"))
                if d else 0}

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
            "launches_vehicle_stride12": {
                "train_steps": stride12_res["launches"][name],
                "do_inference": stride12_res["checks"]["eval_launches"]
                if direction == "fwd" else 0},
            "launches_device_epoch_do_train": epoch_res["res"]["launches"][name],
            "launches_per_replayed_step": {k: v["launches_per_replayed_step"][name]
                                           for k, v in graph_res.items()},
            "launches_per_replayed_compiled_step": {k: v["launches_per_replayed_step"][name]
                                                    for k, v in step_res.items()},
            "launches_per_replayed_ttpt_step": {k: v["launches_per_replayed_step"][name]
                                                for k, v in ttpt_graph_res.items()},
            "launches_moe": {k: moe_res[k]["launches"][name]
                             for k in ("stage2a", "stage2b", "inference")},
            "launches_from_files": files_launches(name),
            "launches_benchkit_per_window": {k: v["launches_per_window"][name]
                                             for k, v in bench_res.items()},
            "launches_rn50_uniprompt": {k: v[name] for k, v in rn50_uni["launches"].items()},
            "launches_ttpt": {k: ttpt_res[k]["launches"][name] for k in ("tta", "ttpt")},
            "launches_margin": {k: margin_res[k]["launches"][name] for k in MARGIN_KINDS},
            "launches_data_parallel": {
                "nccl_world_one_step": dp_res["14a"]["launches"][name],
                "per_rank_dp_step": dp_res["14b"]["bf16"]["launches"][name] // (1 + DP_TIMED_STEPS),
                "per_rank_zero_3_steps": dp_res["14c"]["launches"][0][name]},
            "launches_remat": {
                "vision_step_off": remat_res["16a"]["launches_one_step"]["off"][name],
                "vision_step_on": remat_res["16a"]["launches_one_step"]["on"][name],
                "vehicle_step_on": remat_res["16a_vehicle"]["launches_one_step"]["on"][name],
                "moe_2b_step_on": remat_res["16b"]["launches"]["on"][name],
                "do_train_epoch_async_checkpoint": async_res["async"]["launches"][name]},
            "launches_model_axis": {
                "per_rank_tp_step_bf16": mp_res["15a"]["launches"][0][name] // (1 + TP_TIMED_STEPS),
                "per_rank_tp_step_routes": mp_res["15a"]["launches"],
                "per_stage_gpipe_fp32": [r["launches"][name] for r in mp_res["15d"]["ranks"]],
                "per_rank_dryrun_fp32": {r: v[name] for r, v in mp_res["15c"]["launches"].items()}},
            "max_abs_err": max(r["max_abs_err"] for r in bf16),
            **timing(pick(found, "vision")),
            "shape": "B64 L129 12x64 bf16 packed, no mask",
            "text": timing(pick(found, "text")),
            "vehicle": timing(pick(found, "vehicle")),
            "stride12": {"shape": "B64 L442 12x64 bf16 packed, no mask (the backward "
                                  "streams it)", **timing(pick(found, "stride12"))},
            "ttpt_text": {"shape": "B1000 L77 8x64 bf16 packed, causal",
                          **timing(pick(found, "ttpt_text"))},
            "vision_tp": {"shape": "B64 L129 6x64 bf16 packed, no mask (a rank's heads at "
                                   "model 2)", **timing(pick(found, "vision_tp"))},
            "text_tp": {"shape": "B64 L77 4x64 bf16 packed, causal (a rank's heads at model 2)",
                        **timing(pick(found, "text_tp"))},
            "ptxas": ptxas[f"{name}_tc"],
        }

    def fp32_entry(direction, found):
        """The fp32 kernel of ``direction`` (route "tf32x3"): launched by the
        fp32 card-vs-CPU checks of phase 6, not by the bf16 main path."""
        name = f"attention_{direction}"
        fp32 = [r for r in found if r["dtype"] == "float32"]
        return {
            "name": f"fused_attention_{direction}_fp32",
            "route": "cuda",
            "source": f"mpreid_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": "mpreid_tpu/ops/attention.py:" + ("229" if direction == "fwd" else "250"),
            "also_replaces": "mpreid_tpu/ops/attention.py:" + ("488" if direction == "fwd"
                                                               else "514"),
            "launches": fp32_routes[name]["tf32x3"],
            "launches_from": "the fp32 eval and train-step checks on the card (phase 6)",
            "launches_model_axis": {
                "per_stage_gpipe_fp32": [r["launches"][name] for r in mp_res["15d"]["ranks"]],
                "per_rank_dryrun_fp32": {r: v[name] for r, v in mp_res["15c"]["launches"].items()}},
            "max_abs_err": max(r["max_abs_err"] for r in fp32),
            "bit_equal_repeats": all(r["bit_equal_repeat"] for r in fp32),
            **timing(pick(found, "vision", "float32")),
            "bound_tc_ms": pick(found, "vision", "float32")["bound_tc_ms"],
            "shape": "B64 L129 12x64 fp32 packed, no mask",
            **{case: {**timing(pick(found, case, "float32")),
                      "bound_tc_ms": pick(found, case, "float32")["bound_tc_ms"]}
               for case in ("text", "sysu", "vehicle", "stride12")},
            "ptxas": ptxas[name],
        }

    train_counts = train_res["train"]["launches"]
    uni_launches = {"stage1a_epoch": uni_res["stage1a"]["launches"],
                    "stage2a_steps": uni_res["stage2a"]["launches"]}
    kernels = [attention_entry("fwd", rows), attention_entry("bwd", bwd_rows),
               fp32_entry("fwd", rows), fp32_entry("bwd", bwd_rows), {
        "name": "fused_adam_leaf",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/adam.cu",
        "replaces": "mpreid_tpu/ops/adam_kernel.py:60",
        "launches": train_res["fused"]["launches"]["adam"],
        "launches_margin": margin_res[MARGIN_KINDS[-1]]["launches"]["adam"],
        "launches_data_parallel": {
            "per_rank_fused_dp_step": dp_res["14b"]["fused"]["launches"]["adam"],
            "per_rank_zero_slices_3_steps": dp_res["14c"]["launches"][0]["adam"]},
        "launches_model_axis": {"per_rank_fused_tp_step": mp_res["15a"]["adam_launches"]},
        "launches_per_replayed_step": graph_res["17b_vit_fused_adam_on"][
            "launches_per_replayed_step"]["adam"],
        "launches_per_replayed_compiled_step": step_res["18c_vit_fused_adam_on"][
            "launches_per_replayed_step"]["adam"],
        "launches_from_files": files_launches("adam"),
        "launches_benchkit_per_window": {k: v["launches_per_window"]["adam"]
                                         for k, v in bench_res.items()},
        "bit_equal_repeats": all(r["bit_equal_repeat"] for r in adam_rows),
        "scalars": "[lr*mult, 1-b1^t, 1-b2^t] fp32, read from device memory",
        "max_abs_err": max(r["max_abs_err"] for r in adam_rows),
        **timing(adam_rows[0]),
        "shape": "c_fc leaf 3072x768 fp32, fp32 moments, Adam (coupled L2)",
    }, {
        "name": "adam_leaves",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/adam.cu",
        "kernel": "multi_adam_kernel",
        "replaces": "mpreid_tpu/ops/adam_kernel.py:60",
        "launches": train_res["train"]["launches"]["adam_table"],
        "leaves": train_res["train"]["table_leaves"],
        "launches_fused_adam_steps": train_res["fused"]["launches"]["adam_table"],
        "leaves_fused_adam_steps": train_res["fused"]["table_leaves"],
        "launches_stage2a_steps": uni_res["stage2a"]["launches"]["adam_table"],
        "leaves_stage2a_steps": uni_res["stage2a"]["table_leaves"],
        "launches_per_replayed_step": {k: v["launches_per_replayed_step"]["adam_table"]
                                       for k, v in graph_res.items()},
        "leaves_per_replayed_step": {k: v["table_leaves_per_replay"]
                                     for k, v in graph_res.items()
                                     if "table_leaves_per_replay" in v},
        "launches_per_replayed_compiled_step": {
            k: v["launches_per_replayed_step"]["adam_table"] for k, v in step_res.items()},
        "leaves_per_replayed_compiled_step": {k: v["table_leaves_per_replay"]
                                              for k, v in step_res.items()
                                              if "table_leaves_per_replay" in v},
        "launches_data_parallel": {
            "per_rank_dp_step": dp_res["14b"]["bf16"]["launches"]["adam_table"]
            // (1 + DP_TIMED_STEPS),
            "per_rank_zero_slices_3_steps": dp_res["14c"]["launches"][0]["adam_table"]},
        "launches_from_files": files_launches("adam_table"),
        "launches_benchkit_per_window": {k: v["launches_per_window"]["adam_table"]
                                         for k, v in bench_res.items()},
        "bit_equal_per_op": table_row["table_bit_equal_per_op"],
        "per_leaf_route_bit_equal_per_op": table_row["per_leaf_route_bit_equal_per_op"],
        **timing(table_row),
        "per_leaf_route_ms": table_row["per_leaf_route_ms"],
        "shape": f"stage 2a's {table_row['leaves']} trainable leaves ({table_row['elements']} "
                 "elements) fp32, fp32 moments, Adam (coupled L2), lr multipliers 1 and 2",
    }, {
        "name": "l1_cross",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/pairwise_cross.cu",
        "replaces": "mpreid_tpu/ops/pallas_kernels.py:192",
        "launches": entry_res["launches"]["l1_cross"],
        "launches_market_dense": market_res["launches"]["l1_cross"],
        "launches_from_files": files_launches("l1_cross"),
        "launches_dryrun": {r: v["l1_cross"] for r, v in mp_res["15c"]["launches"].items()},
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
        "launches_sparse_sharded": [r["launches"]["minsum_cross"] for r in mp_res["15e"]["ranks"]],
        "launches_dryrun": {r: v["minsum_cross"] for r, v in mp_res["15c"]["launches"].items()},
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
        "floor_ms": hard_rows[0]["floor_ms"],
        "library": hard_rows[0]["library"],
        "shape": f"PK batch {HARD['b']} x {HARD['d']} fp32 (feats[1]), labels 16 x 4",
        "timed_batches": {f"b{r['shape'][0]}": {**timing(r), "floor_ms": r["floor_ms"],
                                                 "smem_bytes": r["smem_bytes"],
                                                 "shape_ms": r["shape_ms"]}
                          for r in hard_rows if "ms" in r},
        "ptxas": hard_ptxas,
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
