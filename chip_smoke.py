"""Smoke run of the PyTorch port (mpreid_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the exit code is not 0:

1. the card's name and power limit, torch and CUDA versions (no card: fail);
2. build every CUDA kernel from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main paths, with the stated tolerance, and its times: the kernel,
   the plain version, one library call computing the same function, and the
   bound (the least time the card could take for the same work): the
   attention forward and backward (vision and text shapes, both layouts)
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
   Adam kernel's launches, and one fused update against the plain one;
6. cross-checks: eval features and a train step's loss and gradients in
   fp32 on the card against fp32 on the CPU, and bf16 against fp32 on the
   card.

The last two lines of standard output are one JSON object with the kernels'
numbers and one with the run's verdict and device. ``--profile`` adds
``torch.profiler`` breakdowns by kernel of three eval batches and of three
train steps, and the device's idle share over one traced ``do_inference``
run and over the traced train steps.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data.loader import ImageBatcher, TrainLoader
from mpreid_tpu_torch.data.sampler import RandomIdentitySampler
from mpreid_tpu_torch.engine import (
    do_inference, do_train, initial_state, loss_and_grads, make_eval_step, make_train_step,
)
from mpreid_tpu_torch.kernels import build
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import build_model, make_model
from mpreid_tpu_torch.ops import adam
from mpreid_tpu_torch.ops import attention as attn
from mpreid_tpu_torch.ops.augment import eval_preprocess
from mpreid_tpu_torch.solver import make_optimizer, make_scheduler

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 and bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def header() -> None:
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


def vit_base_cfg(dtype: str = "bfloat16", device: str = "cuda"):
    """configs/person/vit_base.yml's settings (as train.py takes them), on
    ``device`` in ``dtype``, writing no files."""
    cfg = get_default_cfg()
    cfg._merge_dict(VIT_BASE)
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
    attn.fused_attention.launches = 0
    seconds = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        r1, r5 = do_inference(cfg, model, loader, QUERY)  # ends in a host copy of the metrics
        seconds.append(time.perf_counter() - t0)
    launches = attn.fused_attention.launches
    depth = len(model.image_encoder.transformer.resblocks)
    if launches != depth * n_batches * RUNS:
        raise AssertionError(
            f"{launches} attention launches, expected {depth} × {n_batches} × {RUNS}")
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
    with profile(activities=acts) as prof_run:
        t0 = time.perf_counter()
        do_inference(cfg, model, loader, QUERY)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof_run)
    idle = dict(do_inference_wall_ms_traced=wall_ms, device_busy_ms=busy,
                device_idle_share=1 - busy / wall_ms)
    log("profile of 3 eval batches (bf16, batch 64):\n" + table)
    log(f"idle {json.dumps(idle)}")


class MemoryBatcher(ImageBatcher):
    """``ImageBatcher`` over uint8 images held in memory (record i is image i),
    so ``TrainLoader`` and the PK sampler run unchanged."""

    def __init__(self, images: np.ndarray, pids: np.ndarray, batch_size: int):
        records = [(str(i), int(p), 0, 0) for i, p in enumerate(pids)]
        super().__init__(records, images.shape[1:3], batch_size, num_workers=4)
        self.images = images

    def _decode(self, rec):
        return self.images[int(rec[0])]


def train_images(seed: int = 2):
    """Seeded uint8 train set: TRAIN_IDS identities × TRAIN_IMGS_PER_ID images,
    a per-identity pattern plus per-image noise."""
    rng = np.random.default_rng(seed)
    h, w = HW
    bases = rng.integers(40, 215, (TRAIN_IDS, h, w, 3), dtype=np.int16)
    pids = np.repeat(np.arange(TRAIN_IDS), TRAIN_IMGS_PER_ID)
    noise = rng.integers(-60, 61, (len(pids), h, w, 3), dtype=np.int16)
    return np.clip(bases[pids] + noise, 0, 255).astype(np.uint8), pids.astype(np.int32)


def pk_batches(images, pids, n: int, ids: int = P_IDS, seed: int = 3) -> list:
    """``n`` PK batches (``ids`` identities × K_INST images) on the card."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        chosen = rng.choice(TRAIN_IDS, ids, replace=False)
        idx = np.concatenate([rng.choice(np.flatnonzero(pids == i), K_INST, replace=False)
                              for i in chosen])
        zeros = torch.zeros(len(idx), dtype=torch.int32, device=CARD)
        out.append({"images": torch.from_numpy(images[idx]).to(CARD),
                    "pids": torch.from_numpy(pids[idx]).to(CARD), "camids": zeros,
                    "trackids": zeros})
    return out


def reset_counts() -> None:
    attn.fused_attention.launches = 0
    attn.fused_attention_bwd.launches = 0
    adam.fused_adam_leaf.launches = 0


def read_counts() -> dict:
    return {"attention_fwd": attn.fused_attention.launches,
            "attention_bwd": attn.fused_attention_bwd.launches,
            "adam": adam.fused_adam_leaf.launches}


def expect_counts(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")


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
    log(f"idle {json.dumps(dict(train_steps_wall_ms_traced=wall_ms, device_busy_ms=busy, device_idle_share=1 - busy / wall_ms))}")


def train_cross_checks(model) -> dict:
    """A train step's loss and gradients, augmentation off, batch of 2 × 4,
    from the same weights: fp32 on the card against fp32 on the CPU (each
    leaf norm-relative, floored at 1e-3 of the largest leaf), and bf16
    against fp32 on the card (cosine on every leaf of at least
    MIN_FUSED_SIZE elements)."""
    from mpreid_tpu_torch.engine.steps import augment_args
    from mpreid_tpu_torch.ops.augment import train_augment

    images, pids = train_images(seed=5)
    batch = pk_batches(images, pids, 1, ids=CHECK_BATCH // K_INST, seed=6)[0]
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = {}
    for name, dtype, device in (("fp32_cpu", "float32", "cpu"), ("fp32_cuda", "float32", CARD),
                                ("bf16_cuda", "bfloat16", CARD)):
        c = vit_base_cfg(dtype, device)
        c.INPUT.PROB, c.INPUT.PADDING, c.INPUT.RE_PROB = 0.0, 0, 0.0
        m = build_model(c, NUM_CLASSES, 6, 1)
        m.load_state_dict(weights, strict=True)
        m = m.to(device)
        loss_fn, _ = make_loss(c, NUM_CLASSES)
        opt = make_optimizer(c.SOLVER, m, stage="baseline")
        x = train_augment(batch["images"].to(device), torch.Generator(device=device),
                          **augment_args(c))
        loss, _, grads, _ = loss_and_grads(m, c, loss_fn, opt, x, batch["pids"].to(device).long())
        out[name] = (float(loss), {k: g.float().cpu() for k, g in grads.items()})
        del m
    (l_cpu, g_cpu), (l_gpu, g_gpu), (_, g_bf16) = out["fp32_cpu"], out["fp32_cuda"], out["bf16_cuda"]
    floor = 1e-3 * max(g.norm().item() for g in g_cpu.values())
    grad_err = max((g_gpu[k] - g).norm().item() / max(g.norm().item(), floor)
                   for k, g in g_cpu.items())
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    t_start = time.perf_counter()

    header()

    log("build:")
    secs = build.build(verbose=True)
    log(f"  built {json.dumps(secs)} (seconds per source, 0 = already built)")

    log("kernels against their plain versions on the card:")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for layout in attn.LAYOUTS:
            rows.append(check_attention(VISION, dtype, layout, timed=dtype == torch.bfloat16))
    for layout in attn.LAYOUTS:
        rows.append(check_attention(TEXT, torch.bfloat16, layout, timed=layout == "packed"))
    bwd_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for layout in attn.LAYOUTS:
            bwd_rows.append(check_attention_bwd(VISION, dtype, layout,
                                                timed=dtype == torch.bfloat16))
    for layout in attn.LAYOUTS:
        bwd_rows.append(check_attention_bwd(TEXT, torch.bfloat16, layout,
                                            timed=layout == "packed"))
    adam_rows = [check_adam(md, decoupled, timed=md == torch.float32 and not decoupled)
                 for md in (torch.float32, torch.bfloat16) for decoupled in (False, True)]

    log("baseline eval slice, ViT-B/16 at full width:")
    reset_counts()
    model, slice_res = run_slice(args.profile)

    log("baseline training slice, ViT-B/16 at full width:")
    train_res = run_train(args.profile)

    log("cross-checks:")
    cross_checks(model)
    del model
    train_cross_checks(train_res["model"])

    def timing(row):
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    train_counts = train_res["train"]["launches"]
    kernels = [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/attention_fwd.cu",
        "replaces": "mpreid_tpu/ops/attention.py:229",
        "also_replaces": "mpreid_tpu/ops/attention.py:488",
        "launches": train_counts["attention_fwd"],
        "launches_eval": slice_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
        **timing(rows[0]),
        "shape": "B64 L129 12x64 bf16 packed, no mask",
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/attention_bwd.cu",
        "replaces": "mpreid_tpu/ops/attention.py:250",
        "also_replaces": "mpreid_tpu/ops/attention.py:514",
        "launches": train_counts["attention_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        **timing(bwd_rows[0]),
        "shape": "B64 L129 12x64 bf16 packed, no mask",
    }, {
        "name": "fused_adam_leaf",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/adam.cu",
        "replaces": "mpreid_tpu/ops/adam_kernel.py:60",
        "launches": train_res["fused"]["launches"]["adam"],
        "max_abs_err": max(r["max_abs_err"] for r in adam_rows),
        **timing(adam_rows[0]),
        "shape": "c_fc leaf 3072x768 fp32, fp32 moments, Adam (coupled L2)",
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
