"""Smoke run of the PyTorch port (mpreid_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the exit code is not 0:

1. the card's name and power limit, torch and CUDA versions (no card: fail);
2. build every CUDA kernel from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main path, with the stated tolerance, and its times: the kernel,
   the plain version, one library call computing the same function, and the
   bound (the least time the card could take for the same work);
4. the baseline eval path (ViT-B/16, 256×128, bf16, batch 64) at full width
   on seeded random weights through ``engine.processor.do_inference``,
   counting the kernel's launches in that run;
5. cross-checks: fp32 on the card against fp32 on the CPU, and bf16 against
   fp32 on the card.

The last two lines of standard output are one JSON object with the kernels'
numbers and one with the run's verdict and device. ``--profile`` adds a
``torch.profiler`` breakdown of three eval batches by kernel and the
device's idle share over one traced ``do_inference`` run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import do_inference, make_eval_step
from mpreid_tpu_torch.kernels import build
from mpreid_tpu_torch.models import build_model, make_model
from mpreid_tpu_torch.ops import attention as attn

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 and bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

QUERY, GALLERY, BATCH, HW = 128, 128, 64, (256, 128)
RUNS = 10  # timed do_inference runs of the slice
VISION = dict(name="vision", b=BATCH, l=129, heads=12, dh=64, masked=False)
TEXT = dict(name="text", b=BATCH, l=77, heads=8, dh=64, masked=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def vit_base_cfg(dtype: str = "bfloat16", device: str = "cuda"):
    """configs/person/vit_base.yml's eval settings, built in code (no yaml)."""
    cfg = get_default_cfg()
    cfg.MODEL.DEVICE = device
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.MODEL.STRIDE_SIZE = [16, 16]
    cfg.INPUT.SIZE_TRAIN = list(HW)
    cfg.INPUT.SIZE_TEST = list(HW)
    cfg.INPUT.PIXEL_MEAN = [0.5, 0.5, 0.5]
    cfg.INPUT.PIXEL_STD = [0.5, 0.5, 0.5]
    cfg.TEST.IMS_PER_BATCH = BATCH
    cfg.TEST.NECK_FEAT = "before"
    cfg.TEST.FEAT_NORM = "yes"
    cfg.TEST.RE_RANKING = False
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
    fwd_ms = cuda_ms(lambda: step(batch), runs=20)
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

    log("baseline eval slice, ViT-B/16 at full width:")
    model, slice_res = run_slice(args.profile)

    log("cross-checks:")
    cross_checks(model)

    main_row = rows[0]
    kernels = [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "mpreid_tpu_torch/kernels/csrc/attention_fwd.cu",
        "replaces": "mpreid_tpu/ops/attention.py:229",
        "also_replaces": "mpreid_tpu/ops/attention.py:488",
        "launches": slice_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "B64 L129 12x64 bf16 packed, no mask",
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
