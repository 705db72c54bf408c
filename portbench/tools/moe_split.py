"""The device time of a stage-2b step of the MoE cell, split by the part
of the MoE that launched each kernel: the router (``moe.route``), the
experts (``moe.experts``), the mix (``moe.mix``), the aux loss
(``moe.aux``), the rest of the MoE blocks (their attention and LayerNorms)
and everything else. A one-off reading for PERF.md, not a metric.

    python3 portbench/tools/moe_split.py --workload vitb16-moe.stage2b --seed <n> \
        [--steps 3] [--out split.jsonl]

The steps run eagerly (the step's body, ``engine/steps.py::
_make_step_body``, with no graph: inside a replay only kernel names tell its
parts apart) under ``torch.profiler``, after two warm-up steps. A kernel
belongs to the innermost labelled host interval its launch lies in, on the
launching thread: a forward span of the port (``utils/tracing.py``; the MoE
blocks wrapped in a span of the tool's, ``moe_split.block``), or in the
backward an autograd function whose forward op ran inside such a span
(matched by the op's sequence number and thread). Prints one JSON line
(also appended to ``--out``): the steps' device seconds, each part's seconds
and share, and the card."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

PARTS = ("moe.route", "moe.experts", "moe.mix", "moe.aux", "moe_split.block")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel")
BACKWARD = "autograd::engine::evaluate_function: "


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def labelled_intervals(events):
    """{thread: [(start, end, label)]}: the forward spans and, in the
    backward, each autograd function whose forward ran inside one."""
    host = [e for e in events if not _is_device(e)]
    spans = {}
    for e in host:
        if e.name() in PARTS:
            spans.setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns(), e.name()))
    forward = {}  # (thread, sequence number) → the innermost span over the op
    for e in host:
        seq = e.sequence_nr()
        if seq < 0 or e.name().startswith(BACKWARD) or e.name() in PARTS:
            continue
        label = innermost(spans.get(e.start_thread_id(), ()), e.start_ns())
        if label is not None:
            forward[e.start_thread_id(), seq] = label
    out = {t: list(v) for t, v in spans.items()}
    for e in host:
        if e.name().startswith(BACKWARD):
            label = forward.get((e.fwd_thread_id(), e.sequence_nr()))
            if label is not None:
                out.setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns(), label))
    return out


def innermost(intervals, t: int):
    best = None
    for lo, hi, label in intervals:
        if lo <= t < hi and (best is None or lo >= best[0]):
            best = (lo, label)
    return None if best is None else best[1]


def kernels(events, lo: int, hi: int):
    """[(seconds, launching thread, launch time)] of the kernels that start
    in [lo, hi]."""
    launches = {e.correlation_id(): e for e in events
                if not _is_device(e) and e.name() in LAUNCHES}
    return [((e.end_ns() - e.start_ns()) / 1e9, launches[e.correlation_id()].start_thread_id(),
             launches[e.correlation_id()].start_ns())
            for e in events if _is_device(e) and e.correlation_id() in launches
            and lo <= e.start_ns() <= hi]


def split(events, lo: int, hi: int) -> dict:
    intervals = labelled_intervals(events)
    seconds = {}
    for s, thread, t in kernels(events, lo, hi):
        label = innermost(intervals.get(thread, ()), t) or "other"
        seconds[label] = seconds.get(label, 0.0) + s
    total = sum(seconds.values())
    names = {"moe.route": "router", "moe.experts": "experts", "moe.mix": "mix",
             "moe.aux": "aux", "moe_split.block": "moe_blocks_rest", "other": "other"}
    return {"device_s": total,
            "seconds": {names[k]: v for k, v in seconds.items()},
            "share_pct": {names[k]: 100.0 * v / total for k, v in seconds.items()} if total
            else {}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="vitb16-moe.stage2b")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpreid_tpu_torch.engine.steps import _make_step_body
    from mpreid_tpu_torch.engine.train_state import initial_state
    from mpreid_tpu_torch.engine.uniprompt import precompute_text_features
    from mpreid_tpu_torch.losses import make_loss
    from mpreid_tpu_torch.solver import make_optimizer
    from mpreid_tpu_torch.utils.tracing import span

    from portbench.data import images, pk
    from portbench.harness import manifest, port, runner

    if not torch.cuda.is_available():
        print("moe_split: needs a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.Cell(args.workload)
    ctx = runner.context(cell, args.seed, "cuda")
    t, cfg = ctx.traffic, ctx.cfg
    model, _ = port.build(ctx, True)
    text = precompute_text_features(cfg, model, t["classes"])
    loss_fn, _ = make_loss(cfg, t["classes"])
    opt = make_optimizer(port.node_at(cfg, t["solver"]), model, stage=t["stage"])
    state = initial_state(model, opt)
    opt.set_lr(state.opt_state, float(t["lr"]))
    body = _make_step_body(model, cfg, loss_fn, opt, None, None, True, text)
    data = images.train_set(t["images"], t["classes"], tuple(cfg.INPUT.SIZE_TRAIN),
                            ctx.streams["images"], ctx.device)
    rows = pk.Rows(images.identity_layout(t["images"], t["classes"]), t["batch"],
                   t["instances"], ctx.streams["order"] % 2 ** 31)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.streams["augment"])
    blocks = model.image_encoder.transformer.resblocks[:cfg.MODEL.MOE.MOE_LAYERS]
    opened = []

    def enter(module, args):
        opened.append(span("moe_split.block"))
        opened[-1].__enter__()

    def leave(module, args, out):
        opened.pop().__exit__(None, None, None)

    for b in blocks:
        b.register_forward_pre_hook(enter)
        b.register_forward_hook(leave)

    def step():
        idx = torch.from_numpy(rows.take(1)[0]).to(ctx.device)
        body(state, data[0].index_select(0, idx), data[1].index_select(0, idx), None, None, gen)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lo = time.time_ns()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        hi = time.time_ns()
        time.sleep(0.05)  # the profiler keeps only device records that end inside it
    line = dict(workload=cell.name, seed=args.seed, steps=args.steps,
                card=torch.cuda.get_device_name(ctx.device),
                **split(prof.profiler.kineto_results.events(), lo, hi))
    text_line = json.dumps(line)
    print(text_line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text_line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
