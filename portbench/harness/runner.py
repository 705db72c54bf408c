"""One run of one cell: set-up, the measured window (or the traced
segment), the comparison with the reference, the result's last line.

``main`` is the command line; ``execute`` the run itself, which the CPU
tests drive without a card (``device="cpu"``, with ``overrides`` that shrink
the cell).

The window runs the program's unit of work back to back, stops at the
first unit end after ``--seconds`` and divides the items of every unit by
the time from the first unit's start to the last unit's end. ``setup_s``
is the time from the process's start to the window's, less the seconds the
program spent keeping what the comparison needs (``check_seconds``)."""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from . import manifest, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mpreid_tpu")
TRACE_SECONDS = 3.0  # the traced segment's length: a bounded part of a window


def forbidden_modules(modules=None) -> List[str]:
    """The top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``mpreid_tpu_torch`` is another name)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def merge(node, values: dict) -> None:
    """Set ``values`` (nested dicts) on a config node."""
    for key, value in values.items():
        if isinstance(value, dict):
            merge(node[key], value)
        else:
            node[key] = value


@dataclass
class Context:
    """What a program is given: the cell, its config node, the seed and its
    streams, the device, the traffic and the limits."""
    cell: "manifest.Cell"
    cfg: object
    seed: int
    device: object
    traffic: dict
    limits: dict
    streams: dict = field(default_factory=dict)


def context(cell, seed: int, device: str, overrides: Optional[dict] = None) -> Context:
    import torch

    from mpreid_tpu_torch.config import get_default_cfg

    from portbench.data.seeds import streams

    overrides = overrides or {}
    cfg = get_default_cfg()
    merge(cfg, cell.config["cfg"])
    merge(cfg, cell.workload.get("cfg", {}))
    merge(cfg, overrides.get("cfg", {}))
    cfg.MODEL.DEVICE = device
    traffic = dict(cell.workload["traffic"], **overrides.get("traffic", {}))
    return Context(cell, cfg, int(seed), torch.device(device), traffic,
                   dict(cell.workload["limits"]), streams(seed))


def window(unit, seconds: float):
    """→ (items, seconds) of the units run back to back until the first
    unit end after ``seconds``."""
    items, t0 = 0, time.perf_counter()
    while True:
        items += unit()
        t = time.perf_counter() - t0
        if t >= seconds:
            return items, t


def execute(cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
            overrides: Optional[dict] = None, t_start: Optional[float] = None,
            program=None) -> dict:
    """The run → the result's dict (``check`` last)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    ctx = context(cell, seed, device, overrides)
    prog = (program or manifest.program(cell.workload["program"], cell.root).Program)(ctx)
    prog.setup()
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start - prog.check_seconds
    rec = None
    if traced and cuda:
        rec = trace.traced(prog.unit, min(seconds, TRACE_SECONDS))
    else:  # a traced run without a card (a CPU test) has nothing to trace
        items, span = window(prog.unit, seconds)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    outputs = prog.finish()
    numbers = prog.check(outputs)

    metrics = {}
    if not traced:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == cell.workload["rate_metric"]:
                value = items / span
            else:
                raise KeyError(f"cell {cell.name} has no source for {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif rec is not None:
        rec.context.update(program=prog, cell=cell)
        for m in cell.per_layer:
            value = manifest.reader(m["name"], cell.root).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if rec is not None:
        dev.update(busy_s=rec.busy_s(), window_s=rec.window_s)
    result = {"correct": all(n["ok"] for n in numbers),
              "attempted": rec.items if rec is not None else items,
              "failed": 0, "metrics": metrics, "device": dev}
    if rec is not None:
        result["breakdown"] = rec.breakdown()
        print(f"traced span: attempt {rec.context['attempt']}, {rec.items} items, launches "
              f"{rec.context['launches']} (the trace's records agree)", file=sys.stderr)
        for name, seconds in rec.top_kernels():
            print(f"kernel {seconds:.6f} s {trace.group_of(name)} {name[:200]}", file=sys.stderr)
    result["check"] = {n["name"]: {"value": n["value"], "limit": n["limit"]} for n in numbers}
    return result


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = manifest.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                         t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, n in result["check"].items():
        verdict = "ok" if math.isfinite(n["value"]) and n["value"] <= n["limit"] else "FAIL"
        print(f"check {name} {n['value']!r} limit {n['limit']!r} {verdict}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
