"""A cell's traced segment, taken as a ``--trace 1`` run takes it, with the
device's idle time split by the port's layers and spans, and the port's
in-memory spans held against the profiler's records of the same spans.

    python3 portbench/tools/idle_split.py --workload <cell> --seed <n> \
        [--seconds 3] [--out split.jsonl]

Prints one JSON line (also appended to ``--out``): ``device_idle_pct``;
the idle share of the window by layer and by span name
(``port_spans.idle_split``) and their sum; the ten longest gaps, each cut
by the innermost span over it; and the clock check: for every port span
in the window, the start and end of the profiler's own record of the same
name nearest to it, the differences in microseconds (median, 99th
percentile, largest) and how many lie past 50 us."""

import argparse
import bisect
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def clock_check(prof, spans, lo: float, hi: float) -> dict:
    """Each in-memory span against the host record of its name nearest in
    start time."""
    names = {s.name for s in spans}
    theirs = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names and not str(e.device_type()).endswith("CUDA"):
            theirs.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for v in theirs.values():
        v.sort()
    starts, ends, unmatched = [], [], 0
    for s in spans:
        if not (lo * 1e9 <= s.start_ns and s.end_ns <= hi * 1e9):
            continue
        recs = theirs.get(s.name, [])
        if not recs:
            unmatched += 1
            continue
        i = bisect.bisect_left(recs, (s.start_ns, 0))
        near = min(recs[max(i - 1, 0):i + 1], key=lambda r: abs(r[0] - s.start_ns))
        starts.append((s.start_ns - near[0]) / 1e3)
        ends.append((s.end_ns - near[1]) / 1e3)

    def summary(d):
        if not d:
            return None
        a = sorted(abs(x) for x in d)
        return {"median": statistics.median(d), "p99_abs": a[int(0.99 * (len(a) - 1))],
                "max_abs": a[-1], "over_50us": sum(x > 50 for x in a)}

    return {"spans": len(starts), "unmatched": unmatched, "start_us": summary(starts),
            "end_us": summary(ends)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from mpreid_tpu_torch.utils import tracing
    from portbench.harness import manifest, port_spans, readers, runner, trace

    cell = manifest.Cell(args.workload)
    t0 = time.perf_counter()
    ctx = runner.context(cell, args.seed, "cuda")
    prog = manifest.program(cell.workload["program"]).Program(ctx)
    prog.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kept = {}
    records = trace.records

    def keep(prof, span=trace.SPAN):
        kept["prof"] = prof
        return records(prof, span)

    trace.records = keep
    try:
        rec = trace.traced(prog.unit, args.seconds)
    finally:
        trace.records = records
    rec.context.update(program=prog, cell=cell)
    window = rec.window_s
    layers = port_spans.idle_by_layer(rec) or {}
    names = port_spans.idle_split(rec, lambda n: n) or {}
    spans = tracing.spans(int(rec.lo * 1e9), int(rec.hi * 1e9))
    pieces = port_spans.timeline([(s.name, s.start_ns / 1e9, s.end_ns / 1e9) for s in spans],
                                 rec.lo, rec.hi, lambda n: n)
    gaps = []
    for lo, hi in sorted(rec.idle_gaps(), key=lambda g: g[0] - g[1])[:10]:
        cut = {}
        for a, b, name in pieces:
            part = min(b, hi) - max(a, lo)
            if part > 0:
                cut[name] = cut.get(name, 0.0) + part * 1e3
        gaps.append({"ms": (hi - lo) * 1e3, "by_span_ms": cut})
    line = {
        "workload": cell.name, "seed": args.seed, "setup_s": setup_s,
        "device": torch.cuda.get_device_name(0), "window_s": window, "items": rec.items,
        "attempt": rec.context["attempt"],
        "device_idle_pct": readers.idle_pct(rec), "mfu_pct": readers.mfu_pct(rec),
        "idle_pct_by_layer": {k: 100 * v / window for k, v in sorted(layers.items())},
        "idle_pct_layers_sum": 100 * sum(layers.values()) / window,
        "idle_pct_by_span": {k: 100 * v / window
                             for k, v in sorted(names.items(), key=lambda kv: -kv[1])},
        "longest_gaps": gaps,
        "span_count": len(spans),
        "clock": clock_check(kept["prof"], spans, rec.lo, rec.hi),
    }
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    prog.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
