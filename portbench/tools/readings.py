"""The readings a cell's limits are set from, on the card, in one process.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--control 3] [--out readings.jsonl]

For each seed: the cell's set-up and first steps (no window), then the
comparison with the reference, as a run makes it (the lower readings).
For the first ``--control`` seeds, also the control: the reference computed
with fp8 e4m3 products (``reference/precision.py``) put in the port's
place and compared with the fp32 reference (the upper readings), and for a
training cell the fault of half the batch left out (the reference over the
first half of each batch's rows in the port's place). Every candidate
number is given, the cell's limits or not. Each seed's numbers go to
``--out`` as one JSON line and to standard output."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--out", default="")
    p.add_argument("--set", nargs="*", default=[],
                   help="config overrides KEY.PATH=VALUE, e.g. TPU.COMPUTE_DTYPE=float32 "
                        "(a witness run of the port in another precision)")
    p.add_argument("--traffic", nargs="*", default=[],
                   help="traffic overrides KEY=VALUE (a number), e.g. noise=96")
    args = p.parse_args(argv)
    overrides = {"cfg": {}, "traffic": {k: float(v) for k, v in
                                        (item.split("=", 1) for item in args.traffic)}}
    for item in args.set:
        path, value = item.split("=", 1)
        node = overrides["cfg"]
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = value

    from portbench.harness import manifest, runner
    from portbench.reference.precision import Precision, fp32_only

    cell = manifest.Cell(args.workload)
    program = manifest.program(cell.workload["program"]).Program
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        prog = program(runner.context(cell, seed, "cuda", overrides))
        prog.setup()
        kept = prog.finish()
        fp32_only()
        r32 = prog.reference(kept, Precision("fp32"))
        line = {"workload": cell.name, "seed": seed, "set": args.set, "traffic": args.traffic,
                "sound": {n["name"]: n["value"] for n in prog.numbers(kept, r32, True)}}
        if i < args.control:
            r8 = prog.reference(kept, Precision("fp8"))
            line["control"] = {n["name"]: n["value"]
                               for n in prog.numbers(prog.as_reading(r8), r32, True)}
            del r8
            if cell.workload["program"] != "validation":
                half = prog.reference(kept, Precision("fp32"), keep=0.5)
                line["half_batch"] = {n["name"]: n["value"]
                                      for n in prog.numbers(prog.as_reading(half), r32, True)}
                del half
        line["seconds"] = time.perf_counter() - t0
        del r32, kept, prog
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
