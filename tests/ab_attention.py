"""The bf16 attention kernels of two checkouts on one card: every output
compared bit for bit, and each kernel timed in turns.

    python3 tests/ab_attention.py OTHER_ROOT [THIS_ROOT]

OTHER_ROOT and THIS_ROOT (by default the checkout that holds this file) are
checkouts of this repository. Each turn is a process of its own, started
with its root first on ``PYTHONPATH``, so it builds and launches that root's
kernels through that root's ``mpreid_tpu_torch.ops.attention``
(``fused_attention`` and ``fused_attention_bwd``): the same inputs, seeded
on the card, at ``chip_smoke.py``'s bf16 shapes of phase 3 (and dh 128 at L
129), both layouts. A turn reports a SHA-256 of every output and the time of
every call: the median of 30 CUDA-event timings of a CUDA graph of 10 calls
(so no host time). The turns go other, this, this, other. Prints the card's
``nvidia-smi`` line, one JSON line a case and a JSON summary; exits 1 if any
output differs between the turns.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# (name, B, L, heads, dh, causal)
CASES = (("text", 64, 77, 8, 64, True), ("vision", 64, 129, 12, 64, False),
         ("vehicle", 64, 257, 12, 64, False), ("ttpt_text", 1000, 77, 8, 64, True),
         ("vision_dh128", 64, 129, 6, 128, False))


def graph_ms(fn, reps: int = 10, runs: int = 30) -> float:
    """Median ms of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, each replay timed with CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def turn() -> list:
    """One turn in this process: [{case, layout, direction, sha256, ms}]."""
    import torch

    from mpreid_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(77)
    rows = []
    for name, b, l, heads, dh, causal in CASES:
        qkv = torch.randn(b, l, 3 * heads * dh, device="cuda", generator=gen).bfloat16()
        do = torch.randn(b, l, heads * dh, device="cuda", generator=gen).bfloat16()
        mask = torch.full((l, l), float("-inf"), device="cuda").triu(1) if causal else None
        for layout in attn.LAYOUTS:
            calls = {"fwd": lambda: attn.fused_attention(qkv, heads, mask, layout=layout),
                     "bwd": lambda: attn.fused_attention_bwd(qkv, do, heads, mask, layout=layout)}
            for direction, fn in calls.items():
                with torch.no_grad():
                    out = fn()
                    digest = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes())
                    rows.append(dict(case=name, layout=layout, direction=direction,
                                     sha256=digest.hexdigest(), ms=graph_ms(fn)))
        del qkv, do, mask
    return rows


def run_turn(root: Path) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, __file__, "--turn"], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the turn in {root} failed:\n{proc.stdout[-4000:]}"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other_root", type=Path, nargs="?")
    parser.add_argument("this_root", type=Path, nargs="?",
                        default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.turn:
        print(json.dumps(turn()), flush=True)
        return 0
    if args.other_root is None:
        parser.error("OTHER_ROOT is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    other, this = args.other_root.resolve(), args.this_root.resolve()
    turns = [run_turn(root) for root in (other, this, this, other)]
    equal_all = True
    for rows in zip(*turns):
        equal = len({r["sha256"] for r in rows}) == 1
        equal_all = equal_all and equal
        print(json.dumps(dict(case=rows[0]["case"], layout=rows[0]["layout"],
                              direction=rows[0]["direction"], bit_equal=equal,
                              other_ms=[rows[0]["ms"], rows[3]["ms"]],
                              this_ms=[rows[1]["ms"], rows[2]["ms"]])), flush=True)
    print(json.dumps(dict(bit_equal=equal_all, outputs=len(turns[0]))), flush=True)
    return 0 if equal_all else 1


if __name__ == "__main__":
    sys.exit(main())
