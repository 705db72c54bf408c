"""The traced run: the profiler's records read in memory, never written.

A traced segment runs the program's units under ``torch.profiler`` (CPU
and CUDA activity) inside one ``record_function`` span,
``portbench.window``; one unit runs under the profiler before the span (the
first graph launch of a profiling session can lose a kernel record) and
the profiler stays open 50 ms past the last synchronisation (it keeps only
device records that end inside it). ``Records`` holds the span, the device
intervals inside it, the kernels by name and the benchmark's own host
spans (``portbench.*``), from which the per-layer readers take their
numbers."""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "portbench.window"

# stable names for the breakdown, tried in order
GROUPS = (
    ("attention_fwd", r"mha_fwd"),
    ("attention_bwd", r"mha_bwd"),
    ("adam", r"adam_kernel"),
    ("conv", r"conv|fprop|dgrad|wgrad|implicit_gemm|cudnn|winograd"),
    ("gemm", r"nvjet|gemm|gemv|xmma|cutlass|cublas|Gemm|splitK|wgmma"),
    ("norm", r"norm|GammaBeta"),
    ("reduction", r"reduce|Reduce|softmax|argmax|sort|cumsum|scan"),
    ("elementwise_cast", r"elementwise|vectorized|unrolled|copy|memcpy|fill|index|where|cat|Cat"),
)

# the port's launch counters and the kernel names their launches run
COUNTED_KERNELS = {
    "attention_fwd": r"\bmha_fwd(_tc)?_kernel<",
    "attention_bwd": r"\bmha_bwd_tc_kernel<|\bmha_bwd_rows<",
    "adam": r"\badam_kernel<",
}


@dataclass
class Records:
    lo: float  # the span, seconds on the host's clock
    hi: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start, end)
    device: List[Tuple[float, float]] = field(default_factory=list)  # kernels, copies, sets
    host_spans: List[Tuple[str, float, float]] = field(default_factory=list)
    items: int = 0  # items the span's units completed
    context: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for lo, hi in sorted((max(a, self.lo), min(b, self.hi)) for a, b in self.device):
            if hi <= lo:
                continue
            if out and lo <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], hi))
            else:
                out.append((lo, hi))
        return out

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, at = [], self.lo
        for lo, hi in self.busy_intervals():
            if lo > at:
                gaps.append((at, lo))
            at = hi
        if self.hi > at:
            gaps.append((at, self.hi))
        return gaps

    def kernel_seconds(self, pattern: str) -> List[float]:
        rx = re.compile(pattern)
        return [e - s for n, s, e in self.kernels if rx.search(n)]

    def count(self, pattern: str) -> int:
        return len(self.kernel_seconds(pattern))

    def top_kernels(self, top: int = 25) -> List[Tuple[str, float]]:
        """The kernels by name that took the most device time in the span."""
        out: Dict[str, float] = {}
        for n, s, e in self.kernels:
            out[n] = out.get(n, 0.0) + (e - s)
        return sorted(out.items(), key=lambda kv: -kv[1])[:top]

    def groups(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.kernels:
            out[group_of(n)] = out.get(group_of(n), 0.0) + (e - s)
        return out

    def host_label(self, t: float) -> str:
        """The innermost benchmark span the host was in at ``t``."""
        best = None
        for n, s, e in self.host_spans:
            if s <= t < e and (best is None or s >= best[1]):
                best = (n, s)
        return best[0] if best else "outside"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.groups().items(), key=lambda kv: -kv[1])[:top]
        copies = sum(e - s for s, e in self.device) - sum(e - s for _, s, e in self.kernels)
        if copies > 0 and len(ops) < top:
            ops.append(("memcpy_memset", copies))
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[self.host_label(lo), hi - lo] for lo, hi in gaps]}


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name):
            return group
    return "other"


def _seconds(e, which: str) -> float:
    ns = getattr(e, f"{which}_ns", None)
    if ns is not None:
        return ns() / 1e9
    return getattr(e, f"{which}_us")() / 1e6


def _end(e) -> float:
    if hasattr(e, "end_ns"):
        return e.end_ns() / 1e9
    return _seconds(e, "start") + e.duration_us() / 1e6


def kind_of(e) -> str:
    """The event's kind as the Chrome trace names it: ``kernel``,
    ``gpu_memcpy``, ``gpu_memset``, ``gpu_user_annotation`` on the device;
    ``user_annotation`` for a benchmark span on the host; else ``cpu``.
    Read from ``activity_type`` where the event has it, else from its
    device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        if name.startswith("portbench."):
            return "gpu_user_annotation"
        return "kernel"
    return "user_annotation" if name.startswith("portbench.") else "cpu"


def records(prof, span: str = SPAN) -> Records:
    """The span's records from a stopped profiler."""
    events = prof.profiler.kineto_results.events()
    kinds = [kind_of(e) for e in events]
    marks = [(_seconds(e, "start"), _end(e)) for e, k in zip(events, kinds)
             if k == "user_annotation" and e.name() == span]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} spans {span!r}, not 1")
    lo, hi = marks[0]
    rec = Records(lo, hi)
    for e, kind in zip(events, kinds):
        s, t = _seconds(e, "start"), _end(e)
        if kind in DEVICE_KINDS and lo <= s <= hi:
            rec.device.append((s, t))
            if kind == "kernel":
                rec.kernels.append((e.name(), s, t))
        elif kind == "user_annotation" and e.name().startswith("portbench."):
            rec.host_spans.append((e.name(), s, t))
    return rec


def counter_values() -> Dict[str, int]:
    from mpreid_tpu_torch.ops import adam, attention

    return {"attention_fwd": attention.fused_attention.launches,
            "attention_bwd": attention.fused_attention_bwd.launches,
            "adam": adam.fused_adam_leaf.launches}


def traced(unit: Callable[[], int], seconds: float, attempts: int = 3) -> Records:
    """Units under the profiler until ``seconds`` have passed in the span;
    the kernels the trace holds are checked against the port's launch
    counters over the span, and a disagreeing trace is taken again, up to
    ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    problems = []
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            unit()
            torch.cuda.synchronize()
            time.sleep(0.05)
            before = counter_values()
            items, t0 = 0, time.perf_counter()
            with record_function(SPAN):
                while True:
                    items += unit()
                    if time.perf_counter() - t0 >= seconds:
                        break
                torch.cuda.synchronize()
            after = counter_values()
            time.sleep(0.05)
        rec = records(prof)
        rec.items = items
        rec.context["launches"] = {k: after[k] - before[k] for k in after}
        rec.context["attempt"] = attempt
        mismatch = {k: (rec.count(COUNTED_KERNELS[k]), n)
                    for k, n in rec.context["launches"].items()
                    if rec.count(COUNTED_KERNELS[k]) != n}
        if not mismatch:
            return rec
        problems.append(mismatch)
    raise RuntimeError(f"the trace's kernels (traced, counted) differ from the launch "
                       f"counters in {attempts} traced runs: {problems}")
