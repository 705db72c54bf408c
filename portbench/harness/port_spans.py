"""The device's idle time put down to the port's own layers.

The port records spans of its host work while a profiler records
(``mpreid_tpu_torch/utils/tracing.py``), on the clock the profiler stamps
its events with. Each idle gap of a traced run (``Records.idle_gaps``) is
cut at those spans' ends, and each piece goes to the innermost span the
host was in (the one that started last, as ``Records.host_label`` takes
the benchmark's own spans), labelled by the span's layer, the first part
of its name (``compiled.replay`` → ``compiled``), or ``outside`` where the
host was in none. The pieces add up to the idle time ``readers.idle_pct``
reads. A port without the spans (no ``tracing`` module, or no span in the
window) gives None, and so do the readers."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

OUTSIDE = "outside"


def port_spans(rec) -> Optional[List[Tuple[str, float, float]]]:
    """The port's spans that overlap the traced span, as (name, start,
    end) in seconds; None where the port records none."""
    try:
        from mpreid_tpu_torch.utils import tracing
    except ImportError:
        return None
    found = tracing.spans(int(rec.lo * 1e9), int(rec.hi * 1e9))
    return [(s.name, s.start_ns / 1e9, s.end_ns / 1e9) for s in found] or None


def layer_of(name: str) -> str:
    return name.split(".", 1)[0]


def timeline(spans, lo: float, hi: float, label: Callable[[str], str] = layer_of
             ) -> List[Tuple[float, float, str]]:
    """[``lo``, ``hi``] cut at every start and end of ``spans``; each piece
    (start, end, label) labelled by the innermost span over it, ``OUTSIDE``
    where none is."""
    cuts = sorted({lo, hi, *(t for _, s, e in spans for t in (s, e) if lo < t < hi)})
    by_start = sorted(spans, key=lambda x: x[1])
    active: list = []
    pieces, j = [], 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(by_start) and by_start[j][1] <= a:
            active.append(by_start[j])
            j += 1
        active = [x for x in active if x[2] >= b]
        inner = max(active, key=lambda x: x[1]) if active else None
        pieces.append((a, b, label(inner[0]) if inner else OUTSIDE))
    return pieces


def idle_split(rec, label: Callable[[str], str] = layer_of) -> Optional[Dict[str, float]]:
    """Seconds of the traced span's idle gaps by the label of the innermost
    port span at each instant; None where the port recorded no span."""
    spans = port_spans(rec)
    if spans is None:
        return None
    pieces = timeline(spans, rec.lo, rec.hi, label)
    out: Dict[str, float] = {}
    i = 0
    for lo, hi in rec.idle_gaps():
        while pieces[i][1] <= lo:
            i += 1
        k = i
        while k < len(pieces) and pieces[k][0] < hi:
            a, b, name = pieces[k]
            part = min(b, hi) - max(a, lo)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
            k += 1
    return out


def idle_by_layer(rec) -> Optional[Dict[str, float]]:
    """Idle seconds by the port's layer (``compiled``, ``steps``,
    ``evaluator``, ``validation``, ``train``, ``stage1``, ``loader``) and
    ``outside``."""
    return idle_split(rec, layer_of)


def idle_layer_pct(rec, layer: str) -> Optional[float]:
    """The share of the traced span in which the device was idle and the
    host inside ``layer``'s spans, in percent; None without the spans."""
    split = idle_by_layer(rec)
    if split is None or rec.window_s <= 0:
        return None
    return 100.0 * split.get(layer, 0.0) / rec.window_s
