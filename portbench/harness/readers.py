"""What the per-layer metric files read from a traced run's records."""

from __future__ import annotations

from typing import Optional

from portbench.counts import attention, peaks

from .trace import COUNTED_KERNELS


def idle_pct(rec) -> Optional[float]:
    """The share of the traced span in which no kernel, copy or set ran."""
    if rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)


def mfu_pct(rec) -> Optional[float]:
    """The operations the step needs per item times the items per second of
    the traced span, over the bf16 peak."""
    if rec.items <= 0 or rec.window_s <= 0:
        return None
    rate = rec.items / rec.window_s
    return 100.0 * rec.context["program"].flops_per_item() * rate / peaks.BF16_FLOPS


def roofline_pct(rec, direction: str) -> Optional[float]:
    """The kernel's least time at the cell's shape over its mean traced
    time; None where the window runs no such kernel."""
    shape = rec.context["program"].attention()
    times = rec.kernel_seconds(COUNTED_KERNELS[f"attention_{direction}"])
    if shape is None or not times:
        return None
    least = (attention.fwd_least_seconds if direction == "fwd"
             else attention.bwd_least_seconds)(shape)
    return 100.0 * least * len(times) / sum(times)
