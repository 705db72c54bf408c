"""The fused attention kernels' least time at a shape.

The least time is the larger of the bytes at the memory's peak and the
operations at the bf16 peak. Bytes count each input once and each output
once: forward, the packed q|k|v in and the output out (bf16); backward,
q|k|v and the output's gradient in and the q|k|v gradient out. Operations
count the products the mathematics needs, two per multiply-add: forward
QKᵀ and PV (2 · 2 · dh per query-key pair), backward dV, dP, dQ and dK (4 · 2
· dh per pair), the forward's product recomputed in the backward not
counted; under a causal mask a query meets only the keys up to itself."""

from __future__ import annotations

from dataclasses import dataclass

from . import peaks

BF16 = 2


@dataclass(frozen=True)
class Shape:
    batch: int
    length: int
    heads: int
    head_dim: int = 64
    causal: bool = False

    @property
    def pairs(self) -> int:
        n = self.length
        return n * (n + 1) // 2 if self.causal else n * n

    @property
    def width(self) -> int:
        return self.heads * self.head_dim


def fwd_bytes(s: Shape) -> float:
    return s.batch * s.length * 4 * s.width * BF16


def bwd_bytes(s: Shape) -> float:
    return s.batch * s.length * 7 * s.width * BF16


def fwd_flops(s: Shape) -> float:
    return 4.0 * s.batch * s.heads * s.pairs * s.head_dim


def bwd_flops(s: Shape) -> float:
    return 8.0 * s.batch * s.heads * s.pairs * s.head_dim


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def fwd_least_seconds(s: Shape) -> float:
    return least_seconds(fwd_flops(s), fwd_bytes(s))


def bwd_least_seconds(s: Shape) -> float:
    return least_seconds(bwd_flops(s), bwd_bytes(s))
