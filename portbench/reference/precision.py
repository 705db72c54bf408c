"""The arithmetic of the reference: fp32 products (TF32 off), or the
control's, fp8 training's usual recipe: both operands of every product,
and the activations a tower hands on, rounded to e4m3 under a per-tensor
scale in the forward, and the gradients flowing back into them to e5m2."""

from __future__ import annotations

import torch
import torch.nn.functional as F

FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def fp32_only() -> None:
    """No TF32 anywhere: the reference is fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """``x`` rounded to the fp8 format ``fmt`` under one scale that maps its
    largest magnitude to the format's largest, returned in fp32."""
    dtype, largest = FORMATS[fmt]
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / largest, torch.ones_like(amax))
    return (x.float() / scale).to(dtype).float() * scale


class _RoundValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, "e5m2")


class Precision:
    """``mode`` "fp32" (the reference) or "fp8" (the control)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundValue.apply(t) if self.mode == "fp8" else t.float()

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(t) if self.mode == "fp8" and t.requires_grad else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (batched alike)."""
        return self._out(torch.matmul(self._in(a), self._in(b)))

    def linear(self, x, w, b=None):
        """``x @ wᵀ + b``, ``w`` (out, in)."""
        y = self.mm(x, w.t())
        return y if b is None else y + b

    def conv2d(self, x, w, stride: int = 1, padding: int = 0):
        return self._out(F.conv2d(self._in(x), self._in(w), stride=stride, padding=padding))

    def store(self, *ts):
        """A tower's outputs as it hands them on: unchanged in fp32; in fp8,
        rounded (and their gradients rounded on the way back)."""
        if self.mode == "fp32":
            return ts
        return tuple(self._out(_RoundValue.apply(t)) for t in ts)
