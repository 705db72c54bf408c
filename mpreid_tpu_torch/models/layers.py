"""Core transformer layers of the port.

ref mpreid_tpu/models/layers.py::LayerNorm, ::quick_gelu,
::MultiHeadAttention, ::MLP, ::ResidualAttentionBlock, ::BNNeck,
::MarginHead, ::make_classifier, ::classifier_scores, ::linear_bias_act, ::_lba_bwd.

Parameters are fp32 and keep the reference torch state_dict names
(``nn.MultiheadAttention``'s packed ``in_proj_weight``, ``out_proj``,
``ln_1``/``ln_2``, ``mlp.c_fc``/``mlp.c_proj``, BatchNorm1d buffers), so a
reference ``.pth`` loads with ``load_state_dict(strict=True)``. Activations
run in the model's compute dtype (bf16 by default) with the JAX package's
numerics:

* LayerNorm and BNNeck compute in fp32 and cast back;
* the attention projections (and patchify and ``proj`` in vit.py)
  accumulate in fp32, add the fp32 bias, then cast (``linear_f32acc``);
* the MLP computes in the activation dtype;
* attention logits and softmax are fp32 (ops/attention.py).

Both linear forms share the JAX package's gradient (``_lba_bwd``): dx and
dW summed in fp32 and rounded to the activation dtype (dW then accumulates
into the fp32 parameter's ``.grad`` through the cast), db summed in fp32.

Parameters are created empty; ``init_`` methods fill them from an explicit
``torch.Generator`` (models/factory.py seeds it).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mpreid_tpu_torch.losses import margin as M
from mpreid_tpu_torch.ops.attention import fused_attention
from mpreid_tpu_torch.ops.matmul import mm_f32


def _linear_fwd(x, w, bias, accum_f32: bool) -> torch.Tensor:
    if not accum_f32:
        return F.linear(x, w, bias.to(x.dtype) if bias is not None else None)
    if x.dtype == torch.float32 or not x.is_cuda:
        y = F.linear(x.float(), w.float())
    else:
        y = mm_f32(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def linear_bias_act(x, w, bias, accum_f32: bool) -> torch.Tensor:
    """``_LinearBiasAct`` where a gradient is wanted, its forward alone
    otherwise (the eval path skips the autograd Function's overhead)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _LinearBiasAct.apply(x, w, bias, accum_f32)
    return _linear_fwd(x, w, bias, accum_f32)


class _LinearBiasAct(torch.autograd.Function):
    """``y = x @ w.T (+ bias)`` with the JAX package's VJP (ref ``_lba_bwd``).

    ``x`` and ``w`` arrive in the activation dtype, ``bias`` in fp32. The
    forward is the caller's (``accum_f32``: fp32 sums plus the fp32 bias,
    then one cast; else everything in the activation dtype)."""

    @staticmethod
    def forward(ctx, x, w, bias, accum_f32):
        ctx.save_for_backward(x, w)
        return _linear_fwd(x, w, bias, accum_f32)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = mm_f32(dy2, w).to(x.dtype).reshape(x.shape) if need_x else None
        dw = mm_f32(dy2.t(), x.reshape(-1, x.shape[-1])).to(w.dtype) if need_w else None
        db = dy2.float().sum(0) if need_b else None
        return dx, dw, db, None


def linear_f32acc(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``(x @ weight.T)`` summed in fp32 over inputs cast to ``dtype``, plus
    the fp32 bias, then cast to ``dtype``. ``weight`` is (out, in)."""
    return linear_bias_act(x.to(dtype), weight.to(dtype), bias, True)


def init_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=gen)


class Linear(nn.Module):
    """Weight (out, in) and optional bias (out,), fp32 (the ``nn.Linear`` layout)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def init_(self, gen: torch.Generator, std: Optional[float] = None) -> None:
        """Normal init (lecun: std = fan_in^-½ unless given), zero bias."""
        init_normal_(self.weight, std if std is not None else self.weight.shape[1] ** -0.5, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Everything in the activation dtype (the flax ``Dense`` convention)."""
        return linear_bias_act(x, self.weight.to(x.dtype), self.bias, False)


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 whatever the activation dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    """Self-attention with ``nn.MultiheadAttention``-compatible parameters:
    ``in_proj_weight`` (3d, d) packed [q|k|v], ``in_proj_bias``, ``out_proj``.

    With ``lora_rank`` > 0 a low-rank adapter joins the QKV projection
    (ref ``MultiHeadAttention``'s LoRA, ``SOLVER.LORA``): ``lora_a`` (d, r),
    ``lora_b`` (r, 3d) in [q|k|v] packing, and qkv += (α/r)·((x·A)·B), with
    x·A summed in fp32 and rounded to the activation dtype, ·B summed in
    fp32, scaled in fp32, then rounded. The reference state_dict has no
    such keys (models/convert.py folds adapters into in_proj for it)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)
        if lora_rank:
            self.lora_a = nn.Parameter(torch.empty(dim, lora_rank))
            self.lora_b = nn.Parameter(torch.empty(lora_rank, 3 * dim))

    def init_(self, gen: torch.Generator) -> None:
        # xavier-uniform over the (d, 3d) and (d, d) kernels, zero biases
        for w in (self.in_proj_weight, self.out_proj.weight):
            limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            with torch.no_grad():
                w.uniform_(-limit, limit, generator=gen)
        nn.init.zeros_(self.in_proj_bias)
        nn.init.zeros_(self.out_proj.bias)
        if self.lora_rank:
            init_normal_(self.lora_a, 0.02, gen)
            nn.init.zeros_(self.lora_b)  # the adapter starts as the identity

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        qkv = linear_f32acc(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
        if self.lora_rank:
            h = linear_f32acc(x, self.lora_a.t(), None, self.dtype)
            delta = torch.matmul(h.float(), self.lora_b.to(self.dtype).float())
            qkv = qkv + ((self.lora_alpha / self.lora_rank) * delta).to(self.dtype)
        out = fused_attention(qkv, self.num_heads, mask, layout="packed")
        return linear_f32acc(out, self.out_proj.weight, self.out_proj.bias, self.dtype)


class MLP(nn.Module):
    """c_fc → QuickGELU → c_proj, in the activation dtype."""

    def __init__(self, dim: int, hidden_mult: int = 4):
        super().__init__()
        self.c_fc = Linear(dim, dim * hidden_mult)
        self.c_proj = Linear(dim * hidden_mult, dim)

    def init_(self, gen: torch.Generator) -> None:
        self.c_fc.init_(gen)
        self.c_proj.init_(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.attn = MultiHeadAttention(dim, num_heads, dtype, lora_rank, lora_alpha)
        self.ln_1 = LayerNorm(dim)
        self.mlp = MLP(dim)
        self.ln_2 = LayerNorm(dim)

    def init_(self, gen: torch.Generator) -> None:
        self.attn.init_(gen)
        self.mlp.init_(gen)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class BNNeck(nn.Module):
    """BatchNorm1d bottleneck, fp32 (ref ``BNNeck``).

    Keeps the ``BatchNorm1d`` state_dict keys. The bias stays zero: the
    solver never trains it (solver/optim.py::bnneck_bias). ``train=True``
    normalises with the batch mean and biased variance and updates the
    running statistics with the unbiased variance, EMA decay 0.9, and counts
    the batch in ``num_batches_tracked``; ``train=False`` uses the running
    statistics."""

    momentum = 0.9  # torch BN momentum 0.1 → EMA decay 0.9

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.float()
        if train:
            mean = x32.mean(dim=0)
            var = torch.square(x32 - mean).mean(dim=0)
            n = x.shape[0]
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.copy_(
                    self.momentum * self.running_mean + (1 - self.momentum) * mean)
                self.running_var.copy_(
                    self.momentum * self.running_var + (1 - self.momentum) * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


class MarginHead(nn.Module):
    """Margin classifier head, the ``MODEL.COS_LAYER`` classifier (ref
    ``MarginHead``): one (num_classes, in_features) ``weight``, the plain
    classifier's name and layout, so checkpoints and reference ``.pth`` keys
    are the same. With labels it returns the kind's margin logits, without
    them ``s · cos(θ)``; ``s`` is 30, or 256 for circle, in both."""

    KINDS = ("arcface", "cosface", "amsoftmax", "circle")

    def __init__(self, in_features: int, num_classes: int, kind: str = "arcface"):
        super().__init__()
        if kind not in self.KINDS:
            raise ValueError(f"Unknown MODEL.COS_LAYER_TYPE {kind!r}; expected "
                             "arcface|cosface|amsoftmax|circle")
        self.kind = kind
        self.effective_scale = 256.0 if kind == "circle" else 30.0
        self.weight = nn.Parameter(torch.empty(num_classes, in_features))

    def init_(self, gen: torch.Generator, std: float = 0.001) -> None:
        init_normal_(self.weight, std, gen)

    def forward(self, features: torch.Tensor, labels: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        s = self.effective_scale
        if labels is None:
            return s * M._cosine_logits(features, self.weight)
        if self.kind == "amsoftmax":
            return M.amsoftmax_logits(features, self.weight.t(), labels, s=s)
        fn = {"arcface": M.arcface_logits, "cosface": M.cosface_logits,
              "circle": M.circle_logits}[self.kind]
        return fn(features, self.weight, labels, s=s)


def make_classifier(num_classes: int, in_features: int, cos_layer: str = "") -> nn.Module:
    """Bias-free classifier (ref make_model.py:48-51), or the margin head of
    kind ``cos_layer`` (``MODEL.COS_LAYER_TYPE`` under ``MODEL.COS_LAYER``)."""
    if cos_layer:
        return MarginHead(in_features, num_classes, kind=cos_layer)
    return Linear(in_features, num_classes, bias=False)


def classifier_scores(classifier: nn.Module, feats: torch.Tensor,
                      labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train-time logits in fp32 on the BN features (ref
    ``classifier_scores``): a margin head takes the labels, the plain
    classifier does not."""
    if isinstance(classifier, MarginHead):
        return classifier(feats.float(), labels)
    return classifier(feats.float())
