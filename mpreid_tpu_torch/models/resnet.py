"""ModifiedResNet (CLIP RN50) of the port.

ref mpreid_tpu/models/resnet.py::_BN2d, ::Bottleneck, ::AttentionPool2d,
::ModifiedResNet.

* a 3-conv stem (the first at stride 2) with BatchNorm and ReLU, then a
  2×2 average pool;
* anti-aliased Bottleneck blocks: a stride above 1 is an average pool
  before a stride-1 conv, in the branch and in the downsample path alike;
* layer4 at stride 1 (the ReID modification);
* ``AttentionPool2d``: the mean token prepended to the spatial tokens, the
  positional embedding added, every token attending to every token;
* ``forward`` returns ``(x3, x4, xproj)``: the layer3 and layer4 maps
  (B, C, H, W) and the pooled tokens (L, B, out), as the JAX package's
  tower (and the reference's) returns them; the models take the spatial
  means of x3 and x4 and ``xproj[0]``.

The public input is NHWC, as for the ViT tower; the tower permutes it once
to NCHW (a view with channels-last strides, which cuDNN's NHWC kernels
take), and the tests transpose the JAX package's NHWC maps to compare.
Convs are bias-free and run in the compute dtype. ``BatchNorm2d`` normalises
in fp32 and casts back. The attention pool keeps the JAX rounding order: q,
k, v and ``c_proj`` in the activation dtype (flax ``Dense``), logits of the
scaled q and k summed in fp32, an fp32 softmax, probabilities rounded to the
activation dtype, P·V summed in fp32 (``ops/matmul.py::bmm_f32``: bf16
products with fp32 sums on the card). The JAX package runs the pool in XLA,
not in a Pallas kernel, so it is plain PyTorch here. Parameter and buffer
names are the OpenAI CLIP state_dict's (``conv1``, ``bn1``,
``layer1.0.downsample.0``/``.1``, ``attnpool.q_proj``, …), so an RN50 file
loads key for key.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpreid_tpu_torch.ops.matmul import bmm_f32
from mpreid_tpu_torch.parallel.mesh import batch_mesh

from .layers import Linear, global_moments, init_normal_


class BatchNorm2d(nn.Module):
    """BatchNorm over (B, C, H, W) with torch's semantics and state_dict keys
    (ref ``_BN2d``): fp32 math on the input, cast back to its dtype;
    ``train=True`` normalises with the batch mean and biased variance and
    updates the running statistics (EMA decay 0.9) with the unbiased one,
    outside the autograd graph, and counts the batch in
    ``num_batches_tracked``; ``train=False`` uses the running statistics.
    ``F.batch_norm`` computes exactly that in one pass. Under a
    data-parallel forward (``parallel.mesh.global_batch``) the statistics
    are the global batch's."""

    momentum = 0.9  # EMA decay; torch's momentum is 1 - 0.9

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
            mesh = batch_mesh()
            if mesh is not None:
                return self._global_batch_norm(x, mesh)
        y = F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                         self.bias, training=train, momentum=1 - self.momentum, eps=self.eps)
        return y.to(x.dtype)

    def _global_batch_norm(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """Train mode over the global batch of a data-parallel forward: its
        statistics (``layers.global_moments``), the running ones updated
        with them as ``F.batch_norm`` updates them."""
        x32 = x.float()
        mean, var, n = global_moments(x32, (0, 2, 3), mesh)
        with torch.no_grad():
            self.running_mean.copy_(self.momentum * self.running_mean
                                    + (1 - self.momentum) * mean)
            self.running_var.copy_(self.momentum * self.running_var
                                   + (1 - self.momentum) * var * (n / max(n - 1, 1)))
        c = (1, -1, 1, 1)
        y = (x32 - mean.view(c)) * torch.rsqrt(var.view(c) + self.eps) * self.weight.view(c) \
            + self.bias.view(c)
        return y.to(x.dtype)


class Conv2d(nn.Module):
    """Bias-free conv with the ``nn.Conv2d`` weight layout (out, in, kh, kw),
    run in the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2  # SAME for 3x3, VALID for 1x1
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.weight, self.weight[0].numel() ** -0.5, gen)  # lecun

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride, padding=self.padding)


def _avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    return F.avg_pool2d(x, window)


class Downsample(nn.Module):
    """The identity path's average pool (no parameters), ``0`` conv and ``1``
    BatchNorm (the reference's ``nn.Sequential`` keys)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.add_module("0", Conv2d(cin, cout, 1))
        self.add_module("1", BatchNorm2d(cout))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.stride > 1:
            x = _avg_pool(x, self.stride)
        return getattr(self, "1")(getattr(self, "0")(x), train)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        out = planes * self.expansion
        self.conv1, self.bn1 = Conv2d(inplanes, planes, 1), BatchNorm2d(planes)
        self.conv2, self.bn2 = Conv2d(planes, planes, 3), BatchNorm2d(planes)
        self.conv3, self.bn3 = Conv2d(planes, out, 1), BatchNorm2d(out)
        self.downsample = (Downsample(inplanes, out, stride)
                           if stride > 1 or inplanes != out else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out), train)
        identity = x if self.downsample is None else self.downsample(x, train)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling (ref ``AttentionPool2d``): (B, C, H, W) →
    (1 + HW, B, out)."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim + 1, embed_dim))
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim or embed_dim)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.positional_embedding, self.embed_dim ** -0.5, gen)
        for proj in (self.q_proj, self.k_proj, self.v_proj, self.c_proj):
            proj.init_(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C)
        mean = tokens.float().mean(dim=1, keepdim=True).to(tokens.dtype)
        tokens = torch.cat([mean, tokens], dim=1) + self.positional_embedding.to(tokens.dtype)
        heads, dh = self.num_heads, self.embed_dim // self.num_heads

        def split(t):
            return t.reshape(b, -1, heads, dh).transpose(1, 2)  # (B, heads, L, dh)

        q, k, v = (split(proj(tokens)) for proj in (self.q_proj, self.k_proj, self.v_proj))
        logits = bmm_f32(q * dh ** -0.5, k.transpose(-1, -2))
        probs = torch.softmax(logits, dim=-1).to(tokens.dtype)
        out = bmm_f32(probs, v, tokens.dtype)
        out = self.c_proj(out.transpose(1, 2).reshape(b, -1, self.embed_dim))
        return out.transpose(0, 1)  # (L, B, out), as the reference returns it


class ModifiedResNet(nn.Module):
    def __init__(self, layers: Tuple[int, int, int, int], output_dim: int, heads: int,
                 input_resolution: int, width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1, self.bn1 = Conv2d(3, width // 2, 3, stride=2), BatchNorm2d(width // 2)
        self.conv2, self.bn2 = Conv2d(width // 2, width // 2, 3), BatchNorm2d(width // 2)
        self.conv3, self.bn3 = Conv2d(width // 2, width, 3), BatchNorm2d(width)
        inplanes = width
        for i, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, 1))):  # layer4: stride 1
            planes = width * 2 ** i
            stage = [Bottleneck(inplanes, planes, stride)]
            inplanes = planes * Bottleneck.expansion
            stage += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
            self.add_module(f"layer{i + 1}", nn.ModuleList(stage))
        self.attnpool = AttentionPool2d(input_resolution, width * 32, heads, output_dim, dtype)

    def init_(self, gen: torch.Generator) -> None:
        """Seeded random init (the JAX package's distributions; BatchNorm
        starts at ones and zeros)."""
        for module in self.modules():
            if isinstance(module, Conv2d):
                module.init_(gen)
        self.attnpool.init_(gen)

    def forward(self, x: torch.Tensor, cv_emb: Optional[torch.Tensor] = None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) NHWC. ``cv_emb`` is unused: SIE applies to the ViT
        tower only. Returns (x3, x4, xproj)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x), train))
        x = _avg_pool(x, 2)
        maps = []
        for i in range(1, 5):
            for block in getattr(self, f"layer{i}"):
                x = block(x, train)
            maps.append(x)
        return maps[2], maps[3], self.attnpool(maps[3])


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C), summed in fp32 (``jnp.mean`` over a bf16 map)."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)
