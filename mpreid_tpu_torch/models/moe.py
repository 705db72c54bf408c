"""Mixture-of-Experts vision blocks.

ref mpreid_tpu/models/moe.py::topk_routing, ::load_balancing_loss,
::ExpertMLPs, ::MoEResidualAttentionBlock.

Dispatch is dense, as in the JAX package: every expert runs on every token
and the results are mixed by the (mostly zero) combine weights, so the
numerics are the JAX package's exactly. The three expert products are plain
GEMMs (the JAX package computes them in XLA, outside any Pallas kernel); the
block's attention goes through ``ops/attention.py::fused_attention`` like
every other block.

Rounding order of ``ExpertMLPs`` (ref ``:93-109``): each product sums in
fp32 and is cast to the activation dtype, then the bias is added in that
dtype, QuickGELU runs in that dtype, and the combine weights are cast to it
before the mix (which sums in fp32). The dense ``MLP`` computes its products
in the activation dtype instead, so in bf16 an upcycled block equals its
dense source only approximately; in fp32 exactly.

Experts are stacked parameters, ``experts.c_fc_weight`` (E, 4D, D),
``c_fc_bias`` (E, 4D), ``c_proj_weight`` (E, D, 4D), ``c_proj_bias`` (E, D):
each expert's slice is the torch ``nn.Linear`` layout. The state_dict holds
them in the reference layout (``experts.{m}.c_fc.weight`` …, what
mpreid_tpu/models/convert.py writes and reads), split and stacked by state
dict hooks. The gate is ``gate.weight`` (E, D), no bias.

Expert parallelism (``parallel/mesh.py::shard_module``, a model axis of
M ranks): ``ExpertMLPs`` holds its E/M experts of the stacked tensors
(``ep``). The dispatch stays dense: every token goes through each local
expert, weighted by that expert's combine column, and the fp32 mixes are
summed over the model group (``reduce_from_model``) before the one cast.
The tokens and the combine weights enter behind ``copy_to_model``, so the
gradients of the replicated attention, LayerNorm and router come out whole.
Dropout draws the whole (tokens, E, 4D) mask and keeps the local experts'
part, as one process draws it. The router and the aux loss stay replicated.

Expert selection: ``lax.top_k`` returns tied values lowest index first.
After ``switch_to_moe`` the gates are zero, so every token's probabilities
tie, and ``torch.topk`` promises no order among ties: experts are picked by
a stable descending sort instead.

Counters (``expert_layers``, beside the kernels' launch counters in
``engine/compiled.py::COUNTED``, so a graph replay adds its capture's
counts): each forward of ``ExpertMLPs`` adds 1 to ``launches`` and to
``rows`` the rows its expert products take (tokens × local experts under
the dense dispatch), from the hidden activation's shape, with no device
sync. Under expert parallelism ``rows`` is the rank's. Spans (``utils/tracing.py``):
``moe.route`` (gate and routing), ``moe.experts`` (the expert products)
and ``moe.mix`` (the weighted sum).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpreid_tpu_torch.ops.matmul import bmm_f32
from mpreid_tpu_torch.parallel import collectives as C
from mpreid_tpu_torch.parallel.mesh import batch_mesh
from mpreid_tpu_torch.utils.tracing import span

from .layers import LayerNorm, Linear, MultiHeadAttention, init_normal_, linear_bias_act, quick_gelu

_EXPERT_LEAVES = (("c_fc_weight", "c_fc.weight"), ("c_fc_bias", "c_fc.bias"),
                  ("c_proj_weight", "c_proj.weight"), ("c_proj_bias", "c_proj.bias"))


# the expert layers' counters (module docstring)
expert_layers = SimpleNamespace(launches=0, rows=0)


def top_k_indices(probs: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k) indices of each row's ``k`` largest values, ties lowest index
    first: ``jax.lax.top_k``'s order."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


def topk_routing(router_logits: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax in fp32 → top-k → renormalise → dense (N, E) combine weights
    (zero off the top-k) and the (N, top_k) selected experts."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    selected = top_k_indices(probs, top_k)
    top = probs.gather(-1, selected)
    top = top / top.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter(-1, selected, top), selected


def load_balancing_loss(router_logits: torch.Tensor, top_k: int, mesh=None) -> torch.Tensor:
    """The Switch-Transformer aux loss (ref ``load_balancing_loss``): the
    (top_k, E) share of tokens routed to each expert at each rank, times each
    expert's mean router probability, summed and scaled by E.

    With ``mesh`` (a data-parallel step; each rank holds its block of the
    tokens) both means are over the global batch's tokens: their sums are
    summed over the ranks, with a gradient, before the product, which is not
    linear in the batch (so the ranks' own losses would not average to it)."""
    num_experts = router_logits.shape[-1]
    weights = torch.softmax(router_logits.reshape(-1, num_experts).float(), dim=-1)
    mask = F.one_hot(top_k_indices(weights, top_k), num_experts).float()
    if mesh is None or mesh.data == 1:
        tokens_per_expert = mask.mean(dim=0)        # (top_k, E)
        prob_per_expert = weights.mean(dim=0)       # (E,)
    else:
        n = weights.shape[0] * mesh.data
        tokens_per_expert = C.all_reduce_sum(mask.sum(dim=0), mesh.group) / n
        prob_per_expert = C.sum_over_ranks(weights.sum(dim=0), mesh.group) / n
    return (tokens_per_expert * prob_per_expert).sum() * num_experts


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            experts: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep with 1 - ``rate``,
    scale the kept values by 1 / (1 - ``rate``); draws from ``gen`` (in a
    data-parallel forward, the global batch's mask, of which this rank keeps
    its rows). ``experts`` = (first, all): ``x`` (N, E/M, 4D) holds the
    local experts from ``first`` of ``all``, and the mask is drawn for all
    of them, this rank keeping its experts' part."""
    if gen is None:
        raise ValueError("MoE dropout in training needs the step's torch.Generator")
    keep_prob = 1.0 - rate
    mesh = batch_mesh()
    n = x.shape[0]
    shape = list(x.shape)
    if experts is not None:
        shape[1] = experts[1]
    if mesh is None:
        draw = torch.rand(shape, generator=gen, device=x.device)
    else:  # the global batch's draw (rank-major rows), this rank's rows of it
        shape[0] = n * mesh.data
        draw = torch.rand(shape, generator=gen, device=x.device)[mesh.rank * n:(mesh.rank + 1) * n]
    if experts is not None:
        draw = draw[:, experts[0]:experts[0] + x.shape[1]]
    keep = draw < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class ExpertMLPs(nn.Module):
    """E stacked transformer MLPs (D → 4D → D). ``ep``: the experts' model
    axis ``Split`` when this rank holds E/M of them (``num_experts`` stays E)."""

    ep = None

    def __init__(self, dim: int, num_experts: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.num_experts = num_experts
        self.dropout = dropout
        self.dtype = dtype
        e, d = num_experts, dim
        self.c_fc_weight = nn.Parameter(torch.empty(e, 4 * d, d))
        self.c_fc_bias = nn.Parameter(torch.empty(e, 4 * d))
        self.c_proj_weight = nn.Parameter(torch.empty(e, d, 4 * d))
        self.c_proj_bias = nn.Parameter(torch.empty(e, d))
        self._register_state_dict_hook(_split_experts)
        self.register_load_state_dict_pre_hook(_stack_experts)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.c_fc_weight, (2 * self.dim) ** -0.5, gen)
        init_normal_(self.c_proj_weight, self.dim ** -0.5, gen)
        nn.init.zeros_(self.c_fc_bias)
        nn.init.zeros_(self.c_proj_bias)

    def forward(self, x: torch.Tensor, combine: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (N, D) in the activation dtype, combine (N, E) → (N, D)."""
        n, dt = x.shape[0], self.dtype
        e, hidden = self.c_fc_weight.shape[0], 4 * self.dim  # the local experts
        experts = None
        if self.ep is not None:
            experts = (self.ep.offset, self.num_experts)
            x = C.copy_to_model(x, self.ep.axis)
            combine = C.copy_to_model(combine, self.ep.axis)[:, experts[0]:experts[0] + e]
        with span("moe.experts"):
            # every expert's c_fc in one (N, D) × (D, E·4D) product, fp32 sums
            h = linear_bias_act(x, self.c_fc_weight.to(dt).reshape(e * hidden, self.dim), None,
                                True)
            h = quick_gelu(h.reshape(n, e, hidden) + self.c_fc_bias.to(dt))
            expert_layers.launches += 1
            expert_layers.rows += h.shape[0] * h.shape[1]
            if train and self.dropout > 0:
                h = dropout(h, self.dropout, gen, experts)
            y = bmm_f32(h.transpose(0, 1), self.c_proj_weight.to(dt).transpose(1, 2), dt)
            y = y + self.c_proj_bias[:, None, :].to(dt)                   # (E, N, D)
        with span("moe.mix"):
            # mix by routing weight: products of two dt values are exact in fp32
            mixed = (y.float() * combine.to(dt).float().t()[:, :, None]).sum(dim=0)
            if self.ep is not None:
                mixed = C.reduce_from_model(mixed, self.ep.axis)
            return mixed.to(dt)


def _split_experts(module, state_dict, prefix, local_metadata):
    """The stacked leaves → the reference's ``experts.{m}.c_fc.weight`` …
    (a rank of an expert-parallel model: its own experts, by global index)."""
    for stacked, leaf in _EXPERT_LEAVES:
        t = state_dict.pop(prefix + stacked)
        first = module.ep.offset if t.shape[0] < module.num_experts else 0
        for m in range(t.shape[0]):
            state_dict[f"{prefix}{first + m}.{leaf}"] = t[m]
    return state_dict


def _stack_experts(module, state_dict, prefix, local_metadata, strict, missing_keys,
                   unexpected_keys, error_msgs):
    """The reference's per-expert keys → the stacked leaves (a key that is
    missing is left for ``load_state_dict`` to report)."""
    for stacked, leaf in _EXPERT_LEAVES:
        keys = [f"{prefix}{m}.{leaf}" for m in range(module.num_experts)]
        if all(k in state_dict for k in keys):
            state_dict[prefix + stacked] = torch.stack([state_dict.pop(k) for k in keys])


class MoEResidualAttentionBlock(nn.Module):
    """Pre-LN block whose MLP is a top-k routed mixture of experts:
    attention → LN → gate (or a routing decision given by an earlier block)
    → experts → residual (ref model.py:163-258)."""

    def __init__(self, dim: int, num_heads: int, num_experts: int, top_k: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.top_k = top_k
        self.dtype = dtype
        self.attn = MultiHeadAttention(dim, num_heads, dtype, lora_rank, lora_alpha)
        self.ln_1 = LayerNorm(dim)
        self.ln_2 = LayerNorm(dim)
        self.gate = Linear(dim, num_experts, bias=False)
        self.experts = ExpertMLPs(dim, num_experts, dropout, dtype)

    def init_(self, gen: torch.Generator) -> None:
        self.attn.init_(gen)
        self.gate.init_(gen)
        self.experts.init_(gen)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                routing: Optional[torch.Tensor] = None, train: bool = False,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """→ (output, router logits (N, E) fp32 or None when ``routing`` was
        given, combine weights (N, E))."""
        b, l, d = x.shape
        x = x + self.attn(self.ln_1(x), mask)
        flat = self.ln_2(x).reshape(-1, d)
        router_logits = None
        if routing is None:
            with span("moe.route"):
                router_logits = bmm_f32(flat[None], self.gate.weight.to(x.dtype).t()[None])[0]
                combine, _ = topk_routing(router_logits, self.top_k)
        else:
            combine = routing
        mixed = self.experts(flat, combine, train, gen)
        return x + mixed.reshape(b, l, d), router_logits, combine
