"""CLIP VisionTransformer, dense path.

ref mpreid_tpu/models/vit.py::PatchEmbed, ::VisionTransformer.

The public input is NHWC, as in the JAX package. Patchify with stride equal
to the patch is a space-to-depth reshape plus one fp32-accumulated matmul
(no cuDNN, so no TF32); overlapping patches (stride < patch) unfold and
multiply in the activation dtype, as the JAX package's conv does. The
tower returns ``(x11, x12, xproj, router_logits)``: tokens after L-1
blocks, tokens after all L blocks through ``ln_post``, ``x12 @ proj``, and
None. With ``num_experts`` > 0 the first ``moe_layers`` blocks (-1: all)
are MoE blocks (models/moe.py); with ``shared_routing`` block 0's combine
weights route every later MoE block and only block 0's logits are kept.
Then ``router_logits`` is the (n_gating, N, E) fp32 stack and ``x11`` is
the last block's output (ref model.py:450-454), not the penultimate one's.
``train`` and ``gen`` reach the experts' dropout only.
``resize_pos_embed`` carries a CLIP file's square grid of positions to the
model's (h, w) grid.

``remat`` (``TPU.REMAT``, ref ``vit.py:150-152``, ``nn.remat`` on every
block) runs each block, dense and MoE alike, under
``torch.utils.checkpoint`` while gradients are on: the backward recomputes
the block's forward from its input instead of keeping its activations.
Results are unchanged, bit for bit; under ``no_grad`` (eval, the stage-1
bank) the blocks run plainly. The recompute draws the MoE experts' dropout
again from a copy of the step generator taken before the block, so it
draws the forward's mask and leaves the step's generator where the plain
forward leaves it, and it re-enters the forward's
``parallel.mesh.global_batch`` (the backward runs outside it), so a
data-parallel recompute draws the global batch's mask too. Collectives
inside a block (tensor-parallel towers, expert parallelism) run again in
the recompute, in the same order on every rank. A CUDA graph cannot read or
set a generator's state while it is captured, so a captured step
(``engine/compiled.py``) draws each recompute from a clone of the step
generator registered with the graph and placed, before every replay, where
the step generator stands at that block's forward (``RematDraws``).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mpreid_tpu_torch.parallel.mesh import batch_mesh, global_batch

from .layers import LayerNorm, ResidualAttentionBlock, init_normal_, linear_f32acc
from .moe import MoEResidualAttentionBlock


class PatchEmbed(nn.Module):
    """Bias-free patchify conv with the reference ``conv1.weight`` (w, 3, p, p)."""

    def __init__(self, patch_size: int, stride_size: int, width: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.stride_size = stride_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(width, 3, patch_size, patch_size))

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.weight, (3 * self.patch_size ** 2) ** -0.5, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, hw, width)."""
        p, s = self.patch_size, self.stride_size
        b, h, wd, c = x.shape
        width = self.weight.shape[0]
        if s == p:
            # VALID-conv semantics: crop a trailing remainder smaller than a patch
            x = x[:, : h // p * p, : wd // p * p, :]
            x = x.reshape(b, h // p, p, wd // p, p, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, (h // p) * (wd // p), p * p * c)
            # (w, 3, p, p) → rows ordered (py, px, c) like the patches
            w = self.weight.permute(0, 2, 3, 1).reshape(width, p * p * c)
            return linear_f32acc(x, w, None, self.dtype)
        cols = F.unfold(x.permute(0, 3, 1, 2).to(self.dtype), kernel_size=p, stride=s)
        w = self.weight.reshape(width, c * p * p).to(self.dtype)
        return torch.matmul(cols.transpose(1, 2), w.t())


class Transformer(nn.Module):
    """``resblocks``: ``n_moe`` MoE blocks, then dense ones."""

    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype,
                 lora_rank: int = 0, lora_alpha: float = 16.0, n_moe: int = 0,
                 num_experts: int = 0, top_k: int = 0, dropout: float = 0.0):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [MoEResidualAttentionBlock(width, heads, num_experts, top_k, dropout, dtype,
                                       lora_rank, lora_alpha) for _ in range(n_moe)]
            + [ResidualAttentionBlock(width, heads, dtype, lora_rank, lora_alpha)
               for _ in range(layers - n_moe)]
        )


class VisionTransformer(nn.Module):
    def __init__(self, h_resolution: int, w_resolution: int, patch_size: int,
                 stride_size: int, width: int, layers: int, heads: int,
                 output_dim: int, dtype: torch.dtype = torch.float32, lora_rank: int = 0,
                 lora_alpha: float = 16.0, num_experts: int = 0, top_k: int = 0,
                 moe_layers: int = 0, dropout: float = 0.0, shared_routing: bool = True,
                 remat: bool = False):
        super().__init__()
        self.width = width
        self.dtype = dtype
        self.remat = remat
        self.use_moe = num_experts > 0 and top_k > 0
        self.n_moe = (layers if moe_layers == -1 else min(moe_layers, layers)) \
            if self.use_moe else 0
        self.shared_routing = shared_routing
        self.conv1 = PatchEmbed(patch_size, stride_size, width, dtype)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(h_resolution * w_resolution + 1, width)
        )
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads, dtype, lora_rank, lora_alpha,
                                       self.n_moe, num_experts, top_k, dropout)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def init_(self, gen: torch.Generator) -> None:
        scale = self.width ** -0.5
        self.conv1.init_(gen)
        for p in (self.class_embedding, self.positional_embedding):
            init_normal_(p, scale, gen)
        for block in self.transformer.resblocks:
            block.init_(gen)
        init_normal_(self.proj, scale, gen)

    def forward(self, x: torch.Tensor, cv_emb: Optional[torch.Tensor] = None,
                train: bool = False, gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, H, W, 3) NHWC. Returns (x11, x12, xproj, router_logits)."""
        x = self.conv1(x)
        b = x.shape[0]
        cls = self.class_embedding.to(self.dtype).expand(b, 1, self.width)
        if cv_emb is not None:
            # SIE embedding added to the class token only (ref model.py:420-421)
            cls = cls + cv_emb[:, None, :].to(self.dtype)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(self.dtype)
        x = self.ln_pre(x)
        blocks = self.transformer.resblocks
        run = rematerialised if self.remat and torch.is_grad_enabled() else _plain
        router_logits = None
        if self.use_moe:
            routing, gating = None, []
            for i, block in enumerate(blocks[:self.n_moe]):
                x, logits, combine = run(block, x, routing=routing, train=train, gen=gen)
                if logits is not None:
                    gating.append(logits)
                if i == 0 and self.shared_routing:
                    routing = combine
            router_logits = torch.stack(gating) if gating else None
            for block in blocks[self.n_moe:]:
                x = run(block, x)
            x11 = x12 = x
        else:
            for block in blocks[:-1]:
                x = run(block, x)
            x11 = x
            x12 = run(blocks[-1], x11)
        x12 = self.ln_post(x12)
        xproj = linear_f32acc(x12, self.proj.t(), None, self.dtype)
        return x11, x12, xproj, router_logits


def _plain(block: nn.Module, x: torch.Tensor, **kw):
    return block(x, **kw)


class RematDraws:
    """The recompute draws of a captured step's rematerialised blocks.

    Eagerly the recompute draws from a generator set to a snapshot of the
    step generator ``gen`` taken before the block. Under CUDA graph capture
    a generator's state is read from device memory at each replay, and a
    snapshot taken on the host would be the capture's, so instead: an eager
    step measures how far ``gen`` has advanced within the step at each
    rematerialised block's forward (``recording``), since a generator's
    state cannot be cloned inside a capture and a registered clone draws
    from its own host offset at each replay; one clone of ``gen``
    per such block is registered with the graph (``register``); in the
    capture each block's recompute draws from its clone (``capturing``);
    and before every replay each clone is put at ``gen``'s offset plus its
    block's (``before_replay``), where the forward's draws start. The
    forward itself draws from ``gen``, so it advances as without remat."""

    _active: Optional["RematDraws"] = None

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self.mode = ""
        self.offsets: List[int] = []  # each block's start within the step
        self.clones: List[torch.Generator] = []
        self._start = 0
        self._next = 0

    @contextlib.contextmanager
    def _as(self, mode: str):
        RematDraws._active, self.mode = self, mode
        try:
            yield self
        finally:
            RematDraws._active, self.mode = None, ""

    @contextlib.contextmanager
    def recording(self):
        """An eager step that measures each block's offset."""
        self.offsets, self._start = [], self.gen.get_offset()
        with self._as("record"):
            yield self

    def register(self, graph) -> None:
        self.clones = [self.gen.clone_state() for _ in self.offsets]
        for clone in self.clones:
            graph.register_generator_state(clone)

    @contextlib.contextmanager
    def capturing(self):
        self._next = 0
        with self._as("capture"):
            yield self
        if self._next != len(self.clones):
            raise RuntimeError(f"the captured step rematerialised {self._next} blocks with the "
                               f"step generator; the eager step {len(self.clones)}")

    def before_replay(self) -> None:
        seed, base = self.gen.initial_seed(), self.gen.get_offset()
        for clone, offset in zip(self.clones, self.offsets):
            clone.manual_seed(seed)
            clone.set_offset(base + offset)

    @staticmethod
    def active_for(gen) -> Optional["RematDraws"]:
        draws = RematDraws._active
        return draws if draws is not None and gen is not None and draws.gen is gen else None

    def recompute_generator(self) -> Optional[torch.Generator]:
        """At a block's forward: under ``recording`` note its offset (None);
        under ``capturing`` the clone its recompute draws from."""
        if self.mode == "record":
            self.offsets.append(self.gen.get_offset() - self._start)
            return None
        if self._next >= len(self.clones):
            raise RuntimeError("the captured step rematerialises more blocks with the step "
                               "generator than the eager step did")
        self._next += 1
        return self.clones[self._next - 1]


def rematerialised(block: nn.Module, x: torch.Tensor, **kw):
    """``block(x, **kw)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward. A ``gen`` in ``kw`` (the
    MoE experts' dropout) is snapshot first; the recompute draws from a
    generator restored to the snapshot, so the step's own generator advances
    once, as without remat. The recompute runs under the forward's
    ``global_batch`` mesh. No global RNG is touched, so none is stashed."""
    mesh = batch_mesh()
    gen = kw.get("gen")
    draws = RematDraws.active_for(gen)
    captured = draws.recompute_generator() if draws is not None else None
    snapshot = None if gen is None or captured is not None else gen.get_state()
    forwarded = False

    def run(x):
        nonlocal forwarded
        args = kw
        if forwarded and captured is not None:  # a captured recompute (RematDraws)
            args = dict(kw, gen=captured)
        elif forwarded and gen is not None:  # the recompute: the forward's draws again
            args = dict(kw, gen=torch.Generator(device=gen.device))
            args["gen"].set_state(snapshot)
        forwarded = True
        with global_batch(mesh):
            return block(x, **args)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def resize_pos_embed(posemb: torch.Tensor, gs_new_h: int, gs_new_w: int) -> torch.Tensor:
    """Bilinearly resize a (1 + gs_old², D) positional embedding to a
    (1 + gs_new_h·gs_new_w, D) one, in fp32 (ref ``resize_pos_embed``:
    ``F.interpolate`` bilinear, align_corners=False, no antialias — what
    ``jax.image.resize`` 'linear' with antialias off computes). The first
    row (the class or mean token) is kept as it is."""
    posemb = posemb.float()
    token, grid = posemb[:1], posemb[1:]
    gs_old = int(math.sqrt(grid.shape[0]))
    d = grid.shape[-1]
    grid = grid.reshape(1, gs_old, gs_old, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gs_new_h, gs_new_w), mode="bilinear",
                         align_corners=False, antialias=False)
    return torch.cat([token, grid.permute(0, 2, 3, 1).reshape(gs_new_h * gs_new_w, d)])
