"""Optimizers with the reference's per-parameter-group semantics.

ref mpreid_tpu/solver/optim.py::is_bias, ::is_classifier, ::bnneck_bias,
::stage_trainable, ::group_trees, ::OptState, ::Optimizer, ::make_optimizer,
::CenterOptimizer.

Parameters are named by the port's torch names (the reference state_dict's,
e.g. ``image_encoder.transformer.resblocks.0.attn.in_proj_bias``,
``bottleneck.bias``), and the predicates reach the JAX package's decisions
from them: a name whose last part holds ``bias`` is a bias
(``in_proj_bias``, ``out_proj.bias``, ``ln_1.bias``, ``bottleneck.bias``),
a name holding ``classifier`` is a classifier, and the BNNeck bias is never
trained. The towers' roots are ``image_encoder`` and ``text_encoder`` (the
JAX package's ``visual`` and ``text``).

``Optimizer.update`` is SGD (momentum), Adam (coupled L2: wd·p added to the
gradient, as torch's Adam) or AdamW (decoupled: lr·mult·wd·p added to the
step), per leaf, written in plain PyTorch and applied in place under
``no_grad``; it is not ``torch.optim.Adam``. Moments are stored as
``MOMENT_DTYPE`` (fp32 or bf16) with their math in fp32, and the step uses
the fresh fp32 moments. Where an Adam/AdamW leaf's update runs is
``route``: with ``FUSED_ADAM`` on, CUDA leaves of at least
``ops.adam.MIN_FUSED_SIZE`` elements take the per-leaf kernel
(``ops/adam.py::fused_adam_leaf``; ``kernel_route``), every other CUDA leaf
goes into one table that ``ops/adam.py::adam_leaves`` updates in one
launch, and CPU leaves (and SGD's) take the plain per-op update; all give
the same bits. Frozen parameters get neither gradients nor moments.
``apply`` updates a list of whole leaves or flat slices of them, each with
the route of its whole leaf, the table's in one call: the hook ZeRO-1
(``parallel/zero.py``) updates its slices through.

The step lives on the device, as the JAX optimizer's traced step count
does: ``OptState.step`` is an int32 counter and ``OptState.lr`` an fp32
buffer holding the step's base lr, both on the parameters' device.
``update`` counts the step in place and forms each leaf's scalars from the
two on the device (``step_scalars``: [lr·mult, 1 − b1^t, 1 − b2^t], as
``mpreid_tpu/solver/optim.py:258-272``), so no Python number of a step
enters its kernels: a CUDA graph that captured one update replays every
later one with its own step and lr (``engine/compiled.py``), and the eager
step takes the same route. ``set_lr`` writes the lr; ``update(..., lr)``
writes it first.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from mpreid_tpu_torch.ops.adam import (MIN_FUSED_SIZE, adam_leaf_plain, adam_leaves,
                                      fused_adam_leaf)

_VISUAL = "image_encoder"
_TEXT = "text_encoder"


def named_params(params) -> Dict[str, torch.Tensor]:
    """``{name: parameter}`` of a module, or a mapping as given."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def is_bias(name: str) -> bool:
    return "bias" in name.split(".")[-1]


def is_classifier(name: str) -> bool:
    return "classifier" in name


def bnneck_bias(name: str) -> bool:
    parts = name.split(".")
    return parts[0] in ("bottleneck", "bottleneck_proj") and parts[-1] == "bias"


def stage_trainable(params, stage: Optional[str]) -> Dict[str, bool]:
    """``{name: trainable}`` for a training stage (ref ``stage_trainable``)."""

    def pred(name: str) -> bool:
        if bnneck_bias(name):
            return False
        if stage in ("baseline", "stage2", None):
            return True
        if stage == "stage1a":
            return name.endswith("ctx_generic")
        if stage == "stage1b":
            return name.endswith("ctx_modality") or name.endswith("ctx_platform")
        if stage == "lora":
            return "lora" in name.split(".")[-1]
        root = name.split(".")[0]
        if stage == "stage2a":
            return not (root == _TEXT or "expert" in name or root == "prompt_learner")
        if stage == "stage2b":
            return "gate" in name or (root == _VISUAL and "experts" not in name)
        raise ValueError(f"Unknown stage {stage!r}")

    return {name: pred(name) for name in named_params(params)}


def group_trees(params, stage_cfg):
    """(``{name: lr multiplier}``, ``{name: weight decay}``) from the stage's
    solver block (ref ``group_trees``)."""
    bias_factor = getattr(stage_cfg, "BIAS_LR_FACTOR", 1)
    large_fc = getattr(stage_cfg, "LARGE_FC_LR", False)

    def lr_mult(name: str) -> float:
        m = 1.0
        if is_bias(name):
            m = float(bias_factor)
        if large_fc and is_classifier(name):
            m = 2.0
        return m

    names = named_params(params)
    decay = {n: float(stage_cfg.WEIGHT_DECAY_BIAS if is_bias(n) else stage_cfg.WEIGHT_DECAY)
             for n in names}
    return {n: lr_mult(n) for n in names}, decay


class OptState(NamedTuple):
    step: torch.Tensor           # updates taken: a 0-dim int32 counter on the device
    mu: Dict[str, torch.Tensor]  # first moment / momentum buffer (trainable leaves)
    nu: Dict[str, torch.Tensor]  # second moment (trainable leaves)
    lr: torch.Tensor             # the step's base lr: a 0-dim fp32 buffer on the device


def device_step(device, step: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(step counter, lr buffer) of an ``OptState`` on ``device``."""
    return (torch.full((), step, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


class Optimizer:
    """SGD / Adam / AdamW with per-leaf lr multiplier and weight decay.

    ``partition(params) → (train, frozen)``; ``init(params) → OptState``;
    ``update(grads, state, train, lr) → OptState`` updates ``train`` (and the
    moments) in place."""

    def __init__(self, name: str, params, stage_cfg, stage: Optional[str] = None,
                 trainable: Optional[Mapping[str, bool]] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if name not in ("SGD", "Adam", "AdamW"):
            raise ValueError(f"Unsupported optimizer {name!r}")
        self.name = name
        self.b1, self.b2, self.eps = b1, b2, eps
        self.momentum = getattr(stage_cfg, "MOMENTUM", 0.9)
        md = getattr(stage_cfg, "MOMENT_DTYPE", "float32")
        if md not in ("float32", "bfloat16"):
            raise ValueError(f"MOMENT_DTYPE must be 'float32' or 'bfloat16', got {md!r}")
        self.moment_dtype = torch.bfloat16 if md == "bfloat16" else torch.float32
        self.fused_adam = bool(getattr(stage_cfg, "FUSED_ADAM", False))
        self.trainable = dict(trainable) if trainable is not None \
            else stage_trainable(params, stage)
        lr_mult, wd = group_trees(params, stage_cfg)
        self.lr_mult = {k: v for k, v in lr_mult.items() if self.trainable[k]}
        self.wd = {k: v for k, v in wd.items() if self.trainable[k]}

    def partition(self, params):
        flat = named_params(params)
        train = {k: v for k, v in flat.items() if self.trainable[k]}
        frozen = {k: v for k, v in flat.items() if not self.trainable[k]}
        return train, frozen

    def init(self, params) -> OptState:
        train, _ = self.partition(params)

        def zeros():
            return {k: torch.zeros_like(p, dtype=self.moment_dtype,
                                        memory_format=torch.contiguous_format)
                    for k, p in train.items()}

        step, lr = device_step(next(iter(named_params(params).values())).device)
        return OptState(step=step, mu=zeros(), nu=zeros(), lr=lr)

    @staticmethod
    @torch.no_grad()
    def set_lr(state: OptState, lr: float) -> None:
        """Write the base lr of the next steps into ``state.lr`` (fp32)."""
        state.lr.fill_(lr)

    @torch.no_grad()
    def step_scalars(self, state: OptState) -> Dict[float, torch.Tensor]:
        """``{lr multiplier: scalars}`` of the step ``state.step`` counts,
        formed on the device from it and ``state.lr``: for Adam/AdamW the fp32
        (3,) tensor [lr·mult, 1 − b1^t, 1 − b2^t] the leaf update takes; for
        SGD the base lr itself."""
        mults = sorted(set(self.lr_mult.values()))
        if self.name == "SGD":
            return dict.fromkeys(mults, state.lr)
        t = state.step.float()
        bc1 = 1 - torch.pow(self.b1, t)
        bc2 = 1 - torch.pow(self.b2, t)
        return {m: torch.stack([state.lr * m, bc1, bc2]) for m in mults}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: OptState,
               train: Mapping[str, torch.Tensor], lr: Optional[float] = None) -> OptState:
        """One step in place: ``train`` and the moments updated, the step
        counted in ``state.step`` → ``state``. With ``lr`` it is written into
        ``state.lr`` first; without, the buffer's lr is taken."""
        if lr is not None:
            self.set_lr(state, lr)
        state.step.add_(1)
        scalars = self.step_scalars(state)
        self.apply([(k, p, state.mu[k], state.nu[k], grads[k], scalars[self.lr_mult[k]],
                     self.route(p)) for k, p in train.items()])
        return state

    @torch.no_grad()
    def apply(self, entries) -> None:
        """Every entry's step in place: an entry is (k, p, m, v, g, scalars,
        route), leaf ``k``'s parameter, moments and gradient (the whole leaf,
        or a flat slice of it), its entry of ``step_scalars`` and the whole
        leaf's ``route``. The "table" entries go to ``adam_leaves`` in one
        call, every other one to ``update_leaf``."""
        table = []
        for k, p, m, v, g, scalars, route in entries:
            if route == "table":
                table.append((p, m, v, g.contiguous(), scalars, self.wd[k]))
            else:
                self.update_leaf(k, p, m, v, g, scalars, route == "leaf")
        adam_leaves(table, self.b1, self.b2, self.eps, self.name == "AdamW")

    def kernel_route(self, p: torch.Tensor) -> bool:
        """Whether leaf ``p``'s update takes the fused Adam kernel: Adam or
        AdamW under ``FUSED_ADAM``, on the card, at least ``MIN_FUSED_SIZE``
        elements. ZeRO decides it from the whole leaf, never from its slice,
        and so does a leaf sliced over the model axis (its ``model_split``)."""
        split = getattr(p, "model_split", None)
        n = p.numel() if split is None else math.prod(split.full_shape)
        return self.fused_adam and p.is_cuda and n >= MIN_FUSED_SIZE

    def route(self, p: torch.Tensor) -> str:
        """Where leaf ``p``'s update runs: "leaf", the per-leaf kernel
        (``kernel_route``); "table", the one launch of ``adam_leaves`` that
        takes every other CUDA leaf of Adam or AdamW; "plain", the per-op
        update (a CPU leaf, or SGD)."""
        if self.name == "SGD":
            return "plain"
        if self.kernel_route(p):
            return "leaf"
        return "table" if p.is_cuda else "plain"

    @torch.no_grad()
    def update_leaf(self, k: str, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, scalars: torch.Tensor, fused: bool) -> None:
        """Leaf ``k``'s step in place on the "plain" or (``fused``) the
        "leaf" route, on ``p`` and its moments ``m``, ``v`` with gradient
        ``g``, all of one shape: the whole leaf, or (ZeRO,
        ``parallel/zero.py``) one flat slice of it; ``scalars`` is the leaf's
        entry of ``step_scalars``. Every operation is elementwise, so a
        slice's elements come out as the whole leaf's."""
        if self.name == "SGD":
            g = g + self.wd[k] * p  # coupled L2 (torch SGD)
            mu32 = self.momentum * m.float() + g
            p.sub_(scalars * mu32 * self.lr_mult[k])
            m.copy_(mu32)
            return
        (fused_adam_leaf if fused else adam_leaf_plain)(
            p, m, v, g.contiguous(), scalars, self.b1, self.b2, self.eps, self.wd[k],
            self.name == "AdamW")


def make_optimizer(cfg_stage, params, stage: Optional[str] = None,
                   trainable: Optional[Mapping[str, bool]] = None) -> Optimizer:
    """The stage's optimizer (ref make_optimizer*.py dispatch)."""
    return Optimizer(cfg_stage.OPTIMIZER_NAME, params, cfg_stage, stage, trainable)


class CenterOptimizer:
    """Plain SGD on the center-loss centers, the gradient rescaled by
    1/CENTER_LOSS_WEIGHT (ref processor/processor.py:80-84). Its lr is
    ``SOLVER.CENTER_LR``, fixed for the run (no schedule moves it)."""

    def __init__(self, lr: float, loss_weight: float):
        self.lr = lr
        self.loss_weight = loss_weight

    @torch.no_grad()
    def update(self, grad: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        """``centers`` updated in place (so a captured step writes the
        state's own tensor) → ``centers``."""
        return centers.sub_(self.lr * (grad / self.loss_weight))
