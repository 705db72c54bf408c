"""The (data, model) mesh over the process group, and its placement rules.

ref mpreid_tpu/parallel/mesh.py::make_mesh, ::mesh_from_cfg, ::param_spec,
::shard_variables, ::shard_batch, ::replicated.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with axes
``('data', 'model')`` and lets GSPMD place every array by ``param_spec``.
The port's mesh is the process group itself, one rank per device: rank
``r`` sits at ``(r // model, r % model)``, the order of the JAX package's
``devices.reshape(data, model)``. ``Mesh.group`` is this rank's **data
group** (the ranks that share its model index; the default group when the
model axis is 1) and ``Mesh.model_group`` its **model group** (the ranks
that share its data index).

The data axis: every rank of a data group feeds its contiguous block of
each global batch (``shard_batch``, ``data/loader.py::ShardedLoader``); the
data-parallel step (``engine/steps.py``) gathers the per-sample outputs and
sums the gradients over the data group.

The model axis: ``shard_module`` keeps on each rank only its slice of every
parameter that ``param_spec`` splits and tells the layers that hold them,
which then compute their part and meet through the Megatron pair
(``collectives.copy_to_model``, ``collectives.reduce_from_model``):

* the bias-free classifiers and the per-identity ``ctx_generic`` by class
  rows, split unevenly where the model axis does not divide the classes (751
  over two ranks: 376 + 375), as GSPMD pads; the class-parallel losses
  (``losses/softmax.py``) reduce over the model group;
* the MoE expert stacks by expert;
* with ``tp_towers`` (``TPU.TP_TOWERS``) the towers' Megatron pairs:
  ``in_proj`` (and ``lora_b``) and ``c_fc`` by output rows, ``out_proj`` and
  ``c_proj`` by input columns. The packed ``in_proj`` is [q|k|v]: rank ``m``
  takes rows ``[m·d/M, (m+1)·d/M)`` of each of q, k and v, whole heads.

A margin head's ``weight`` stays replicated, as the JAX package's ``weight``
leaf does. ``full_state_dict`` gathers the whole tensors back (checkpoints,
checks) and ``load_full_state_dict`` slices a whole state dict in.

While a data-parallel forward runs, ``global_batch(mesh)`` makes the mesh
visible to the layers whose numbers depend on the whole batch: the
BatchNorms (``models/layers.py::BNNeck``, ``models/resnet.py::BatchNorm2d``)
then take the global batch's statistics over the data group, as GSPMD
computes them, and the MoE experts' dropout draws the global batch's mask.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from . import collectives as C
from .dist import rank as _rank
from .dist import world_size


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis: ``size`` ranks, this one at
    ``index``, joined by ``group`` (the mesh's model group). The layers that
    hold a slice keep it (``shard_module``)."""

    size: int
    index: int
    group: Any = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` × ``model`` ranks. ``group`` is the data group (None: the
    default group, whose ranks are the data axis when ``model`` is 1) and
    ``model_group`` the model group (None when ``model`` is 1)."""

    data: int
    model: int = 1
    group: Any = None
    model_group: Any = None

    @property
    def rank(self) -> int:
        """This rank's index on the data axis."""
        return _rank() // self.model

    @property
    def model_rank(self) -> int:
        """This rank's index on the model axis."""
        return _rank() % self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def model_axis(self) -> ModelAxis:
        return ModelAxis(self.model, self.model_rank, self.model_group)


_GROUPS: Dict[Tuple[int, int], Tuple[Any, Any]] = {}


def _axis_groups(data: int, model: int) -> Tuple[Any, Any]:
    """(data group, model group) of this rank. Every rank creates every group
    of the mesh, in one order (``new_group`` is collective over the default
    group); made once per process group and shape."""
    key = (id(dist.group.WORLD), data, model)
    if key not in _GROUPS:
        me = _rank()
        mine = [None, None]
        for m in range(model):  # data groups: one model index each
            g = dist.new_group([d * model + m for d in range(data)])
            if me % model == m:
                mine[0] = g
        for d in range(data):  # model groups: one data index each
            g = dist.new_group([d * model + m for m in range(model)])
            if me // model == d:
                mine[1] = g
        _GROUPS[key] = tuple(mine)
    return _GROUPS[key]


def make_mesh(data: int = -1, model: int = 1, world: Optional[int] = None) -> Mesh:
    """The mesh over ``world`` ranks (the group's size by default); ``data``
    -1 takes every rank the model axis leaves. With a model axis over a
    process group of more than one rank, its data and model groups are made
    (every rank must call this, in the same order)."""
    n = world_size() if world is None else world
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n}")
    if model > 1 and dist.is_initialized() and world_size() == n:
        return Mesh(data, model, *_axis_groups(data, model))
    return Mesh(data, model)


def mesh_from_cfg(cfg, world: Optional[int] = None) -> Mesh:
    return make_mesh(cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL, world)


def param_spec(name: str, tp_towers: bool = False, margin: bool = False
               ) -> Tuple[Optional[str], ...]:
    """How the JAX package's ``param_spec`` places the parameter the port
    names ``name``, as a spec over the port's own (torch) layout: ``()``
    replicates; otherwise one entry per axis, ``"model"`` where the axis is
    split. Classifier weights split their class axis; MoE expert stacks
    their expert axis; the per-identity ``ctx_generic`` its class axis; and
    with ``tp_towers`` the Megatron pairs of every tower: ``in_proj`` and
    ``c_fc`` by output rows (``lora_b``, (r, 3d), by its columns),
    ``out_proj`` and ``c_proj`` weights by input columns.

    ``margin``: the classifier is a margin head (``MODEL.COS_LAYER``), whose
    ``weight`` has the plain classifier's port name but is the JAX package's
    ``weight`` leaf, which it replicates (its rule matches ``kernel`` only).
    ``model_specs`` says it for each parameter of a model."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) >= 2 else ""
    if "classifier" in parts[0] and leaf == "weight":
        return () if margin else ("model", None)  # (classes, in)
    if "experts" in parts and leaf.startswith("c_"):
        return ("model",)               # (E, ...)
    if leaf == "ctx_generic":
        return ("model",)               # (classes, n_ctx, dim)
    if tp_towers and "experts" not in parts:
        if leaf == "in_proj_weight":
            return ("model", None)      # column-parallel: output rows
        if leaf == "lora_b":
            return (None, "model")      # (r, 3d): the output columns
        if leaf == "in_proj_bias":
            return ("model",)
        if parent == "out_proj" and leaf == "weight":
            return (None, "model")      # row-parallel: input columns
        if parent == "c_fc":
            return ("model", None) if leaf == "weight" else ("model",)
        if parent == "c_proj" and leaf == "weight":
            return (None, "model")
    return ()


def model_specs(model: torch.nn.Module, tp_towers: bool = False) -> Dict[str, tuple]:
    """``{name: param_spec}`` of every parameter of ``model``, margin heads
    told apart by their module."""
    from mpreid_tpu_torch.models.layers import MarginHead

    margin = {name for name, m in model.named_modules() if isinstance(m, MarginHead)}
    return {name: param_spec(name, tp_towers, name.rpartition(".")[0] in margin)
            for name, _ in model.named_parameters()}


def is_replicated(spec) -> bool:
    return not any(spec)


# ---------------------------------------------------------------------------
# the model axis: slices of parameters
# ---------------------------------------------------------------------------

def split_sizes(n: int, ranks: int) -> Tuple[int, ...]:
    """Rows of each rank when ``n`` rows split over ``ranks``: the first
    ``n % ranks`` ranks take one more (751 over 2: 376, 375)."""
    return tuple(n // ranks + (i < n % ranks) for i in range(ranks))


@dataclasses.dataclass(frozen=True)
class Split:
    """How a parameter of ``full_shape`` is cut over the model axis: along
    ``dim``, in ``parts`` equal blocks (3 for a packed [q|k|v] leaf, else
    1), each cut into the ranks' ``sizes``; the rank keeps its piece of each
    block. ``shard_module`` stores it on the parameter as ``model_split``."""

    dim: int
    sizes: Tuple[int, ...]
    parts: int
    full_shape: Tuple[int, ...]
    axis: ModelAxis

    @property
    def offset(self) -> int:
        return sum(self.sizes[:self.axis.index])

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``full``."""
        lo, n = self.offset, self.sizes[self.axis.index]
        block = full.shape[self.dim] // self.parts
        return torch.cat([full.narrow(self.dim, j * block + lo, n) for j in range(self.parts)],
                         dim=self.dim)

    @torch.no_grad()
    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice (a collective over the
        model group): each rank writes its pieces into a zero-filled whole
        and the wholes are summed, which is exact."""
        full = torch.zeros(self.full_shape, dtype=local.dtype, device=local.device)
        lo, n = self.offset, self.sizes[self.axis.index]
        block = self.full_shape[self.dim] // self.parts
        for j in range(self.parts):
            full.narrow(self.dim, j * block + lo, n).copy_(local.detach().narrow(self.dim, j * n, n))
        return C.all_reduce_sum(full, self.axis.group)


def _split_of(name: str, p: torch.Tensor, spec, axis: ModelAxis) -> Split:
    dim = spec.index("model")
    leaf = name.rpartition(".")[2]
    parts = 3 if leaf in ("in_proj_weight", "in_proj_bias", "lora_b") else 1
    n = p.shape[dim] // parts
    return Split(dim, split_sizes(n, axis.size), parts, tuple(p.shape), axis)


def _check_divides(model: torch.nn.Module, mesh: Mesh, tp_towers: bool) -> None:
    from mpreid_tpu_torch.models.layers import MultiHeadAttention
    from mpreid_tpu_torch.models.moe import ExpertMLPs

    for name, m in model.named_modules():
        if isinstance(m, ExpertMLPs) and m.num_experts % mesh.model:
            raise ValueError(f"TPU.MESH_MODEL {mesh.model} does not divide the "
                             f"MODEL.MOE.NUM_EXPERTS {m.num_experts} experts of {name}")
        if tp_towers and isinstance(m, MultiHeadAttention) and m.num_heads % mesh.model:
            raise ValueError(f"TPU.MESH_MODEL {mesh.model} does not divide the {m.num_heads} "
                             f"heads of {name} (TPU.TP_TOWERS)")


@torch.no_grad()
def shard_module(model: torch.nn.Module, mesh: Mesh, tp_towers: bool = False
                 ) -> torch.nn.Module:
    """Keep on this rank only its slice of every parameter that
    ``param_spec`` splits over the model axis (the counterpart of the JAX
    package's ``shard_variables``), in place → ``model``. Each sliced
    parameter keeps its ``Split`` as ``model_split``; each layer that holds
    one is told (``tp``), and computes its part. Build the optimizer's
    moments after this: they take the slices' shapes. Raises ``ValueError``
    naming the key when the model axis does not divide a tower's heads
    (under ``tp_towers``) or the experts."""
    from mpreid_tpu_torch.models.layers import Linear, MultiHeadAttention
    from mpreid_tpu_torch.models.moe import ExpertMLPs
    from mpreid_tpu_torch.models.uniprompt import PromptLearner

    if mesh.model == 1:
        return model
    _check_divides(model, mesh, tp_towers)
    axis = mesh.model_axis
    specs = model_specs(model, tp_towers)
    for name, p in model.named_parameters():
        spec = specs[name]
        if is_replicated(spec) or hasattr(p, "model_split"):
            continue
        split = _split_of(name, p, spec, axis)
        p.data = split.local(p.data).contiguous()
        p.model_split = split
    for name, m in model.named_modules():
        w = getattr(m, "weight", None) if isinstance(m, Linear) else None
        if w is not None and hasattr(w, "model_split"):
            m.tp = (("row" if w.model_split.dim == 1 else "col"), w.model_split)
        elif isinstance(m, MultiHeadAttention) and hasattr(m.in_proj_weight, "model_split"):
            m.tp = axis
        elif isinstance(m, ExpertMLPs) and hasattr(m.c_fc_weight, "model_split"):
            m.ep = m.c_fc_weight.model_split
        elif isinstance(m, PromptLearner) and hasattr(m.ctx_generic, "model_split"):
            m.class_split = m.ctx_generic.model_split
    return model


def sharded_params(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """``{name: parameter}`` of the parameters ``shard_module`` sliced."""
    return {k: p for k, p in model.named_parameters() if hasattr(p, "model_split")}


@contextlib.contextmanager
def _whole(model: torch.nn.Module, fill):
    """Within the block every sliced parameter holds ``fill(name, p)`` (a
    whole tensor); after it, its slice of what it then holds."""
    params = sharded_params(model)
    saved = {k: p.data for k, p in params.items()}
    try:
        for k, p in params.items():
            p.data = fill(k, p)
        yield model
    except BaseException:
        for k, p in params.items():
            p.data = saved[k]
        raise
    for k, p in params.items():
        p.data = p.model_split.local(p.data).contiguous()


@torch.no_grad()
def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every sliced parameter whole (a
    collective over the model group: every rank calls it), in the layout of
    an unsliced model, detached copies on the parameters' devices."""
    if not sharded_params(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}
    with _whole(model, lambda k, p: p.model_split.gather(p.data)):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}


@torch.no_grad()
def load_full_state_dict(model: torch.nn.Module, state_dict, strict: bool = True) -> None:
    """Load a whole (unsliced) state dict into a model ``shard_module``
    sliced: each rank keeps its slices."""
    if not sharded_params(model):
        model.load_state_dict(state_dict, strict=strict)
        return
    with _whole(model, lambda k, p: torch.empty(p.model_split.full_shape, dtype=p.dtype,
                                                device=p.device)):
        model.load_state_dict(state_dict, strict=strict)


def gather_whole(tensors: Dict[str, torch.Tensor], model: torch.nn.Module
                 ) -> Dict[str, torch.Tensor]:
    """Tensors keyed by parameter name, each at its parameter's (sliced)
    shape (the parameters, their gradients, their optimizer moments), with
    the sliced ones gathered whole (a collective over the model group)."""
    params = sharded_params(model)
    return {k: params[k].model_split.gather(t) if k in params else t
            for k, t in tensors.items()}


def local_moment(name: str, whole: torch.Tensor, model: torch.nn.Module) -> torch.Tensor:
    """This rank's slice of parameter ``name``'s whole moment (unsliced
    parameters' as given)."""
    p = sharded_params(model).get(name)
    return whole if p is None else p.model_split.local(whole)


def replicated(model: torch.nn.Module, opt_state=None, centers: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None) -> None:
    """Rank 0's parameters, buffers, optimizer moments and centers on every
    rank, once, in place (the start of a data-parallel run). A parameter
    sliced over the model axis, and its moments, come from the rank of data
    index 0 that holds the same slice, over the data group."""
    sliced = sharded_params(model)
    tensors = [(p, k in sliced) for k, p in model.named_parameters()]
    tensors += [(b, False) for b in model.buffers()]
    if opt_state is not None:
        tensors += [(t, k in sliced) for d in (opt_state.mu, opt_state.nu) for k, t in d.items()]
    if centers is not None:
        tensors.append((centers, False))
    with torch.no_grad():
        for t, is_sliced in tensors:
            if is_sliced:  # global rank of (data 0, this model index)
                C.broadcast(t.data, mesh.model_rank, mesh.group)
            else:
                C.broadcast(t.data, 0, None)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's contiguous block of every array of a global batch dict
    (the leading axis); other entries as given."""
    def block(x):
        if getattr(x, "ndim", 0) >= 1:  # a tensor or an array
            n = x.shape[0]
            if n % mesh.data:
                raise ValueError(f"batch of {n} does not split over {mesh.data} ranks")
            per = n // mesh.data
            return x[mesh.rank * per:(mesh.rank + 1) * per]
        return x

    return {k: block(v) for k, v in batch.items()}


_ACTIVE: list = []


@contextlib.contextmanager
def global_batch(mesh: Optional[Mesh]):
    """Within the block, the layers whose numbers depend on the whole batch
    see ``mesh`` (``batch_mesh``) and reduce over its ranks."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def batch_mesh() -> Optional[Mesh]:
    """The mesh of the data-parallel forward that is running, or None."""
    mesh = _ACTIVE[-1] if _ACTIVE else None
    return mesh if mesh is not None and mesh.data > 1 else None
