"""The (data, model) mesh over the process group, and its placement rules.

ref mpreid_tpu/parallel/mesh.py::make_mesh, ::mesh_from_cfg, ::param_spec,
::shard_variables, ::shard_batch, ::replicated.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with axes
``('data', 'model')`` and lets GSPMD place every array by
``param_spec``. The port's mesh is the process group itself: ``Mesh`` holds
the two axis sizes and the group, one rank per device. This slice ports the
data axis: parameters, buffers and optimizer state replicate (rank 0's are
broadcast once, ``replicated``); every rank feeds its contiguous block of
each global batch (``shard_batch``, ``data/loader.py::ShardedLoader``) and
the data-parallel step (``engine/steps.py``) gathers the per-sample outputs
and sums the gradients. ``MESH_MODEL > 1`` over more than one rank raises:
the model axis (tensor and expert parallelism, ``TPU.TP_TOWERS``) is a
later slice (ROADMAP A.11b, the model axis).

While a data-parallel forward runs, ``global_batch(mesh)`` makes the mesh
visible to the layers whose numbers depend on the whole batch: the
BatchNorms (``models/layers.py::BNNeck``, ``models/resnet.py::BatchNorm2d``)
then take the global batch's statistics, as GSPMD computes them, and the
MoE experts' dropout draws the global batch's mask.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Tuple

import torch

from . import collectives as C
from .dist import rank as _rank
from .dist import world_size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` × ``model`` ranks of ``group`` (None: the default group)."""

    data: int
    model: int = 1
    group: Any = None

    @property
    def rank(self) -> int:
        return _rank()

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(data: int = -1, model: int = 1, world: Optional[int] = None) -> Mesh:
    """The mesh over ``world`` ranks (the group's size by default); ``data``
    -1 takes every rank the model axis leaves."""
    n = world_size() if world is None else world
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n}")
    if model > 1 and n > 1:
        raise NotImplementedError(
            f"TPU.MESH_MODEL {model}: the model axis (tensor and expert parallelism) is not "
            "ported yet (ROADMAP A.11b, the model-axis slice)")
    return Mesh(data, model)


def mesh_from_cfg(cfg, world: Optional[int] = None) -> Mesh:
    return make_mesh(cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL, world)


def param_spec(name: str, tp_towers: bool = False) -> Tuple[Optional[str], ...]:
    """How the JAX package's ``param_spec`` places the parameter the port
    names ``name``, as a spec over the port's own (torch) layout: ``()``
    replicates; otherwise one entry per axis, ``"model"`` where the axis is
    split. Classifier weights split their class axis; MoE expert stacks
    their expert axis; the per-identity ``ctx_generic`` its class axis; and
    with ``tp_towers`` the Megatron pairs of every tower: ``in_proj`` (and
    ``lora_b``) and ``c_fc`` by output rows, ``out_proj`` and ``c_proj``
    weights by input columns. A margin head's ``weight`` (the JAX package's
    ``weight`` leaf, which it leaves replicated) has the classifier's port
    name, so it is placed as a classifier."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) >= 2 else ""
    if "classifier" in parts[0] and leaf == "weight":
        return ("model", None)          # (classes, in)
    if "experts" in parts and leaf.startswith("c_"):
        return ("model",)               # (E, ...)
    if leaf == "ctx_generic":
        return ("model",)               # (classes, n_ctx, dim)
    if tp_towers and "experts" not in parts:
        if leaf in ("in_proj_weight", "lora_b"):
            return ("model", None)      # column-parallel: output rows
        if leaf == "in_proj_bias":
            return ("model",)
        if parent == "out_proj" and leaf == "weight":
            return (None, "model")      # row-parallel: input columns
        if parent == "c_fc":
            return ("model", None) if leaf == "weight" else ("model",)
        if parent == "c_proj" and leaf == "weight":
            return (None, "model")
    return ()


def is_replicated(spec) -> bool:
    return not any(spec)


def replicated(model: torch.nn.Module, opt_state=None, centers: Optional[torch.Tensor] = None,
               group=None) -> None:
    """Rank 0's parameters, buffers, optimizer moments and centers on every
    rank, once, in place (the start of a data-parallel run)."""
    tensors = list(model.parameters()) + list(model.buffers())
    if opt_state is not None:
        tensors += list(opt_state.mu.values()) + list(opt_state.nu.values())
    if centers is not None:
        tensors.append(centers)
    with torch.no_grad():
        for t in tensors:
            C.broadcast(t.data, 0, group)


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
