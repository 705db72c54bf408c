"""ZeRO-1: the optimizer moments sharded over the data axis.

ref mpreid_tpu/parallel/zero.py::ZeroOptimizer, ::zero_sharded.

Replicated data parallelism keeps Adam's two moments of every trainable
parameter on every rank. Under ``TPU.ZERO_OPT_STATE`` each rank owns one
contiguous slice of each ZeRO'd leaf's flattened, zero-padded moments
instead: it updates its slice of the parameter with the replicated
optimizer's own per-leaf math (``solver/optim.py::Optimizer.apply``, the
gradients being already summed over the ranks), and one all-gather of
the ranks' updated slices rebuilds the replicated parameters. The JAX
package states the same algorithm as shardings and lets GSPMD place the
collective; the port calls it.

The result is bitwise the replicated optimizer's (``tests/test_torch_zero.py``;
``chip_smoke.py`` phase 14c on the card):

* every operation of the update is elementwise, so a slice's elements come
  out as the whole leaf's;
* the route of an update (``Optimizer.route``) is decided from the whole
  leaf's size, never from the slice's: half of a leaf of
  ``MIN_FUSED_SIZE`` elements takes the per-leaf kernel exactly when the
  whole leaf does, and every other slice on the card joins the step's one
  table;
* the padding lanes are never updated and never read back;
* bf16 moments (``SOLVER.MOMENT_DTYPE``) round per element, slice or not.

Slices are a multiple of ``collectives.ALIGN`` elements (and so are the
gradients' offsets in their buckets), so every rank's slice of a parameter,
a gradient and a moment starts 32-byte aligned, as the Adam kernel's
16-byte vector loads need. Only leaves that ``model_specs``
replicates are ZeRO'd; the others (classifier weights, expert stacks,
``ctx_generic`` and, under ``TPU.TP_TOWERS``, the towers' Megatron pairs,
which the model axis splits) keep their model-axis layout and hold whole
moments over the data axis, the JAX package's rule
(mpreid_tpu/parallel/zero.py:143). On a 2-D mesh everything here runs over
the data group (``Mesh.group``, ``Mesh.rank``). A checkpoint holds the moments gathered to the parameters'
shapes (``gathered``, the replicated optimizer's layout), so it resumes
under ZeRO or not, at any world size; ``sharded`` cuts a loaded one back to
this rank's slices.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from mpreid_tpu_torch.solver.optim import Optimizer, OptState, device_step, named_params

from . import collectives as C
from .collectives import ALIGN
from .mesh import Mesh, is_replicated, model_specs


def shard_length(n: int, ranks: int) -> int:
    """Elements of each rank's slice of a leaf of ``n`` elements."""
    per = -(-n // ranks)
    return -(-per // ALIGN) * ALIGN


class ZeroOptimizer(Optimizer):
    """``Optimizer`` whose ZeRO'd moments are this rank's slices. Build it
    with ``zero_sharded``; pass it to ``initial_state`` and the train step."""

    mesh: Mesh = None
    zero_keys: frozenset = frozenset()

    def span(self, n: int) -> Tuple[int, int, int]:
        """(start, stop, slice length) of this rank's slice of a leaf of
        ``n`` elements; stop - start is short on the last rank (or 0)."""
        s = shard_length(n, self.mesh.data)
        lo = min(self.mesh.rank * s, n)
        return lo, min(lo + s, n), s

    def init(self, params) -> OptState:
        train, _ = self.partition(params)

        def zeros():
            return {k: torch.zeros(self.span(p.numel())[2], dtype=self.moment_dtype,
                                   device=p.device)
                    if k in self.zero_keys else
                    torch.zeros_like(p, dtype=self.moment_dtype,
                                     memory_format=torch.contiguous_format)
                    for k, p in train.items()}

        step, lr = device_step(next(iter(named_params(params).values())).device)
        return OptState(step=step, mu=zeros(), nu=zeros(), lr=lr)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: OptState,
               train: Mapping[str, torch.Tensor], lr: Optional[float] = None) -> OptState:
        if lr is not None:
            self.set_lr(state, lr)
        state.step.add_(1)
        scalars = self.step_scalars(state)
        entries = []
        for k, p in train.items():
            entry = (scalars[self.lr_mult[k]], self.route(p))
            if k not in self.zero_keys:
                entries.append((k, p, state.mu[k], state.nu[k], grads[k], *entry))
                continue
            lo, hi, _ = self.span(p.numel())
            if hi > lo:
                entries.append((k, p.view(-1)[lo:hi], state.mu[k][:hi - lo],
                                state.nu[k][:hi - lo], grads[k].reshape(-1)[lo:hi], *entry))
        self.apply(entries)
        zeroed = {k: p for k, p in train.items() if k in self.zero_keys}
        self._gather_slices(zeroed, lambda k, lo, hi: zeroed[k].view(-1)[lo:hi])
        return state

    def _gather_slices(self, leaves: Mapping[str, torch.Tensor], local) -> None:
        """Every rank's slice of each of ``leaves`` written into the leaf on
        every rank (one all-gather of one flat buffer per dtype);
        ``local(k, lo, hi)`` is this rank's elements lo..hi of leaf ``k``."""
        by_dtype: Dict[torch.dtype, list] = {}
        for k, leaf in leaves.items():
            by_dtype.setdefault(leaf.dtype, []).append(k)
        for dtype, keys in by_dtype.items():
            spans = [self.span(leaves[k].numel()) for k in keys]
            total = sum(s for _, _, s in spans)
            send = torch.zeros(total, dtype=dtype, device=leaves[keys[0]].device)
            off = 0
            for k, (lo, hi, s) in zip(keys, spans):
                send[off:off + hi - lo] = local(k, lo, hi)
                off += s
            recv = C.all_gather(send, self.mesh.group).view(self.mesh.data, total)
            off = 0
            for k, (_, _, s) in zip(keys, spans):
                leaf = leaves[k]
                full = recv[:, off:off + s].reshape(-1)[:leaf.numel()]
                leaf.view(-1).copy_(full)
                off += s

    def gathered(self, state: OptState, params) -> OptState:
        """The moments at the parameters' shapes, gathered from every rank
        (a collective: every rank calls it), for a checkpoint."""
        train, _ = self.partition(params)
        out = {}
        for name in ("mu", "nu"):
            moments = getattr(state, name)
            full = {k: moments[k] if k not in self.zero_keys else
                    torch.empty(p.shape, dtype=self.moment_dtype, device=p.device)
                    for k, p in train.items()}
            # in the parameters' order, the same on every rank (a frozenset's
            # order is not: string hashes are salted per process)
            self._gather_slices({k: full[k] for k in train if k in self.zero_keys},
                                lambda k, lo, hi, m=moments: m[k][:hi - lo])
            out[name] = full
        return state._replace(mu=out["mu"], nu=out["nu"])

    def sharded(self, name: str, moment: torch.Tensor) -> torch.Tensor:
        """This rank's slice of leaf ``name``'s whole moment (as
        ``gathered`` returns it), zero-padded; other leaves as given."""
        if name not in self.zero_keys:
            return moment
        lo, hi, s = self.span(moment.numel())
        out = torch.zeros(s, dtype=moment.dtype, device=moment.device)
        out[:hi - lo] = moment.reshape(-1)[lo:hi]
        return out


def zero_sharded(base: Optimizer, mesh: Mesh, model: torch.nn.Module,
                 tp_towers: bool = False) -> ZeroOptimizer:
    """``base`` (built for ``model``) with its moments ZeRO'd over
    ``mesh``'s data axis: every configured attribute is shared; only
    trainable leaves that ``model_specs`` replicates are ZeRO'd
    (``tp_towers`` as the run's)."""
    z = ZeroOptimizer.__new__(ZeroOptimizer)
    z.__dict__.update(base.__dict__)
    z.mesh = mesh
    specs = model_specs(model, tp_towers)
    z.zero_keys = frozenset(k for k, t in base.trainable.items()
                            if t and is_replicated(specs[k]))
    return z


def optimizer_state_bytes(state: OptState) -> int:
    """Bytes of the moments this rank holds."""
    return sum(t.numel() * t.element_size() for d in (state.mu, state.nu) for t in d.values())
