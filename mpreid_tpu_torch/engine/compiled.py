"""Whole epochs as CUDA graphs: the port's counterpart of ``jax.jit`` over
a step body.

ref mpreid_tpu/engine/steps.py::make_train_epoch, ::make_stage1_epoch: the
JAX package runs an epoch's full batches as one compiled ``lax.scan``, so
an epoch makes no host round-trip. On the card the counterpart of one such
program is a CUDA graph: ``CompiledEpoch.run`` captures the step body once
per key into a ``torch.cuda.CUDAGraph`` and replays it for every row of the
epoch's (n_batches, B) index matrix, so a step costs the host one replay
(and two small copies) instead of issuing each of its thousands of kernels.

How a step is captured:

- Static inputs: the step reads its batch through one index buffer
  (``idx``, B int64) that each row is copied into, and gathers its rows on
  the device from tensors that stay put (the resident data set, the
  stage-1 bank). It updates the model, the moments, the step counter and
  the lr buffer (``solver/optim.py``) and the centers in place.
- Warm-up: the first ``WARMUP_STEPS`` rows of the first call run eagerly
  on a side stream (one per device, ``side_stream``). They are real steps of the epoch, and they do the
  first-use work a capture must not: the kernels' builds and
  ``cudaFuncSetAttribute`` calls, cuBLAS's workspace, autograd's
  accumulators, the augmentation's device constants. The last one also
  measures the offsets of the rematerialised blocks' draws
  (``models/vit.py::RematDraws``).
- Capture: on that side stream, with the step's generator (and the remat
  clones) registered with the graph, in ``thread_local`` error mode: only
  this thread's calls are checked, so a ``TPU.ASYNC_CHECKPOINT`` write on
  its own thread (host tensors only) cannot fail it. The capture runs the
  body's Python once and no kernel; it changes no host state but the
  kernels' launch counters, which are put back and then counted again for
  every replay (``COUNTED``).
- Replays: one per remaining row; each step's outputs (loss, accuracy) are
  copied out of the graph's static ones before the next replay. After the
  epoch the host holds the outputs as device vectors, which the caller
  reads once.

One graph at a time, keyed by the batch width, the generator and the
storage of every tensor the step binds (a model rebuilt by
``switch_to_moe``, or parameters given new storage, make a new key and so
a new capture: the old graph and its memory pool are released first).
``release()`` frees the graph; the epoch functions release theirs when the
loops end, and when they are dropped. A failed capture or replay raises;
nothing falls back to the eager loop. On the CPU (which only a caller that
puts the model there gets) every row runs the same body eagerly over the
same index buffer, so the CPU tests cover all of it but the capture.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from mpreid_tpu_torch.models.vit import RematDraws
from mpreid_tpu_torch.ops import adam, attention, batch_hard, pairwise

WARMUP_STEPS = 2


# the kernel wrappers whose launch counters a replay adds to
COUNTED = (attention.fused_attention, attention.fused_attention_bwd, adam.fused_adam_leaf,
           pairwise.l1_cross, pairwise.minsum_cross, batch_hard.fused_batch_hard)


def _counts() -> Dict[tuple, int]:
    """Every launch counter: (i, None) wrapper ``COUNTED[i]``'s total, (i,
    route) its count on ``route``."""
    out = {}
    for i, fn in enumerate(COUNTED):
        out[i, None] = fn.launches
        for route, n in getattr(fn, "launches_by_route", {}).items():
            out[i, route] = n
    return out


def _add_counts(delta: Dict[tuple, int]) -> None:
    for (i, route), n in delta.items():
        if route is None:
            COUNTED[i].launches += n
        else:
            COUNTED[i].launches_by_route[route] += n


_SIDE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream of ``device`` every warm-up and capture runs on: a new
    stream each time would get, and keep, cuBLAS workspace of its own."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def storage_key(tensors: Iterable[torch.Tensor]) -> tuple:
    """Where and how each tensor lies: a graph that binds them stays valid
    while this is unchanged."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


class CompiledEpoch:
    """Runs an epoch of one step body; on the card, as replays of one
    captured CUDA graph (module docstring)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise RuntimeError(f"a compiled epoch runs on cuda or cpu, not {self.device}")
        self.graph = None
        self.key = None
        self.idx: Optional[torch.Tensor] = None
        self.static: Tuple[torch.Tensor, ...] = ()
        self.draws: Optional[RematDraws] = None
        self.per_replay = None
        self.stats = dict(captures=0, replays=0, eager_steps=0, pool_bytes=0)

    def release(self) -> None:
        """Drop the graph, its static tensors and its memory pool."""
        had = self.graph is not None
        self.graph, self.key, self.static, self.draws, self.per_replay = None, None, (), None, None
        self.idx = None
        if had and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _index(self, width: int) -> torch.Tensor:
        if self.idx is None or self.idx.shape[0] != width:
            self.idx = torch.empty(width, dtype=torch.int64, device=self.device)
        return self.idx

    def run(self, step: Callable[[torch.Tensor], Sequence[torch.Tensor]], rows,
            gen: Optional[torch.Generator] = None,
            bound: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
        """``step(idx)`` for every row of ``rows`` (n, B) → its outputs (each
        a 0-dim tensor) stacked over the rows, on the device. ``step`` draws
        only from ``gen``; ``bound`` holds every tensor it reads or updates
        in place other than its own temporaries and ``idx``."""
        rows = torch.as_tensor(rows).to(self.device, torch.int64)
        n, width = rows.shape
        if n == 0:
            raise RuntimeError("an epoch of no batches")
        outs: List[Optional[torch.Tensor]] = [None]
        first = 0
        if self.device.type == "cpu":
            idx = self._index(width)
            for i in range(n):
                idx.copy_(rows[i])
                self._keep(outs, i, n, step(idx))
                self.stats["eager_steps"] += 1
            return tuple(outs[0])

        key = (width, id(gen), storage_key(bound))
        if self.graph is None or self.key != key:
            self.release()
            first = self._warm_up_and_capture(step, rows, gen, key, outs)
        idx = self.idx
        for i in range(first, n):
            idx.copy_(rows[i])
            if self.draws is not None:
                self.draws.before_replay()
            self.graph.replay()
            _add_counts(self.per_replay)
            self._keep(outs, i, n, self.static)
            self.stats["replays"] += 1
        return tuple(outs[0])

    @staticmethod
    def _keep(outs: list, i: int, n: int, values: Sequence[torch.Tensor]) -> None:
        """Copy step ``i``'s outputs into row ``i`` of the epoch's vectors."""
        if outs[0] is None:
            outs[0] = tuple(torch.empty(n, dtype=v.dtype, device=v.device) for v in values)
        for vec, v in zip(outs[0], values):
            vec[i].copy_(v.detach())

    def _warm_up_and_capture(self, step, rows, gen, key, outs) -> int:
        """The warm-up steps (eager, on a side stream), then the capture →
        the first row left to replay."""
        n, width = rows.shape
        w = min(WARMUP_STEPS, n)
        idx = self._index(width)
        draws = RematDraws(gen) if gen is not None else None
        current = torch.cuda.current_stream(self.device)
        side = side_stream(self.device)
        for i in range(w):
            idx.copy_(rows[i])
            side.wait_stream(current)
            last = draws is not None and i == w - 1
            with torch.cuda.stream(side), draws.recording() if last else nullcontext():
                values = step(idx)
            current.wait_stream(side)
            for v in values:
                v.record_stream(current)
            self._keep(outs, i, n, values)
            self.stats["eager_steps"] += 1
        if w == n:
            return n
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture does first: what it adds is the pool
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
            draws.register(graph)
        before = _counts()
        side.wait_stream(current)
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"), \
                draws.capturing() if draws is not None else nullcontext():
            static = tuple(v.detach() for v in step(idx))
        after = _counts()
        self.per_replay = {k: after[k] - before[k] for k in after}
        _add_counts({k: -c for k, c in self.per_replay.items()})  # the capture launched none
        self.graph, self.key, self.static = graph, key, static
        self.draws = draws if draws is not None and draws.clones else None
        self.stats["captures"] += 1
        self.stats["pool_bytes"] = torch.cuda.memory_reserved(self.device) - reserved
        return w
