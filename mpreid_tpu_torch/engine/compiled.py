"""Steps and whole epochs as CUDA graphs: the port's counterpart of
``jax.jit`` over a step body.

ref mpreid_tpu/engine/steps.py::make_train_step, ::make_eval_step,
::make_image_bank_step, ::make_text_step, ::make_stage1_step,
::make_train_epoch, ::make_stage1_epoch and mpreid_tpu/engine/ttpt.py::
_eval_feature_step_cached, ::_tta_query_step, ::_make_ttpt_tuner_cached: the
JAX package compiles each step, each whole-epoch ``lax.scan`` and the TTPT
tuner's ``lax.scan`` over its tuning steps, into one XLA program. On the
card the counterpart of one such program is a CUDA graph: the step body is captured
once per key into a ``torch.cuda.CUDAGraph`` and replayed, so a step costs
the host one replay and a few copies instead of issuing each of its
thousands of kernels. Two runners share one warm-up and one capture
(``_Graphed``):

- ``CompiledStep`` runs one call of a step (``make_train_step``,
  ``make_eval_step``, ``make_image_bank_step``, ``make_text_step``,
  ``make_stage1_step``; ``engine/ttpt.py``'s ``make_tta_query_step``,
  ``make_ttpt_query_step`` and ``make_ttpt_tuner``, whose body
  differentiates under ``enable_grad`` inside the capture). A call's key
  holds its inputs' shapes and dtypes, which optional inputs it has, the
  generator and the storage of every
  tensor the step binds. The first ``WARMUP_STEPS`` calls with a key run
  eagerly; the next one captures and replays, and every later one replays:
  its inputs (numpy arrays or tensors) are copied into the graph's static
  input buffers first, and its outputs come back as copies, never as the
  graph's static tensors, which the next replay overwrites. A key seen
  fewer times never captures and never evicts the graph held, so the text
  features' short last batch leaves the full-width graph in place.
- ``CompiledEpoch`` runs an epoch's (n_batches, B) index matrix: the step
  reads its batch through one index buffer (``idx``, B int64) that each row
  is copied into, and gathers its rows on the device from tensors that stay
  put (the resident data set, the stage-1 bank). The first
  ``WARMUP_STEPS`` rows of the first call run eagerly, the next captures,
  and every later row (and every row of later epochs) replays; each step's
  outputs are copied into the epoch's device vectors.

How a step is captured:

- Static state: the step updates the model, the moments, the step counter,
  the lr buffer (``solver/optim.py``) and the centers in place, so a graph
  that binds them stays valid while their storage does.
- Warm-up: on a side stream (one per device, ``side_stream``). The warm-up
  steps are real steps, and they do the first-use work a capture must not:
  the kernels' builds and ``cudaFuncSetAttribute`` calls, cuBLAS's
  workspace, autograd's accumulators, the preprocessing's device constants.
  The last one also measures the offsets of the rematerialised blocks'
  draws (``models/vit.py::RematDraws``).
- Capture: on that side stream, with the step's generator (and the remat
  clones) registered with the graph, in ``thread_local`` error mode: only
  this thread's calls are checked, so a ``TPU.ASYNC_CHECKPOINT`` write on
  its own thread (host tensors only) cannot fail it. The capture runs the
  body's Python once and no kernel; it changes no host state but the
  kernels' launch counters, which are put back and then counted again for
  every replay (``COUNTED``). A runner's ``capture_seconds`` sums the host
  time of its captures (instantiation included), apart from any replay:
  the durations of its ``compiled.capture`` spans, which time themselves
  whether or not a profiler records.

One graph at a time per runner: a new key that captures (a model rebuilt
by ``switch_to_moe``, parameters given new storage, another batch width)
releases the old graph and its memory pool first. Host state that the body
reads but the key does not hold (a module flag such as a tower's
``remat``) is fixed at the capture: make a new step after changing it.
``release()`` frees the graph and forgets the keys seen; the loops release
theirs when they end, and a dropped runner frees its own. A failed capture
or replay raises: nothing falls back to eager steps. A runner built with
``eager=True`` (a step over a mesh of more than one rank, whose gloo
collectives run on the host) runs every call eagerly on the current
stream, by the caller's decision made before the first step.

On the CPU (which only a caller that puts the model there gets) the same
decisions run with a stand-in for the graph whose replay calls the body
eagerly on the static inputs and copies its outputs into the static ones,
so the CPU tests cover all of it but the capture itself.

Spans (``utils/tracing.py``, recorded under a profiler): a call is
``compiled.step``, an epoch ``compiled.epoch``; inside them
``compiled.key`` (the key, ``storage_key`` over the bound tensors),
``compiled.upload`` (host inputs, or the epoch's rows, onto the device),
``compiled.warmup`` (an eager call or row), ``compiled.capture``,
``compiled.replay`` (one replay; an epoch's row copy into ``idx`` and the
copy of its outputs with it) and ``compiled.outputs`` (a step's clones).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from mpreid_tpu_torch.models.vit import RematDraws
from mpreid_tpu_torch.ops import adam, attention, batch_hard, pairwise
from mpreid_tpu_torch.utils.tracing import span, timed

WARMUP_STEPS = 2
KEYS_KEPT = 8  # the keys a CompiledStep counts calls of (the oldest forgotten first)


# the kernel wrappers whose launch counters a replay adds to
COUNTED = (attention.fused_attention, attention.fused_attention_bwd, adam.fused_adam_leaf,
           pairwise.l1_cross, pairwise.minsum_cross, batch_hard.fused_batch_hard,
           adam.adam_leaves)


def _counts() -> Dict[tuple, int]:
    """Every launch counter: (i, None) wrapper ``COUNTED[i]``'s launches, (i,
    route) its launches on ``route``, (i, "leaves") the leaves it updated
    (``adam_leaves``)."""
    out = {}
    for i, fn in enumerate(COUNTED):
        out[i, None] = fn.launches
        for route, n in getattr(fn, "launches_by_route", {}).items():
            out[i, route] = n
        if hasattr(fn, "leaves"):
            out[i, "leaves"] = fn.leaves
    return out


def _add_counts(delta: Dict[tuple, int]) -> None:
    for (i, key), n in delta.items():
        fn = COUNTED[i]
        if key is None:
            fn.launches += n
        elif key == "leaves":
            fn.leaves += n
        else:
            fn.launches_by_route[key] += n


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


class _EagerGraph:
    """The CPU's stand-in for a captured graph: ``replay()`` calls the body
    eagerly and writes its outputs into the static ones (the first
    replay's outputs become them), as a replay of a graph does."""

    def __init__(self, fn: Callable[[], Sequence[torch.Tensor]]):
        self.fn = fn
        self.static: Tuple[torch.Tensor, ...] = ()

    def replay(self) -> None:
        values = tuple(v.detach() for v in self.fn())
        if not self.static:
            self.static = values
            return
        for s, v in zip(self.static, values):
            with torch.inference_mode(s.is_inference()):
                s.copy_(v)


class _Graphed:
    """One captured graph (or its CPU stand-in) with its key, static
    outputs, remat draws and the launches a replay counts; the warm-up and
    the capture both runners share."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise RuntimeError(f"a compiled step runs on cuda or cpu, not {self.device}")
        self.graph = None
        self.key = None
        self.static: Tuple[torch.Tensor, ...] = ()
        self.draws: Optional[RematDraws] = None
        self.per_replay = None
        self.stats = dict(captures=0, replays=0, eager_steps=0, pool_bytes=0)
        self.capture_seconds = 0.0  # host seconds spent capturing, over every capture

    def release(self) -> None:
        """Drop the graph, its static tensors and its memory pool."""
        had = self.graph is not None
        self.graph, self.key, self.static, self.draws, self.per_replay = None, None, (), None, None
        if had and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _warm_up(self, fn: Callable[[], Sequence[torch.Tensor]],
                 draws: Optional[RematDraws] = None) -> Tuple[torch.Tensor, ...]:
        """``fn()`` eagerly, on the card on the side stream (under
        ``draws.recording()`` when given), its outputs handed back to the
        current stream."""
        self.stats["eager_steps"] += 1
        if self.device.type == "cpu":
            return tuple(fn())
        current = torch.cuda.current_stream(self.device)
        side = side_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side), draws.recording() if draws is not None else nullcontext():
            values = tuple(fn())
        current.wait_stream(side)
        for v in values:
            v.record_stream(current)
        return values

    def _capture(self, fn: Callable[[], Sequence[torch.Tensor]], key,
                 gen: Optional[torch.Generator], draws: Optional[RematDraws]) -> None:
        """Capture ``fn()`` into the graph held from now on under ``key``;
        ``draws`` (recorded by the last warm-up) serves ``gen``'s remat
        recomputes. Nothing runs until the first ``_replay``."""
        self.stats["captures"] += 1
        if self.device.type == "cpu":
            with timed("compiled.capture") as clock:
                self.graph, self.key, self.static, self.per_replay = _EagerGraph(fn), key, (), {}
            self.capture_seconds += clock.seconds
            return
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture does first: what it adds is the pool
        reserved = torch.cuda.memory_reserved(self.device)
        with timed("compiled.capture") as clock:
            graph = torch.cuda.CUDAGraph()
            if gen is not None:
                draws = draws if draws is not None else RematDraws(gen)
                graph.register_generator_state(gen)
                draws.register(graph)
            before = _counts()
            current, side = torch.cuda.current_stream(self.device), side_stream(self.device)
            side.wait_stream(current)
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"), \
                    draws.capturing() if draws is not None else nullcontext():
                static = tuple(v.detach() for v in fn())
            after = _counts()
            self.per_replay = {k: after[k] - before[k] for k in after}
            _add_counts({k: -c for k, c in self.per_replay.items()})  # the capture launched none
            self.graph, self.key, self.static = graph, key, static
            self.draws = draws if draws is not None and draws.clones else None
        self.capture_seconds += clock.seconds
        self.stats["pool_bytes"] = torch.cuda.memory_reserved(self.device) - reserved

    def _replay(self) -> None:
        if self.draws is not None:
            self.draws.before_replay()
        self.graph.replay()
        if isinstance(self.graph, _EagerGraph):
            self.static = self.graph.static
        _add_counts(self.per_replay)
        self.stats["replays"] += 1


class CompiledStep(_Graphed):
    """Runs one call of a step body; on the card, from the third call with
    a key on, as a replay of one captured CUDA graph (module docstring)."""

    def __init__(self, device: torch.device, eager: bool = False):
        super().__init__(device)
        self.eager = eager
        self.inputs: Tuple[Optional[torch.Tensor], ...] = ()
        self.seen: Dict[tuple, int] = {}  # calls of each key, oldest first
        self._draws: Dict[tuple, RematDraws] = {}

    def release(self) -> None:
        super().release()
        self.inputs, self.seen, self._draws = (), {}, {}

    def _upload(self, host) -> list:
        return [None if a is None else a.to(self.device, non_blocking=True) for a in host]

    def __call__(self, body: Callable[..., Sequence[torch.Tensor]], inputs: Sequence,
                 gen: Optional[torch.Generator] = None,
                 bound: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
        """``body(*inputs)`` with the inputs on the device → its outputs.
        ``inputs`` are numpy arrays, tensors or None (an absent optional
        input); ``body`` draws only from ``gen``, and ``bound`` holds every
        tensor it reads or updates in place other than its inputs and its
        own temporaries."""
        with span("compiled.step"):
            return self._call(body, inputs, gen, bound)

    def _call(self, body, inputs, gen, bound) -> Tuple[torch.Tensor, ...]:
        host = tuple(None if a is None else torch.as_tensor(a) for a in inputs)
        if self.eager:
            self.stats["eager_steps"] += 1
            return tuple(body(*self._upload(host)))
        with span("compiled.key"):
            key = (tuple(None if a is None else (tuple(a.shape), a.dtype) for a in host),
                   None if gen is None else id(gen), storage_key(bound))
        if self.graph is not None and key == self.key:
            return self._replay_with(host)
        calls = self.seen.pop(key, 0) + 1
        self.seen[key] = calls
        for old in [k for k in self.seen if k != self.key][:-KEYS_KEPT]:
            del self.seen[old]
            self._draws.pop(old, None)
        if calls <= WARMUP_STEPS:
            draws = None
            if gen is not None and calls == WARMUP_STEPS and self.device.type == "cuda":
                draws = self._draws[key] = RematDraws(gen)
            with span("compiled.warmup"):
                return self._warm_up(lambda: body(*self._upload(host)), draws)
        draws = self._draws.pop(key, None)
        seen = self.seen
        self.release()
        self.seen = seen
        self.inputs = tuple(None if a is None else torch.empty(a.shape, dtype=a.dtype,
                                                               device=self.device)
                            for a in host)
        self._capture(lambda: body(*self.inputs), key, gen, draws)
        return self._replay_with(host)

    def _replay_with(self, host) -> Tuple[torch.Tensor, ...]:
        """Copy ``host`` into the static inputs, replay, and return copies of
        the static outputs."""
        with span("compiled.upload"):
            for buf, a in zip(self.inputs, host):
                if buf is not None:
                    buf.copy_(a, non_blocking=True)
        with span("compiled.replay"):
            self._replay()
        with span("compiled.outputs"):
            out = []
            for v in self.static:
                with torch.inference_mode(v.is_inference()):
                    out.append(v.clone())
        return tuple(out)


class CompiledEpoch(_Graphed):
    """Runs an epoch of one step body; on the card, as replays of one
    captured CUDA graph (module docstring)."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.idx: Optional[torch.Tensor] = None

    def release(self) -> None:
        super().release()
        self.idx = None

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
        with span("compiled.epoch"):
            return self._run(step, rows, gen, bound)

    def _run(self, step, rows, gen, bound) -> Tuple[torch.Tensor, ...]:
        with span("compiled.upload"):
            rows = torch.as_tensor(rows).to(self.device, torch.int64)
        n, width = rows.shape
        if n == 0:
            raise RuntimeError("an epoch of no batches")
        outs: List[Optional[torch.Tensor]] = [None]
        first = 0
        with span("compiled.key"):
            key = (width, None if gen is None else id(gen), storage_key(bound))
        if self.graph is None or self.key != key:
            self.release()
            idx = self._index(width)
            w = min(WARMUP_STEPS, n)
            draws = RematDraws(gen) if gen is not None and self.device.type == "cuda" else None
            for i in range(w):
                with span("compiled.warmup"):
                    idx.copy_(rows[i])
                    self._keep(outs, i, n, self._warm_up(lambda: step(idx),
                                                         draws if i == w - 1 else None))
            if w == n:
                return tuple(outs[0])
            self._capture(lambda: step(idx), key, gen, draws)
            first = w
        idx = self.idx
        for i in range(first, n):
            with span("compiled.replay"):
                idx.copy_(rows[i])
                self._replay()
                self._keep(outs, i, n, self.static)
        return tuple(outs[0])

    @staticmethod
    def _keep(outs: list, i: int, n: int, values: Sequence[torch.Tensor]) -> None:
        """Copy step ``i``'s outputs into row ``i`` of the epoch's vectors."""
        if outs[0] is None:
            outs[0] = tuple(torch.empty(n, dtype=v.dtype, device=v.device) for v in values)
        for vec, v in zip(outs[0], values):
            vec[i].copy_(v.detach())
