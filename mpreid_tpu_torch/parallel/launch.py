"""Run a function on several ranks of a fresh process group, from Python.

``spawn(fn, world, args)`` starts ``world`` processes (the ``spawn`` start
method), joins them into one group over ``tcp://localhost:<free port>`` with
the given backend, runs ``fn(*args)`` on each and returns the ranks' results
in rank order. It is what torchrun does for a script, for a function; the
tests run their two-rank cases through it on the CPU (gloo), and
``chip_smoke.py`` its two ranks sharing one card (gloo with CUDA tensors:
NCCL refuses two ranks on one device). ``fn`` must be importable by name
from a module (a function of a test module or of a script), and its
arguments and result picklable.

Nothing is left running: a rank that raises makes ``spawn`` raise with its
traceback, a job that outlasts ``timeout`` seconds raises, and either way
every process still alive is killed.
"""

from __future__ import annotations

import io
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(rank: int, world: int, port: int, backend: str, threads: Optional[int],
              job: bytes, results) -> None:
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        fn, args = torch.load(io.BytesIO(job), weights_only=False)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            # as bytes: a tensor sent as itself lives in shared memory that
            # goes away with this process
            buf = io.BytesIO()
            torch.save(fn(*args), buf)
            results.put((rank, True, buf.getvalue()))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo",
          timeout: float = 300.0, threads: Optional[int] = None) -> list:
    """``fn(*args)`` on ``world`` ranks of a new group → their results, by rank."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    job = io.BytesIO()  # unpickled inside the rank, where a failure is reported
    torch.save((fn, tuple(args)), job)
    procs = [ctx.Process(target=_run_rank, daemon=True,
                         args=(r, world, port, backend, threads, job.getvalue(), results))
             for r in range(world)]
    env = os.environ.copy()
    try:
        # the children must not inherit a torchrun environment of the caller
        for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(key, None)
        for p in procs:
            p.start()
    finally:
        os.environ.clear()
        os.environ.update(env)
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{fn.__name__} on {world} ranks: no result after "
                                   f"{timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"{fn.__name__}: a rank exited with code "
                                       f"{dead[0].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{value}")
            out[rank] = torch.load(io.BytesIO(value), weights_only=False)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
