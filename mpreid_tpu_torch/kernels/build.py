"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so``
(``_build`` is git-ignored), keyed by a hash of the source and the flags, and
loaded with ``ctypes``. Nothing is compiled when a module is imported, so the
CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("attention_fwd", "attention_bwd", "adam", "pairwise_cross", "batch_hard")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
    default install prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, float]:
    """Compile every named source that is not built yet, all at once (one
    ``nvcc`` process each). Returns the seconds each build took (0.0 for a
    library already built). ``verbose`` adds ``-Xptxas -v`` and prints what
    the assembler reports (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
