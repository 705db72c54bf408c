"""Build the port's host C++ sources with g++ and load them.

Each ``native/<name>.cpp`` exposes a plain C interface. At first use it is
compiled with ``g++ -O3 -march=native -fopenmp -shared -fPIC`` into
``kernels/_build/<name>-<hash>.so`` (``_build`` is git-ignored), keyed by a
hash of the source, the flags and the host's CPU: ``-march=native`` builds
for the CPU that compiles, so a library built on another host may hold
instructions this one lacks. It is loaded with ``ctypes`` and, where the
module gives one, must pass a check before it is used. A library that does
not build, load or pass its check is unavailable, and ``NativeLibrary.why``
says why. Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

from mpreid_tpu_torch.kernels.build import BUILD_DIR

SRC = Path(__file__).resolve().parent
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
BUILD_TIMEOUT = 120  # seconds


def cpu_identity() -> str:
    """The host CPU's model name and feature flags, as ``/proc/cpuinfo``
    gives them for its first processor (the machine and processor names
    where that file cannot be read)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().split("\n\n", 1)[0].splitlines()
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    keep = ("model name", "flags", "Features", "CPU implementer", "CPU part")
    return "\n".join(ln for ln in lines if ln.split(":", 1)[0].strip() in keep)


def library_path(name: str, libs: Sequence[str] = ()) -> Path:
    key = b"\0".join([(SRC / f"{name}.cpp").read_bytes(), " ".join(FLAGS + tuple(libs)).encode(),
                      cpu_identity().encode()])
    return BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


class NativeLibrary:
    """``native/<name>.cpp`` built and loaded once, on the first ``get()``.

    ``declare(lib)`` sets the C functions' ``argtypes`` and ``restype``;
    ``check(lib)`` returns "" when the library may be used, else why not.
    ``get()`` returns the library, or None when it is unavailable (``why``).
    """

    def __init__(self, name: str, libs: Sequence[str] = (),
                 declare: Callable[[ctypes.CDLL], None] = lambda lib: None,
                 check: Callable[[ctypes.CDLL], str] = lambda lib: ""):
        self.name, self.libs = name, tuple(libs)
        self._declare, self._check = declare, check
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._done = False
        self.why = ""

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if not self._done:
                self._lib, self.why = self._load()
                self._done = True
            return self._lib

    def _load(self) -> tuple:
        path = library_path(self.name, self.libs)
        if not path.exists():
            why = self._build(path)
            if why:
                return None, why
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            return None, f"{path.name} does not load: {e}"
        self._declare(lib)
        why = self._check(lib)
        return (None, why) if why else (lib, "")

    def _build(self, path: Path) -> str:
        """Compile into ``path`` (through a file of this process, then
        renamed, so processes building at once do not collide) → "" or why
        the build failed."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, str(SRC / f"{self.name}.cpp"), *self.libs, "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT)
        except FileNotFoundError:
            return "g++ not found"
        except subprocess.TimeoutExpired:
            return f"g++ ran past {BUILD_TIMEOUT} s"
        if proc.returncode != 0:
            tail = " | ".join((proc.stderr or proc.stdout).strip().splitlines()[-3:])
            return f"g++ exited {proc.returncode}: {tail}"
        os.replace(tmp, path)
        return ""
