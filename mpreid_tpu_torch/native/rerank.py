"""ctypes wrapper of the native CPU k-reciprocal re-ranker (``rerank.cpp``).

ref mpreid_tpu/native/rerank.py. Built at first use with g++ and OpenMP
(``native/build.py``); ``native_available()`` is False where it does not
build. The algorithm is ``ops/reranking.py::re_ranking``'s, on the host's
cores: the CPU-deployment path, and a check of the card's dense re-ranking
at scale.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .build import NativeLibrary

_F32 = ctypes.POINTER(ctypes.c_float)


def _declare(lib: ctypes.CDLL) -> None:
    lib.rerank_kreciprocal.restype = ctypes.c_int
    lib.rerank_kreciprocal.argtypes = [_F32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_float, _F32]


LIBRARY = NativeLibrary("rerank", declare=_declare)


def native_available() -> bool:
    return LIBRARY.get() is not None


def why_unavailable() -> str:
    """Why the native re-ranker is off ("" when it is available)."""
    LIBRARY.get()
    return LIBRARY.why


def re_ranking_native(qf: np.ndarray, gf: np.ndarray, k1: int = 20, k2: int = 6,
                      lambda_value: float = 0.3) -> np.ndarray:
    """k-reciprocal re-ranking on the host's cores → the (Q, G) fp32
    distances; ``k1`` and ``k2`` are clamped to a small corpus."""
    lib = LIBRARY.get()
    if lib is None:
        raise RuntimeError(f"native rerank library unavailable: {LIBRARY.why}")

    feat = np.concatenate([qf, gf], axis=0).astype(np.float32)
    num_q = qf.shape[0]
    n = feat.shape[0]
    sq = (feat ** 2).sum(1)
    orig = sq[:, None] + sq[None, :] - 2.0 * feat @ feat.T
    orig = np.ascontiguousarray(np.transpose(orig / np.max(orig, axis=0)), dtype=np.float32)

    k1 = min(k1, n - 1)
    k2 = min(k2, n)
    out = np.empty((num_q, n - num_q), np.float32)
    rc = lib.rerank_kreciprocal(orig.ctypes.data_as(_F32), n, num_q, k1, k2,
                                ctypes.c_float(lambda_value), out.ctypes.data_as(_F32))
    if rc != 0:
        raise RuntimeError(f"native rerank failed with code {rc}")
    return out
