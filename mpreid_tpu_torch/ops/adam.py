"""Fused Adam / AdamW update of one parameter leaf.

ref mpreid_tpu/ops/adam_kernel.py::fused_adam_leaf, ::_adam_kernel,
::MIN_FUSED_SIZE, and the per-leaf math of
mpreid_tpu/solver/optim.py::Optimizer.update.

``fused_adam_leaf`` updates ``p``, ``m`` and ``v`` in place from ``g``. On
CUDA tensors it launches the hand-written Hopper kernel
(``kernels/csrc/adam.cu``: one pass, 16-byte vector loads, no padding copy)
or raises; on CPU tensors it runs ``adam_leaf_plain``, the same math in
plain PyTorch. Coupled L2 (Adam) folds ``wd·p`` into the gradient;
decoupled decay (AdamW) adds ``lr·wd·p`` to the step. The moments update
in fp32 and are stored as fp32 or bf16; the step uses the fresh fp32
moments. The step's scalars come as one fp32 tensor of three values on the
leaf's device, ``scalars`` = [lr·mult, 1 − b1^t, 1 − b2^t], as the TPU
kernel reads them from SMEM: the kernel reads them from device memory when
it runs and the plain version takes them as 0-dim tensors, so neither
bakes a step's values into a CUDA graph that replays it
(``engine/compiled.py``). The solver forms them on the device
(``solver/optim.py::Optimizer.step_scalars``) and uses the kernel for leaves
of at least ``MIN_FUSED_SIZE`` elements when ``SOLVER.FUSED_ADAM`` is on.

``adam_leaves`` updates a table of leaves, each with its own scalars and
weight decay, in one launch of ``multi_adam_kernel`` (the same file: each
element through the per-leaf kernel's own function, so the same bits); the
solver sends it every CUDA leaf that does not take ``fused_adam_leaf``. On
CPU tensors it runs ``adam_leaf_plain`` leaf by leaf.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

# leaves below this many elements stay on the plain path (as in the JAX package)
MIN_FUSED_SIZE = 262144
MOMENT_DTYPES = (torch.float32, torch.bfloat16)


def adam_leaf_plain(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    scalars: torch.Tensor, b1: float, b2: float, eps: float,
                    wd: float, decoupled: bool) -> None:
    """The kernel's function in plain PyTorch, in place under ``no_grad``.

    ``scalars`` is the fp32 tensor [lr·mult, 1 − b1^t, 1 − b2^t] (the base
    lr times the leaf's multiplier and the two bias corrections); its values
    are read as 0-dim tensors, never as Python floats."""
    lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    with torch.no_grad():
        if not decoupled:
            g = g + wd * p  # coupled L2 (torch Adam)
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * (g * g)
        step = lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if decoupled:
            step = step + (lr * wd) * p  # torch AdamW decays with the group's lr
        p.sub_(step)
        m.copy_(m32)
        v.copy_(v32)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from mpreid_tpu_torch.kernels import build

    lib = build.load("adam")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mpreid_adam.argtypes = [p, p, p, p, ctypes.c_longlong, i, p,
                                f, f, f, f, f, f, i, p]
    lib.mpreid_adam.restype = i
    declare_leaves(lib)
    return lib


def declare_leaves(lib: ctypes.CDLL) -> None:
    """The C signature of ``lib.mpreid_adam_leaves``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mpreid_adam_leaves.argtypes = [i, p, p, p, p, p, p, p, i, f, f, f, f, f, i, p,
                                       ctypes.POINTER(i)]
    lib.mpreid_adam_leaves.restype = i


def _device_check(device: torch.device) -> None:
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(f"the Adam kernel is built for sm_90a; device capability is {cap}")


def _scalars_check(name: str, scalars: torch.Tensor, device: torch.device) -> None:
    if (scalars.dtype != torch.float32 or scalars.shape != (3,) or not scalars.is_contiguous()
            or scalars.device != device):
        raise ValueError(f"{name} takes scalars as a contiguous fp32 tensor of 3 values "
                         f"on the leaf's device, got {scalars.dtype} {tuple(scalars.shape)} on "
                         f"{scalars.device}")


def _launch_cuda(p, m, v, g, scalars, b1, b2, eps, wd, decoupled) -> None:
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"fused_adam_leaf takes fp32 p and g, got {p.dtype} and {g.dtype}")
    if m.dtype not in MOMENT_DTYPES or v.dtype != m.dtype:
        raise TypeError(f"fused_adam_leaf takes moments of one type in {MOMENT_DTYPES}, "
                        f"got {m.dtype} and {v.dtype}")
    tensors = (p, m, v, g)
    if any(t.shape != p.shape for t in tensors):
        raise ValueError("fused_adam_leaf needs p, m, v and g of one shape")
    if any(t.device != p.device for t in tensors):
        raise ValueError("fused_adam_leaf needs p, m, v and g on one device")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_adam_leaf needs contiguous, 16-byte aligned tensors")
    _scalars_check("fused_adam_leaf", scalars, p.device)
    _device_check(p.device)
    rc = _library().mpreid_adam(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), p.numel(),
        int(m.dtype == torch.bfloat16), scalars.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, wd,
        int(bool(decoupled)), torch.cuda.current_stream(p.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"Adam kernel launch failed with CUDA error {rc}")
    fused_adam_leaf.launches += 1


def fused_adam_leaf(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    scalars: torch.Tensor, b1: float, b2: float, eps: float,
                    wd: float, decoupled: bool) -> None:
    """One leaf's Adam/AdamW update, in place (arguments as ``adam_leaf_plain``).

    CUDA tensors run the Hopper kernel (no synchronisation, launched on the
    current stream) and count one launch in ``fused_adam_leaf.launches``;
    CPU tensors run ``adam_leaf_plain``."""
    if p.device.type == "cpu":
        return adam_leaf_plain(p, m, v, g, scalars, b1, b2, eps, wd, decoupled)
    if p.device.type != "cuda":
        raise RuntimeError(f"fused_adam_leaf runs on cuda or cpu, not {p.device}")
    return _launch_cuda(p, m, v, g, scalars, b1, b2, eps, wd, decoupled)


fused_adam_leaf.launches = 0


# one leaf of a table: (p, m, v, g, scalars, weight decay)
Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float]


def _launch_table(leaves: Sequence[Leaf], b1, b2, eps, decoupled) -> None:
    device, moments = leaves[0][0].device, leaves[0][1].dtype
    if moments not in MOMENT_DTYPES:
        raise TypeError(f"adam_leaves takes moments of one type in {MOMENT_DTYPES}, "
                        f"got {moments}")
    for p, m, v, g, scalars, _ in leaves:
        if p.dtype != torch.float32 or g.dtype != torch.float32:
            raise TypeError(f"adam_leaves takes fp32 p and g, got {p.dtype} and {g.dtype}")
        if m.dtype != moments or v.dtype != moments:
            raise TypeError(f"adam_leaves takes moments of one type for every leaf, got "
                            f"{m.dtype} and {v.dtype} beside {moments}")
        tensors = (p, m, v, g)
        if any(t.shape != p.shape for t in tensors):
            raise ValueError("adam_leaves needs p, m, v and g of one shape in each leaf")
        if any(t.device != device for t in tensors):
            raise ValueError("adam_leaves needs every leaf's p, m, v and g on one device")
        if any(not t.is_contiguous() for t in tensors):
            raise ValueError("adam_leaves needs contiguous tensors")
        _scalars_check("adam_leaves", scalars, device)
    _device_check(device)
    rc, launches = table_call(_library(), leaves, b1, b2, eps, decoupled,
                              torch.cuda.current_stream(device).cuda_stream)
    adam_leaves.launches += launches
    if rc != 0:
        raise RuntimeError(f"multi-tensor Adam kernel launch failed with CUDA error {rc}")
    adam_leaves.leaves += sum(leaf[0].numel() > 0 for leaf in leaves)


def table_call(lib: ctypes.CDLL, leaves: Sequence[Leaf], b1, b2, eps, decoupled,
               stream) -> Tuple[int, int]:
    """``lib.mpreid_adam_leaves`` over ``leaves`` as they are, unchecked (the
    moments' type from the first leaf) → (CUDA error, launches made)."""

    def column(i, kind=ctypes.c_void_p, of=lambda t: t.data_ptr()):
        return (kind * len(leaves))(*(of(leaf[i]) for leaf in leaves))

    launches = ctypes.c_int(0)
    rc = lib.mpreid_adam_leaves(
        len(leaves), *(column(i) for i in range(5)),
        (ctypes.c_longlong * len(leaves))(*(leaf[0].numel() for leaf in leaves)),
        column(5, ctypes.c_float, float), int(leaves[0][1].dtype == torch.bfloat16), b1, 1 - b1,
        b2, 1 - b2, eps, int(bool(decoupled)), stream, ctypes.byref(launches),
    )
    return rc, launches.value


def adam_leaves(leaves: Sequence[Leaf], b1: float, b2: float, eps: float,
                decoupled: bool) -> None:
    """Every leaf's Adam/AdamW update, in place: ``leaves`` holds (p, m, v,
    g, scalars, wd) for each, the arguments of ``adam_leaf_plain``, on one
    device, the moments of one type.

    CUDA tensors run ``multi_adam_kernel`` over the whole table (one launch
    for up to 448 leaves; no synchronisation, on the current stream), count
    its launches in ``adam_leaves.launches`` and the leaves it updated (those
    of any elements) in ``adam_leaves.leaves``; CPU tensors run
    ``adam_leaf_plain`` on each."""
    if not leaves:
        return
    device = leaves[0][0].device
    if device.type == "cpu":
        for p, m, v, g, scalars, wd in leaves:
            adam_leaf_plain(p, m, v, g, scalars, b1, b2, eps, wd, decoupled)
        return
    if device.type != "cuda":
        raise RuntimeError(f"adam_leaves runs on cuda or cpu, not {device}")
    _launch_table(leaves, b1, b2, eps, decoupled)


adam_leaves.launches = 0
adam_leaves.leaves = 0
