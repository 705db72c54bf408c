"""The attention kernels' CUDA sources built for the CPU: the shared home of
``tests/test_torch_kernel_emulation*.py``.

``kernels/csrc/attention_{fwd,bwd}_tc.cu`` are compiled with g++ against
the host emulation in ``tests/cuda_emulation/`` (one thread per CUDA
thread; ``ldmatrix``, ``mma.sync`` and the shuffles as the PTX ISA defines
them, in place of the inline PTX of ``mma_bf16.cuh``) and called through
their C interface on CPU tensors, then held to ``attention_plain`` and
``attention_bwd_plain`` at the card's tolerances: forward 2e-2 max abs,
backward 3e-2 · max(1, max |plain|) (``check_tc_case``). The CUDA-core
fp32 backward (``kernels/csrc/attention_bwd.cu``) builds the same way
(``simt_bwd``).

The cases are spread over several test files, by length, because
``pytest --dist loadfile`` runs each file on one worker and the emulator's
barriers make the long lengths slow: ``CASES`` lists them all and
``SHARES`` gives each file its part. Each file
builds its own libraries (the fixtures are module-scoped).
"""

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.kernels import build
from mpreid_tpu_torch.ops import attention as tattn

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
PRIMITIVES = ("smem_addr", "cp_async_16", "cp_async_wait_all", "ldmatrix_x4",
              "ldmatrix_x4_trans", "mma")


def _emulated_header() -> str:
    """mma_bf16.cuh with its inline-PTX primitives replaced by warp_prims.h."""
    text = (build.CSRC / "mma_bf16.cuh").read_text()
    for name in PRIMITIVES:
        pattern = r"(//[^\n]*\n)*__device__ __forceinline__ \w+ " + name + r"\(.*?\n}\n"
        text, n = re.subn(pattern, "", text, count=1, flags=re.S)
        assert n == 1, f"mma_bf16.cuh has no {name} to replace"
    anchor = "__host__ __device__ constexpr int round16"
    assert anchor in text
    return text.replace(anchor, (EMULATION / "warp_prims.h").read_text() + "\n" + anchor)


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """{"fwd": fn, "bwd": fn}: the emulated libraries' C entry points."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    out = tmp_path_factory.mktemp("emulated")
    (out / "mma_bf16.cuh").write_text(_emulated_header())
    fns = {}
    for direction in ("fwd", "bwd"):
        src = (build.CSRC / f"attention_{direction}_tc.cu").read_text()
        src, n = re.subn(r"(\w+<DH>)<<<([^,]*), ([^,]*), [^>]*>>>\(",
                         r"emu::launch(\2, \3, \1, ", src)
        assert n == 1
        src = ('#include "cuda_runtime.h"\n'
               "namespace { alignas(16) unsigned char smem_raw[232448]; }\n" + src)
        (out / f"{direction}.cpp").write_text(src)
        lib = out / f"lib{direction}.so"
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                        "-Wno-unknown-pragmas", "-I", str(EMULATION), "-I", str(out),
                        "-o", str(lib), str(out / f"{direction}.cpp")],
                       check=True, capture_output=True, timeout=300)
        fn = getattr(ctypes.CDLL(str(lib)), f"mpreid_mha_{direction}_tc")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (3 if direction == "fwd" else 4) + [
            i, i, i, i, ctypes.c_longlong, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
        fns[direction] = fn
    return fns


@contextlib.contextmanager
def one_core():
    """Within the block the calling thread, and the emulator's threads it
    starts (they inherit its affinity), run on one CPU core: a different
    one for each pytest-xdist worker. The emulator's hundreds of threads
    meet at a barrier every warp step; spread over busy cores each meeting
    waits on the scheduler of every core (a case 60× slower beside five
    busy processes), while on one core they hand over in turn and leave
    the other cores to the other workers."""
    mask = os.sched_getaffinity(0)
    worker = int(re.sub(r"\D", "", os.environ.get("PYTEST_XDIST_WORKER", "")) or 0)
    os.sched_setaffinity(0, {sorted(mask)[worker % len(mask)]})
    try:
        yield
    finally:
        os.sched_setaffinity(0, mask)


def _run(kernels, length, dh, masked, layout, seed):
    heads, b = 2, 2
    d = heads * dh
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, length, 3 * d)).astype(np.float32)).bfloat16()
    do = torch.from_numpy(rng.standard_normal((b, length, d)).astype(np.float32)).bfloat16()
    mask = torch.full((length, length), float("-inf")).triu(1) if masked else None
    offsets = tattn._column_offsets(d, dh, layout)
    args = (b, length, heads, dh, 3 * d, *offsets, dh ** -0.5, None)
    m = mask.data_ptr() if masked else None
    out = torch.empty(b, length, d, dtype=torch.bfloat16)
    dqkv = torch.empty_like(qkv)
    with one_core():
        assert kernels["fwd"](qkv.data_ptr(), m, out.data_ptr(), *args) == 0
        assert kernels["bwd"](qkv.data_ptr(), m, do.data_ptr(), dqkv.data_ptr(), *args) == 0
    return qkv, do, mask, out, dqkv


CASES = ([(length, 64, masked, layout) for length in (1, 15, 16, 17, 77, 129)
          for masked in (False, True) for layout in ("packed", "head_major")]
         + [(length, 128, masked, "packed") for length in (17, 129) for masked in (False, True)])


def _cases(lengths, dh=64, layouts=("packed", "head_major")):
    return [c for c in CASES if c[0] in lengths and c[1] == dh and c[3] in layouts]


# each file's share of CASES, by the suffix of its name
SHARES = {
    "": _cases((1, 15, 16)),
    "_l17": _cases((17,)) + _cases((17, 129), dh=128),
    "_l77_packed": _cases((77,), layouts=("packed",)),
    "_l77_head_major": _cases((77,), layouts=("head_major",)),
    "_l129": _cases((129,)),
}
assert sorted(c for share in SHARES.values() for c in share) == sorted(CASES)


def check_tc_case(kernels, length, dh, masked, layout):
    """One case of ``CASES``: both tensor-core kernels against the plain
    versions, at the seed ``length + dh``."""
    qkv, do, mask, out, dqkv = _run(kernels, length, dh, masked, layout, seed=length + dh)
    want = tattn.attention_plain(qkv, 2, mask, layout)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    want = tattn.attention_bwd_plain(qkv, do, 2, mask, layout).float()
    err = (dqkv.float() - want).abs().max().item()
    assert err <= 3e-2 * max(1.0, want.abs().max().item())


def _compile(out, src: str, name: str) -> ctypes.CDLL:
    src, n = re.subn(r"(\w+<DH>)<<<([^,]*), ([^,]*), [^>]*>>>\(",
                     r"emu::launch(\2, \3, \1, ", src)
    assert n == 1
    (out / f"{name}.cpp").write_text(src)
    lib = out / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", "-I", str(EMULATION), "-I", str(out),
                    "-o", str(lib), str(out / f"{name}.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def simt_bwd(tmp_path_factory):
    """The emulated CUDA-core backward's C entry point and its scratch size."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    src = ('#include "cuda_runtime.h"\n'
           "namespace { float smem[232448 / 4]; }\n"
           + (build.CSRC / "attention_bwd.cu").read_text())
    lib = _compile(tmp_path_factory.mktemp("emulated_simt"), src, "bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.mpreid_mha_bwd
    fn.argtypes = [p] * 5 + [i, i, i, i, ctypes.c_longlong, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    lib.mpreid_mha_bwd_scratch_floats.argtypes = [i, i, i]
    lib.mpreid_mha_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.mpreid_mha_bwd_smem_bytes.argtypes = [i, i]
    lib.mpreid_mha_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


SIMT_CASES = [(1, 64, False, "packed"), (33, 64, True, "head_major"), (77, 64, True, "packed"),
              (163, 64, False, "packed"), (163, 64, True, "head_major"),
              (257, 64, False, "packed"), (257, 64, False, "head_major"),
              (417, 64, False, "packed"), (163, 128, False, "packed"),
              (214, 128, True, "head_major")]
