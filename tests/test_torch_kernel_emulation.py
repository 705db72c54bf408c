"""The tensor-core attention kernels' CUDA source, run on the CPU.

``kernels/csrc/attention_{fwd,bwd}_tc.cu`` are compiled with g++ against
the host emulation in ``tests/cuda_emulation/`` (one thread per CUDA
thread; ``ldmatrix``, ``mma.sync`` and the shuffles as the PTX ISA defines
them, in place of the inline PTX of ``mma_bf16.cuh``) and called through
their C interface on CPU tensors, then held to ``attention_plain`` and
``attention_bwd_plain`` at the card's tolerances: forward 2e-2 max abs,
backward 3e-2 · max(1, max |plain|). This checks the kernels' fragment
layouts, padding, masks and rounding order here; whether nvcc takes the
source and what the card's tensor cores sum in which order is for
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card. B 2, 2
heads, lengths at every padding edge of the 16-row blocks.
"""

import ctypes
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
    assert kernels["fwd"](qkv.data_ptr(), m, out.data_ptr(), *args) == 0
    assert kernels["bwd"](qkv.data_ptr(), m, do.data_ptr(), dqkv.data_ptr(), *args) == 0
    return qkv, do, mask, out, dqkv


CASES = ([(length, 64, masked, layout) for length in (1, 15, 16, 17, 77, 129)
          for masked in (False, True) for layout in ("packed", "head_major")]
         + [(length, 128, masked, "packed") for length in (17, 129) for masked in (False, True)])


@pytest.mark.parametrize("length,dh,masked,layout", CASES)
def test_emulated_tc_kernels_match_plain(kernels, length, dh, masked, layout):
    qkv, do, mask, out, dqkv = _run(kernels, length, dh, masked, layout, seed=length + dh)
    want = tattn.attention_plain(qkv, 2, mask, layout)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    want = tattn.attention_bwd_plain(qkv, do, 2, mask, layout).float()
    err = (dqkv.float() - want).abs().max().item()
    assert err <= 3e-2 * max(1.0, want.abs().max().item())


def test_emulated_bwd_kernel_at_the_vehicle_length(kernels):
    """L 257 (17 query blocks, two rounds of 9 warps), where the CUDA-core
    backward ran out of shared memory."""
    qkv, do, _, out, dqkv = _run(kernels, 257, 64, False, "packed", seed=257)
    assert (out.float() - tattn.attention_plain(qkv, 2).float()).abs().max().item() <= 2e-2
    want = tattn.attention_bwd_plain(qkv, do, 2).float()
    assert (dqkv.float() - want).abs().max().item() <= 3e-2 * max(1.0, want.abs().max().item())
