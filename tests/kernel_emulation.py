"""The port's CUDA sources built for the CPU: the shared home of
``tests/test_torch_kernel_emulation*.py``.

``kernels/csrc/attention_{fwd,bwd}_tc.cu`` (bf16) and
``kernels/csrc/attention_{fwd,bwd}.cu`` (fp32 in three TF32 passes) are
compiled with g++ against the host emulation in ``tests/cuda_emulation/``
(one thread per CUDA thread; ``ldmatrix``, ``mma.sync`` in bf16 and tf32
and the shuffles as the PTX ISA defines them, in place of the inline PTX of
``mma_bf16.cuh`` and ``mma_tf32.cuh``) and called
through their C interface on CPU tensors, then held to ``attention_plain``
and ``attention_bwd_plain`` at the card's tolerances: bf16 forward 2e-2 max
abs, backward 3e-2 · max(1, max |plain|) (``check_tc_case``); fp32 forward
1e-5 max abs, backward 1e-5 · max(1, max |plain|) (``check_fp32_case``).

Past the rows they stage whole (bf16: 800 / 384 at dh 64, forward /
backward; 416 / 208 at dh 128) the tensor-core kernels run chunked
instances that stream the sequence: the cases at L 442 and 224 take the
backward's. ``tc_kernels(out, chunk_rows)`` builds the sources with
``MPREID_TC_CHUNK_ROWS`` defined, which sends every length through both
chunked instances with chunks of that many rows, so several chunks show up
at short lengths.

The cases are spread over several test files, by length, because
``pytest --dist loadfile`` runs each file on one worker and the emulator's
barriers make the long lengths slow: ``CASES`` and ``FP32_CASES`` list them
all and ``SHARES`` and ``FP32_SHARES`` give each file its part. Each file
builds its own libraries (the fixtures are module-scoped).

``kernels/csrc/batch_hard.cu`` builds the same way against the emulated
``cluster.cuh`` (``batch_hard_library``): ``emu::launch_cluster`` runs the
8 blocks of a cluster together, with a barrier over all of them and each
block's shared memory reachable from its siblings by rank.
"""

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.kernels import build
from mpreid_tpu_torch.ops import attention as tattn

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
# the inline-PTX functions of each shared header, replaced by warp_prims.h
PRIMITIVES = {
    "mma_bf16.cuh": ("smem_addr", "cp_async_16", "cp_async_wait_all", "ldmatrix_x4",
                     "ldmatrix_x4_trans", "mma"),
    "mma_tf32.cuh": ("smem_addr", "cp_async_16", "cp_async_wait_all", "mma_m16n8k8"),
    "cluster.cuh": ("smem_addr", "cluster_rank", "cluster_sync", "cluster_map", "cp_async_16",
                    "cp_async_commit", "cp_async_wait_prior", "cp_async_wait_all"),
}


def _emulated_header(name: str) -> str:
    """``csrc/<name>`` with its inline-PTX primitives cut out and
    ``warp_prims.h``, which defines them at global scope, included."""
    text = (build.CSRC / name).read_text()
    for prim in PRIMITIVES[name]:
        pattern = r"(//[^\n]*\n)*__device__ __forceinline__ [\w*]+ " + prim + r"\(.*?\n}\n"
        text, n = re.subn(pattern, "", text, count=1, flags=re.S)
        assert n == 1, f"{name} has no {prim} to replace"
    anchor = "\nnamespace "
    assert anchor in text
    return text.replace(anchor, '\n#include "warp_prims.h"\n' + anchor, 1)


def _compile(out: Path, header: str, source: str, shared: str, launches: int = 1,
             defines: tuple = ()) -> ctypes.CDLL:
    """``csrc/<source>.cu`` built for the CPU against the emulated ``header``,
    its kernel launches (``launches`` of them) turned into ``emu::launch``
    calls and ``shared`` declaring the shared memory its kernels use, with
    ``-D`` of each of ``defines``, into ``out``."""
    (out / header).write_text(_emulated_header(header))
    src, n = re.subn(r"(\w+<[\w, ]+>)<<<([^,]*), ([^,]*), [^>]*>>>\(",
                     r"emu::launch(\2, \3, \1, ", (build.CSRC / f"{source}.cu").read_text())
    assert n == launches
    (out / f"{source}.cpp").write_text('#include "cuda_runtime.h"\n' + shared + "\n" + src)
    lib = out / f"lib{source}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", *(f"-D{d}" for d in defines), "-I", str(EMULATION),
                    "-I", str(out), "-o", str(lib), str(out / f"{source}.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def batch_hard_library(out: Path) -> ctypes.CDLL:
    """``csrc/batch_hard.cu`` built for the CPU against the emulated
    ``cluster.cuh``: its launch runs as ``emu::launch_cluster`` (the
    blocks of a cluster together), its dynamic shared memory is each
    block's own. C signatures declared."""
    (out / "cluster.cuh").write_text(_emulated_header("cluster.cuh"))
    src, n = re.subn(r"(\w+)<<<([^,]*), ([^,]*), ([^,]*), [^>]*>>>\(",
                     r"emu::launch_cluster(kCluster, \2, \3, \4, \1, ",
                     (build.CSRC / "batch_hard.cu").read_text())
    assert n == 1
    src, n = re.subn(r"extern __shared__ __align__\(16\) float smem\[\];",
                     "float* smem = emu::block_smem<float>();", src)
    assert n == 1
    (out / "batch_hard.cpp").write_text('#include "cuda_runtime.h"\n' + src)
    lib = out / "libbatch_hard.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", "-I", str(EMULATION), "-I", str(out),
                    "-o", str(lib), str(out / "batch_hard.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p] * 6 + [i, i, ctypes.c_longlong, i]
    lib.mpreid_batch_hard.argtypes = head + [p]
    lib.mpreid_batch_hard_tiled.argtypes = head + [i, i, i, p]
    lib.mpreid_batch_hard.restype = lib.mpreid_batch_hard_tiled.restype = i
    return lib


def tc_kernels(out: Path, chunk_rows: int = None) -> dict:
    """The emulated tensor-core libraries' C entry points, built into
    ``out``: "fwd" and "bwd" (``mpreid_mha_{fwd,bwd}_tc``), "fwd_smem",
    "bwd_smem" (bytes of shared memory a block needs at (L, dh)) and
    "bwd_scratch" (floats of the backward's statistics at (B, L, H, dh));
    with ``chunk_rows``, every length on the chunked instances, in chunks of
    that many rows."""
    defines = (f"MPREID_TC_CHUNK_ROWS={chunk_rows}",) if chunk_rows else ()
    fns = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    shape = [i, i, i, i, ctypes.c_longlong, i, i, i, i, ctypes.c_float]
    for direction in ("fwd", "bwd"):
        lib = _compile(out, "mma_bf16.cuh", f"attention_{direction}_tc",
                       "namespace { alignas(16) unsigned char smem_raw[232448]; }",
                       defines=defines)
        fn = getattr(lib, f"mpreid_mha_{direction}_tc")
        # qkv, mask, out; the backward adds dout and its statistics scratch
        fn.argtypes = [p] * (3 if direction == "fwd" else 5) + shape + [p]
        fn.restype = i
        fns[direction] = fn
        smem = getattr(lib, f"mpreid_mha_{direction}_tc_smem_bytes")
        smem.argtypes, smem.restype = [i, i], ctypes.c_size_t
        fns[f"{direction}_smem"] = smem
        if direction == "bwd":
            scratch = lib.mpreid_mha_bwd_tc_scratch_floats
            scratch.argtypes, scratch.restype = [i, i, i, i], ctypes.c_longlong
            fns["bwd_scratch"] = scratch
    return fns


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """``tc_kernels`` of the sources as the card builds them."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    return tc_kernels(tmp_path_factory.mktemp("emulated"))


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


def _run(kernels, length, dh, masked, layout, seed, heads=2, b=2):
    """Both emulated kernels of ``kernels`` on seeded bf16 inputs → (qkv,
    do, mask, out, dqkv)."""
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
    floats = kernels["bwd_scratch"](b, length, heads, dh)
    stats = torch.full((floats,), float("nan"))
    s = stats.data_ptr() if floats else None
    with one_core():
        assert kernels["fwd"](qkv.data_ptr(), m, out.data_ptr(), *args) == 0
        assert kernels["bwd"](qkv.data_ptr(), m, do.data_ptr(), dqkv.data_ptr(), s, *args) == 0
    return qkv, do, mask, out, dqkv


# lengths at every padding edge of the 16-row blocks, the text and vision
# towers' 77 and 129, and two past the rows the backward stages whole: 442
# (256x256 at stride 12; 384 rows whole at dh 64) and 224 at dh 128 (208)
CASES = ([(length, 64, masked, layout) for length in (1, 15, 16, 17, 77, 129)
          for masked in (False, True) for layout in ("packed", "head_major")]
         + [(length, 128, masked, "packed") for length in (17, 129) for masked in (False, True)]
         + [(442, 64, False, "packed"), (224, 128, True, "head_major")])


def _cases(lengths, dh=64, layouts=("packed", "head_major")):
    return [c for c in CASES if c[0] in lengths and c[1] == dh and c[3] in layouts]


# each file's share of CASES, by the suffix of its name
SHARES = {
    "": _cases((1, 15, 16)),
    "_l17": _cases((17,)) + _cases((17, 129), dh=128),
    "_l77_packed": _cases((77,), layouts=("packed",)),
    "_l77_head_major": _cases((77,), layouts=("head_major",)),
    "_l129": _cases((129,)),
    "_l442": _cases((442,), layouts=("packed",)),
    "_l224": _cases((224,), dh=128, layouts=("head_major",)),
}
assert sorted(c for share in SHARES.values() for c in share) == sorted(CASES)


def tc_shape(length: int) -> tuple:
    """(heads, B) an emulated case runs at: 2 × 2 up to L 200, then B 1, and
    one head above L 400 (the emulation's time grows as L squared)."""
    return (1 if length > 400 else 2), (1 if length > 200 else 2)


def check_tc_case(kernels, length, dh, masked, layout):
    """One case of ``CASES``: both tensor-core kernels of ``kernels`` against
    the plain versions, at the seed ``length + dh``, heads and B from
    ``tc_shape``."""
    heads, b = tc_shape(length)
    qkv, do, mask, out, dqkv = _run(kernels, length, dh, masked, layout, seed=length + dh,
                                    heads=heads, b=b)
    want = tattn.attention_plain(qkv, heads, mask, layout)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    want = tattn.attention_bwd_plain(qkv, do, heads, mask, layout).float()
    err = (dqkv.float() - want).abs().max().item()
    assert err <= 3e-2 * max(1.0, want.abs().max().item())


@pytest.fixture(scope="module")
def fp32(tmp_path_factory):
    """The emulated fp32 libraries: ``.fwd`` and ``.bwd`` (``ctypes.CDLL``),
    their C signatures declared."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    out = tmp_path_factory.mktemp("emulated_fp32")
    shared = "namespace { alignas(16) float smem[232448 / 4]; }"
    fwd = _compile(out, "mma_tf32.cuh", "attention_fwd", shared)
    bwd = _compile(out, "mma_tf32.cuh", "attention_bwd", shared, launches=2)
    p, i = ctypes.c_void_p, ctypes.c_int
    shape = [i, i, i, i, ctypes.c_longlong, i, i, i, i, ctypes.c_float, p]
    fwd.mpreid_mha_fwd.argtypes = [p] * 3 + shape
    bwd.mpreid_mha_bwd.argtypes = [p] * 5 + shape
    bwd.mpreid_mha_bwd_scratch_floats.argtypes = [i, i, i]
    bwd.mpreid_mha_bwd_scratch_floats.restype = ctypes.c_longlong
    for lib, name in ((fwd, "mpreid_mha_fwd"), (bwd, "mpreid_mha_bwd")):
        getattr(lib, name).restype = i
        getattr(lib, f"{name}_smem_bytes").argtypes = [i, i]
        getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_size_t
        getattr(lib, f"{name}_max_smem_bytes").restype = ctypes.c_size_t
    return types.SimpleNamespace(fwd=fwd, bwd=bwd)


# lengths at the 8-row edges of the tiles, the text tower's 77,
# configs/cross/sysu_rgb2ir.yml's 163 (288x144), the vehicle configs' 257,
# the 417 and 214 the CUDA-core kernels stopped at, and 442 (256x256 at
# stride 12), which no fp32 kernel took before the tiles streamed
FP32_CASES = [(1, 64, False, "packed"), (33, 64, True, "head_major"), (77, 64, True, "packed"),
              (163, 64, False, "packed"), (163, 64, True, "head_major"),
              (257, 64, False, "packed"), (257, 64, False, "head_major"),
              (417, 64, False, "packed"), (163, 128, False, "packed"),
              (214, 128, True, "head_major"), (442, 64, False, "packed")]

# each file's share of FP32_CASES, by the suffix of its name: about 40 s or
# less of emulation each on one core
FP32_SHARES = {
    "": [c for c in FP32_CASES if c[0] <= 77],
    "_fp32_l163": [c for c in FP32_CASES if c[0] == 163],
    "_fp32_l214": [c for c in FP32_CASES if c[0] == 214],
    "_fp32_l257": [c for c in FP32_CASES if c[0] == 257],
    "_fp32_l417": [c for c in FP32_CASES if c[0] == 417],
    "_fp32_l442": [c for c in FP32_CASES if c[0] == 442],
}
assert sorted(c for share in FP32_SHARES.values() for c in share) == sorted(FP32_CASES)


def check_fp32_case(fp32, direction, length, dh, masked, layout):
    """One case of ``FP32_CASES``: the emulated fp32 kernel of ``direction``
    (``"fwd"`` or ``"bwd"``) against its plain version, at the seed
    ``length + dh``, B 1, 2 heads (1 above L 400: the emulation's time grows
    as L squared)."""
    heads, b = (2 if length <= 400 else 1), 1
    d = heads * dh
    rng = np.random.default_rng(length + dh)
    qkv = torch.from_numpy(rng.standard_normal((b, length, 3 * d)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((b, length, d)).astype(np.float32))
    mask = torch.full((length, length), float("-inf")).triu(1) if masked else None
    m = mask.data_ptr() if masked else None
    args = (b, length, heads, dh, 3 * d, *tattn._column_offsets(d, dh, layout), dh ** -0.5, None)
    if direction == "fwd":
        got = torch.full((b, length, d), float("nan"))
        with one_core():
            assert fp32.fwd.mpreid_mha_fwd(qkv.data_ptr(), m, got.data_ptr(), *args) == 0
        want = tattn.attention_plain(qkv, heads, mask, layout)
        assert (got - want).abs().max().item() <= 1e-5
        return
    got = torch.full_like(qkv, float("nan"))
    stats = torch.empty(fp32.bwd.mpreid_mha_bwd_scratch_floats(b, length, heads))
    with one_core():
        assert fp32.bwd.mpreid_mha_bwd(qkv.data_ptr(), m, do.data_ptr(), got.data_ptr(),
                                       stats.data_ptr(), *args) == 0
    want = tattn.attention_bwd_plain(qkv, do, heads, mask, layout)
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
