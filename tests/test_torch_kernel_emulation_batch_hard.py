"""The batch-hard kernel's CUDA source on the CPU.

``kernels/csrc/batch_hard.cu`` built with g++ against ``tests/cuda_emulation/``
(``kernel_emulation.batch_hard_library``: the 8 blocks of a cluster run
together, one thread per CUDA thread, with the cluster barrier and the
siblings' shared memory emulated) and called through its C interface on CPU
tensors, held to ``batch_hard_plain`` at the card's tolerance
(chip_smoke.py's phase 3): ap/an within 1e-5 · max(1, max |plain|), +inf
exactly where plain has no negative, p/n equal wherever the best two
candidates of a row differ by more than that; on features of a 1/4 grid
(every partial sum exact) all four outputs equal, a singleton's ap exactly
sqrt(1e-12) at itself. Each call runs pinned to one core
(``kernel_emulation.one_core``).
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kernel_emulation import batch_hard_library, one_core
from mpreid_tpu_torch.losses.triplet import euclidean_dist
from mpreid_tpu_torch.ops.batch_hard import batch_hard_plain

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = 1e-5  # relative to max(1, max |plain|): dot products summed in another order


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    return batch_hard_library(tmp_path_factory.mktemp("emulated_batch_hard"))


def _features(b, d, dtype, grid, seed, width=None):
    """(b, d) features, normal, or on a grid of 1/4, or with ``grid`` an int
    that many distinct grid rows repeated (ties everywhere), as a view of
    rows ``width`` apart where ``width`` is given."""
    rng = np.random.default_rng(seed)
    w = width or d
    if grid:
        x = rng.integers(-4, 5, (b, w)).astype(np.float32) / 4
        if grid is not True:
            x = x[rng.integers(0, grid, b)]
    else:
        x = rng.standard_normal((b, w)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)[:, :d]


def _run(lib, f, labels, max_cols=None, max_chunk=None, shape=-1):
    b, d = f.shape
    lab = labels.int().contiguous()
    ap, an = torch.full((b,), float("nan")), torch.full((b,), float("nan"))
    p, n = torch.full((b,), -1, dtype=torch.int32), torch.full((b,), -1, dtype=torch.int32)
    args = (f.data_ptr(), lab.data_ptr(), ap.data_ptr(), an.data_ptr(), p.data_ptr(),
            n.data_ptr(), b, d, f.stride(0), int(f.dtype == torch.bfloat16))
    with one_core():
        if max_cols is None and shape == -1:
            rc = lib.mpreid_batch_hard(*args, None)
        else:
            rc = lib.mpreid_batch_hard_tiled(*args, max_cols or 1 << 30, max_chunk or 1 << 30,
                                             shape, None)
    assert rc == 0
    return ap, an, p, n


def _check(got, f, labels, grid):
    want = batch_hard_plain(f, labels)
    fin = torch.isfinite(want[1])
    tol = TOL * max([1.0, want[0].abs().max().item()]
                    + ([want[1][fin].abs().max().item()] if bool(fin.any()) else []))
    assert (got[0] - want[0]).abs().max().item() <= tol
    assert torch.equal(torch.isinf(got[1]), ~fin)
    if bool(fin.any()):
        assert (got[1] - want[1])[fin].abs().max().item() <= tol
    assert bool((got[3][~fin] == 0).all())
    dist = euclidean_dist(f.float(), f.float())
    same = labels[:, None] == labels[None, :]
    for val, idx, ref, mask in ((want[0], got[2], want[2], same),
                                (want[1], got[3], want[3], ~same)):
        clear = (((dist - val[:, None]).abs() <= tol) & mask).sum(1) == 1
        assert torch.equal(idx[clear], ref[clear])
    if grid:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        solo = same.sum(1) == 1
        assert bool((got[0][solo] == 1e-6).all())
        assert torch.equal(got[2][solo].long(), torch.nonzero(solo).flatten())


PK = torch.arange(20) // 4
STRIDED_IDS = torch.arange(20) % 4  # each identity in every tile of 8

# (name, B, D, dtype, grid, labels, row width, max_cols, max_chunk, kernel
# shape: -1 for B's own, 1 for 16 anchor rows a cluster in 16 warps, items
# of 8 rows x 2 columns); 50 is
# no multiple of 32 (8 blocks x 4 floats): slices of 8, the seventh holds 2,
# the eighth none. "ties" repeats 3 distinct rows over the batch: equal best
# candidates across lanes and blocks, and with tiles of 8 and STRIDED_IDS in
# one lane from tile to tile; the first index wins
CASES = [
    ("ragged", 20, 50, torch.float32, False, PK, None, None, None, -1),
    ("tiled", 20, 50, torch.float32, False, PK, None, 8, 4, -1),
    ("strided", 20, 50, torch.float32, False, PK, 56, None, None, -1),
    ("unaligned", 20, 50, torch.float32, False, PK, 53, 16, 8, -1),
    ("bf16", 20, 50, torch.bfloat16, False, PK, None, None, None, -1),
    ("bf16_tiled", 20, 50, torch.bfloat16, True, PK, None, 8, 8, -1),
    ("ties", 20, 50, torch.float32, 3, PK, None, None, None, -1),
    ("ties_tiled", 20, 50, torch.float32, 3, STRIDED_IDS, None, 8, 8, -1),
    ("rows16", 20, 50, torch.float32, False, PK, None, None, None, 1),
    ("rows16_ties_tiled", 20, 50, torch.float32, 3, STRIDED_IDS, None, 16, 8, 1),
    ("rows16_bf16_unaligned", 20, 50, torch.bfloat16, False, PK, 53, 16, 4, 1),
    ("rows16_strided", 20, 50, torch.float32, False, PK, 56, None, None, 1),
    ("singleton", 12, 40, torch.float32, True, torch.tensor([0, 0, 0, 1, 1, 1, 2, 3, 3, 3, 4, 4]),
     None, None, None, -1),
    ("one_identity", 12, 40, torch.bfloat16, True, torch.zeros(12, dtype=torch.int64), None,
     None, None, -1),
    ("one_identity_rows16", 12, 40, torch.float32, True, torch.zeros(12, dtype=torch.int64),
     None, None, None, 1),
    ("singleton_rows16", 12, 40, torch.float32, True,
     torch.tensor([0, 0, 0, 1, 1, 1, 2, 3, 3, 3, 4, 4]), None, None, None, 1),
    ("one_row", 1, 7, torch.float32, False, torch.zeros(1, dtype=torch.int64), None, None, None,
     -1),
]


@pytest.mark.parametrize("name,b,d,dtype,grid,labels,width,max_cols,max_chunk,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_emulated_batch_hard_matches_plain(lib, name, b, d, dtype, grid, labels, width,
                                           max_cols, max_chunk, shape):
    f = _features(b, d, dtype, grid, seed=b + d, width=width)
    got = _run(lib, f, labels, max_cols, max_chunk, shape)
    _check(got, f, labels, grid)


def test_emulated_batch_hard_is_deterministic_and_symmetric(lib):
    """The same bits on a second run, and the same bits whether the batch
    streams through tiles and chunks or not, or takes 16 anchor rows a
    cluster, where every sum is exact (a grid)."""
    f = _features(20, 50, torch.float32, False, seed=5)
    once, twice = _run(lib, f, PK), _run(lib, f, PK)
    for a, b in zip(once, twice):
        assert torch.equal(a, b)
    g = _features(20, 50, torch.float32, True, seed=6)
    whole = _run(lib, g, PK)
    for other in (_run(lib, g, PK, 8, 4), _run(lib, g, PK, shape=1)):
        for a, b in zip(whole, other):
            assert torch.equal(a, b)


ENTRY = "_ZN46_GLOBAL__N__ed633b82_13_batch_hard_cu_2af90fb9{name}EvPKT_PKiPfS6_PiS7_iixNS_4PlanE"
PTXAS_LOG = "".join(
    f"ptxas info    : Compiling entry function '{ENTRY.format(name=name)}' for 'sm_90a'\n"
    f"ptxas info    : Function properties for {ENTRY.format(name=name)}\n"
    f"    0 bytes stack frame, {{spill}} bytes spill stores, {{spill}} bytes spill loads\n"
    f"ptxas info    : Used {regs} registers, used 1 barriers\n"
    for name, regs in (("17batch_hard_kernelIfLi16ELi1ELi8ELi2ELi1EEE", 128),
                       ("17batch_hard_kernelI13__nv_bfloat16Li8ELi1ELi2ELi1ELi1EEE", 84),
                       ("12empty_kernelIfEE", 4)))


@pytest.mark.parametrize("spill", [0, 8])
def test_chip_smoke_reads_the_batch_hard_ptxas_and_refuses_a_spill(monkeypatch, spill):
    """chip_smoke.py's report keys each instantiation by its feature type and
    kernel shape, and fails on any spill."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from mpreid_tpu_torch.kernels import build

    monkeypatch.setattr(build, "LOGS", {"batch_hard": PTXAS_LOG.format(spill=spill)})
    if spill:
        with pytest.raises(AssertionError, match="batch_hard.cu spills registers"):
            chip_smoke.batch_hard_ptxas()
        return
    props = {"spill_stores": 0, "spill_loads": 0}
    assert chip_smoke.batch_hard_ptxas() == {
        "fp32_w16_rw1_rg8_cg2_m1": {**props, "registers": 128},
        "bf16_w8_rw1_rg2_cg1_m1": {**props, "registers": 84},
        "floor_fp32": {**props, "registers": 4}}
    monkeypatch.setattr(build, "LOGS", {})
    assert chip_smoke.batch_hard_ptxas() == {
        "batch_hard": "built before this process: not reported"}
