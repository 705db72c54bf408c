"""The multi-tensor Adam kernel's CUDA source on the CPU.

``kernels/csrc/adam.cu`` built with g++ against ``tests/cuda_emulation/``
(``kernel_emulation.adam_library``: one thread per CUDA thread, the blocks
one after another) and called through ``ops/adam.py::table_call``, the
wrapper's own packing of the table, on CPU tensors. One table of ragged
leaves (1, 7, 768, 2,304, 99,072 and 262,145 elements, and one leaf whose
four tensors start 4 bytes past a 16-byte boundary, so it takes the scalar
path), two lr multipliers (two scalars tensors read), fp32 and bf16
moments, Adam and AdamW: p, m and v after 3 steps equal to
``adam_leaf_plain``'s, leaf by leaf, bit for bit. A table longer than one
launch holds is cut into two launches with the same bits. Each call runs
pinned to one core (``kernel_emulation.one_core``).

The CPU's ``torch.sqrt`` is not correctly rounded (its vector path is off
by an ulp on a few elements in a thousand), while the kernel's
``__fsqrt_rn`` and the card's ``torch.sqrt`` are. So the bits are held to
``adam_leaf_plain`` run with ``torch.sqrt`` taken in fp64 and rounded to
fp32 (which is correctly rounded), and the stock CPU version is held to
1e-6 relative plus 1e-3·lr, the card's tolerance between the per-leaf
kernel and the plain version (``tests/test_torch_cuda.py``).
"""

import contextlib
import shutil

import numpy as np
import pytest
import torch

from kernel_emulation import adam_library, one_core
from mpreid_tpu_torch.ops import adam as tadam

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

SIZES = (1, 7, 768, 2304, 99072, 262145)
MISALIGNED = 1000  # elements of the leaf that starts off a 16-byte boundary
B1, B2, EPS = 0.9, 0.999, 1e-8
LR = 3e-4  # the base lr; leaves of multiplier 2 take 2·LR


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    return adam_library(tmp_path_factory.mktemp("emulated_adam"))


def _leaf(n, moment_dtype, rng, offset=0):
    """(p, m, v, g) of ``n`` elements, each a view ``offset`` elements into a
    buffer of its own."""
    def draw(scale, low=None):
        x = rng.random(n + offset) if low else rng.standard_normal(n + offset)
        return torch.from_numpy((x * scale).astype(np.float32))

    p = draw(1.0)
    m = draw(1e-3).to(moment_dtype)
    v = draw(1e-6, low=True).to(moment_dtype)
    g = draw(1e-3)
    return tuple(t[offset:] for t in (p, m, v, g))


def _scalars(t, lr):
    return torch.tensor([lr, 1 - B1 ** t, 1 - B2 ** t], dtype=torch.float32)


def _table(moment_dtype, seed, sizes=SIZES, misaligned=True):
    """The leaves (p, m, v, g, lr multiplier, weight decay)."""
    rng = np.random.default_rng(seed)
    leaves = [(*_leaf(n, moment_dtype, rng), 1.0 + i % 2, 1e-4 * (i % 3))
              for i, n in enumerate(sizes)]
    if misaligned:
        leaves.append((*_leaf(MISALIGNED, moment_dtype, rng, offset=1), 2.0, 5e-4))
        assert leaves[-1][0].data_ptr() % 16 == 4
    return leaves


def _copy(leaves):
    return [(*(t.clone() for t in leaf[:4]), *leaf[4:]) for leaf in leaves]


@contextlib.contextmanager
def _rounded_sqrt():
    """``torch.sqrt`` correctly rounded: fp64 (53 bits, past the 2·24 + 2 a
    rounding of fp32's square root needs), then rounded to fp32."""
    stock = torch.sqrt
    torch.sqrt = lambda x: stock(x.double()).to(x.dtype)
    try:
        yield
    finally:
        torch.sqrt = stock


def _plain(leaves, scalars, decoupled):
    for p, m, v, g, mult, wd in leaves:
        tadam.adam_leaf_plain(p, m, v, g, scalars[mult], B1, B2, EPS, wd, decoupled)


def _steps(lib, leaves, decoupled, steps):
    """``steps`` updates of the table through the emulated kernel, and leaf by
    leaf through ``adam_leaf_plain`` with ``torch.sqrt`` correctly rounded
    and as it is → (the launches of each step, the two plain results)."""
    exact, stock = _copy(leaves), _copy(leaves)
    launches = []
    for t in range(1, steps + 1):
        scalars = {mult: _scalars(t, LR * mult) for mult in (1.0, 2.0)}
        table = [(p, m, v, g, scalars[mult], wd) for p, m, v, g, mult, wd in leaves]
        with one_core():
            rc, n = tadam.table_call(lib, table, B1, B2, EPS, decoupled, None)
        assert rc == 0
        launches.append(n)
        with _rounded_sqrt():
            _plain(exact, scalars, decoupled)
        _plain(stock, scalars, decoupled)
    return launches, exact, stock


def _assert_bits(leaves, exact, stock):
    for i, (got, want, near) in enumerate(zip(leaves, exact, stock)):
        for name, a, b, c in zip("pmv", got[:3], want[:3], near[:3]):
            assert a.dtype == b.dtype
            assert torch.equal(a, b), (i, a.numel(), name, (a.float() - b.float()).abs().max())
            torch.testing.assert_close(a.float(), c.float(), rtol=1e-6, atol=1e-3 * LR * 2)


@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoupled", [False, True])
def test_multi_adam_kernel_gives_the_plain_bits(lib, moment_dtype, decoupled):
    leaves = _table(moment_dtype, seed=int(decoupled) + 2 * (moment_dtype == torch.bfloat16))
    before = [leaf[0].clone() for leaf in leaves]
    launches, exact, stock = _steps(lib, leaves, decoupled, steps=3)
    assert launches == [1, 1, 1]
    _assert_bits(leaves, exact, stock)
    assert all(not torch.equal(leaf[0], p) for leaf, p in zip(leaves, before))  # every leaf moved


def test_a_long_table_is_cut_into_launches(lib):
    """449 leaves: one past what a launch holds, so two launches."""
    leaves = _table(torch.float32, seed=9, sizes=[1 + (i * 37) % 300 for i in range(449)],
                    misaligned=False)
    launches, exact, stock = _steps(lib, leaves, decoupled=True, steps=1)
    assert launches == [2]
    _assert_bits(leaves, exact, stock)
