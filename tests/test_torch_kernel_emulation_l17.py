"""The tensor-core attention kernels' CUDA source on the CPU: length 17 at dh 64, and lengths 17 and 129 at dh 128.

One share of ``tests/kernel_emulation.py::CASES``, in a file of its own so
that ``pytest --dist loadfile`` runs it beside the others (see
``tests/test_torch_kernel_emulation.py``).
"""

import pytest

from kernel_emulation import SHARES, check_tc_case, kernels  # noqa: F401


@pytest.mark.parametrize("length,dh,masked,layout", SHARES["_l17"])
def test_emulated_tc_kernels_match_plain(kernels, length, dh, masked, layout):
    check_tc_case(kernels, length, dh, masked, layout)
