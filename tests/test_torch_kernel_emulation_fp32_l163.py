"""The fp32 attention kernels' CUDA source on the CPU: length 163 (configs/cross/sysu_rgb2ir.yml's 288×144), at dh 64 and 128.

One share of ``tests/kernel_emulation.py::FP32_CASES``, in a file of its
own so that ``pytest --dist loadfile`` runs it beside the others (see
``tests/test_torch_kernel_emulation.py``).
"""

import pytest

from kernel_emulation import FP32_SHARES, check_fp32_case, fp32  # noqa: F401


@pytest.mark.parametrize("length,dh,masked,layout", FP32_SHARES["_fp32_l163"])
def test_emulated_fp32_fwd_kernel_matches_plain(fp32, length, dh, masked, layout):
    check_fp32_case(fp32, "fwd", length, dh, masked, layout)


@pytest.mark.parametrize("length,dh,masked,layout", FP32_SHARES["_fp32_l163"])
def test_emulated_fp32_bwd_kernel_matches_plain(fp32, length, dh, masked, layout):
    check_fp32_case(fp32, "bwd", length, dh, masked, layout)
