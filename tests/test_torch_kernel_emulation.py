"""The tensor-core attention kernels' CUDA source, run on the CPU.

``kernels/csrc/attention_{fwd,bwd}_tc.cu`` are compiled with g++ against
the host emulation in ``tests/cuda_emulation/`` and held to
``attention_plain`` and ``attention_bwd_plain`` at the card's tolerances
(``tests/kernel_emulation.py``, the shared home of the fixtures and of
``CASES``). This checks the kernels' fragment layouts, padding, masks and
rounding order here; whether nvcc takes the source and what the card's
tensor cores sum in which order is for ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card. B 2, 2 heads, lengths at every padding edge
of the 16-row blocks: this file holds lengths 1, 15 and 16 and the vehicle
length 257; ``test_torch_kernel_emulation_l{17,77_packed,77_head_major,129}.py``
hold the rest of ``CASES``.

The CUDA-core fp32 backward (``kernels/csrc/attention_bwd.cu``, two phases
with no L × L buffer) runs the same way, at the lengths its earlier design
refused (163, the cross-modality configs' 288×144; 257, the vehicle
configs'; the fp32 forward's longest, 417 at dh 64 and 214 at dh 128), and
is held to ``attention_bwd_plain`` at 1e-5 · max(1, max |plain|).
"""

import numpy as np
import pytest
import torch

from kernel_emulation import (  # noqa: F401  (fixtures)
    SHARES, SIMT_CASES, _run, check_tc_case, kernels, one_core, simt_bwd,
)
from mpreid_tpu_torch.ops import attention as tattn


@pytest.mark.parametrize("length,dh,masked,layout", SHARES[""])
def test_emulated_tc_kernels_match_plain(kernels, length, dh, masked, layout):
    check_tc_case(kernels, length, dh, masked, layout)


def test_emulated_bwd_kernel_at_the_vehicle_length(kernels):
    """L 257 (17 query blocks, two rounds of 9 warps), where the CUDA-core
    backward ran out of shared memory."""
    qkv, do, _, out, dqkv = _run(kernels, 257, 64, False, "packed", seed=257)
    assert (out.float() - tattn.attention_plain(qkv, 2).float()).abs().max().item() <= 2e-2
    want = tattn.attention_bwd_plain(qkv, do, 2).float()
    assert (dqkv.float() - want).abs().max().item() <= 3e-2 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("length,dh,masked,layout", SIMT_CASES)
def test_emulated_fp32_bwd_kernel_matches_plain(simt_bwd, length, dh, masked, layout):
    heads, b = 2, 1
    d = heads * dh
    rng = np.random.default_rng(length + dh)
    qkv = torch.from_numpy(rng.standard_normal((b, length, 3 * d)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((b, length, d)).astype(np.float32))
    mask = torch.full((length, length), float("-inf")).triu(1) if masked else None
    dqkv = torch.full_like(qkv, float("nan"))
    stats = torch.empty(simt_bwd.mpreid_mha_bwd_scratch_floats(b, length, heads))
    offsets = tattn._column_offsets(d, dh, layout)
    with one_core():
        rc = simt_bwd.mpreid_mha_bwd(qkv.data_ptr(), mask.data_ptr() if masked else None,
                                     do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b,
                                     length, heads, dh, 3 * d, *offsets, dh ** -0.5, None)
    assert rc == 0
    want = tattn.attention_bwd_plain(qkv, do, heads, mask, layout)
    err = (dqkv - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item())


def test_emulated_fp32_bwd_takes_every_length_the_fp32_forward_takes(simt_bwd):
    """Shared memory: the backward's limits are the forward's (417 at dh 64,
    214 at dh 128); the kernel it replaces stopped at 139 and 94."""
    limit = 232448
    for dh, longest in ((64, 417), (128, 214)):
        assert simt_bwd.mpreid_mha_bwd_smem_bytes(longest, dh) <= limit
        assert simt_bwd.mpreid_mha_bwd_smem_bytes(longest + 1, dh) > limit
