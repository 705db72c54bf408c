"""The tensor-core attention kernels' CUDA source, run on the CPU.

``kernels/csrc/attention_{fwd,bwd}_tc.cu`` are compiled with g++ against
the host emulation in ``tests/cuda_emulation/`` and held to
``attention_plain`` and ``attention_bwd_plain`` at the card's tolerances
(``tests/kernel_emulation.py``, the shared home of the fixtures and of
``CASES``). This checks the kernels' fragment layouts, padding, masks and
rounding order here; whether nvcc takes the source and what the card's
tensor cores sum in which order is for ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card. B 2, 2 heads, lengths at every padding edge
of the 16-row blocks: this file holds lengths 1, 15 and 16, the vehicle
length 257 and the shared memory the kernels ask for;
``test_torch_kernel_emulation_l{17,77_packed,77_head_major,129}.py`` hold
the rest of ``CASES`` up to L 129, ``_l442.py`` and ``_l224.py`` the two
lengths past the rows the backward stages whole (B 1), and ``_chunked.py``
the chunked instances forced to short chunks.

The fp32 kernels (``kernels/csrc/attention_{fwd,bwd}.cu``: products in
three TF32 passes on ``mma.sync``, keys or queries streamed through shared
memory in tiles) run the same way and are held to ``attention_plain`` at
1e-5 max abs and to ``attention_bwd_plain`` at 1e-5 · max(1, max |plain|):
this file holds the lengths up to 77 of ``FP32_CASES``;
``test_torch_kernel_emulation_fp32_l{163,214,257,417,442}.py`` hold the
rest (163, the cross-modality configs' 288×144; 257, the vehicle configs';
417 at dh 64 and 214 at dh 128, where the CUDA-core kernels stopped; 442,
256×256 at stride 12).
"""

import numpy as np
import pytest
import torch

from kernel_emulation import (  # noqa: F401  (fixtures)
    FP32_SHARES, SHARES, _run, check_fp32_case, check_tc_case, fp32, kernels,
)
from mpreid_tpu_torch.ops import attention as tattn


@pytest.mark.parametrize("length,dh,masked,layout", SHARES[""])
def test_emulated_tc_kernels_match_plain(kernels, length, dh, masked, layout):
    check_tc_case(kernels, length, dh, masked, layout)


@pytest.mark.parametrize("dh", [64, 128])
def test_emulated_tc_kernels_need_bounded_shared_memory(kernels, dh):
    """A block's shared memory stays within the 232,448 bytes it may use at
    every length: past the rows they stage whole the tensor-core kernels
    stream the sequence in chunks, and the backward's row statistics go
    through a scratch array, so their needs stop growing with L. The
    backward asks for that scratch only where it streams."""
    limit = 232448
    for length in (385, 442, 1000, 4096):
        assert 0 < kernels["fwd_smem"](length, dh) <= limit
        assert 0 < kernels["bwd_smem"](length, dh) <= limit
    assert kernels["fwd_smem"](4096, dh) == kernels["fwd_smem"](1000 if dh == 64 else 600, dh)
    assert kernels["bwd_smem"](4096, dh) == kernels["bwd_smem"](442, dh)
    assert kernels["bwd_scratch"](2, 129, 12, dh) == 0
    assert kernels["bwd_scratch"](2, 442, 12, dh) == 3 * 2 * 12 * 448
    assert kernels["fwd_smem"](129, 96) == kernels["bwd_smem"](129, 96) == 0


def test_emulated_bwd_kernel_at_the_vehicle_length(kernels):
    """L 257 (17 query blocks, two rounds of 9 warps), where the CUDA-core
    backward ran out of shared memory."""
    qkv, do, _, out, dqkv = _run(kernels, 257, 64, False, "packed", seed=257)
    assert (out.float() - tattn.attention_plain(qkv, 2).float()).abs().max().item() <= 2e-2
    want = tattn.attention_bwd_plain(qkv, do, 2).float()
    assert (dqkv.float() - want).abs().max().item() <= 3e-2 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("length,dh,masked,layout", FP32_SHARES[""])
def test_emulated_fp32_fwd_kernel_matches_plain(fp32, length, dh, masked, layout):
    check_fp32_case(fp32, "fwd", length, dh, masked, layout)


@pytest.mark.parametrize("length,dh,masked,layout", FP32_SHARES[""])
def test_emulated_fp32_bwd_kernel_matches_plain(fp32, length, dh, masked, layout):
    check_fp32_case(fp32, "bwd", length, dh, masked, layout)


def test_emulated_fp32_bwd_takes_every_length_the_fp32_forward_takes(fp32):
    """Shared memory: both fp32 kernels stream their tiles, so a block needs
    the same bytes at every length, well inside a block's 232,448; the
    CUDA-core kernels stopped at 417 (dh 64) and 214 (dh 128)."""
    limit = 232448
    for lib, name in ((fp32.fwd, "mpreid_mha_fwd"), (fp32.bwd, "mpreid_mha_bwd")):
        assert getattr(lib, f"{name}_max_smem_bytes")() == limit
        smem = getattr(lib, f"{name}_smem_bytes")
        for dh in (64, 128):
            need = {smem(length, dh) for length in (1, 214, 215, 417, 418, 442, 4096)}
            assert len(need) == 1 and 0 < need.pop() <= limit
        assert smem(129, 96) == 0
