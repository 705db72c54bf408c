"""The tensor-core attention kernels' chunked instances on the CPU, forced
to short chunks at short lengths.

``tc_kernels(out, chunk_rows)`` builds the sources with
``MPREID_TC_CHUNK_ROWS`` defined, which sends every length through the
instances that stream the sequence (keys in the forward; the other side of
each phase, and the rows' statistics through the scratch, in the backward)
in chunks of that many rows, so several chunks, a partial last chunk and
several rounds of the warps' blocks show up at lengths the emulation runs in
seconds. Every block goes by in the same order as in the whole-sequence
instances, so the outputs are those instances' bits (the sources built as
the card builds them), and within the plain versions' tolerances
(``check_tc_case``).
"""

import shutil

import pytest
import torch

from kernel_emulation import _run, check_tc_case, kernels, tc_kernels  # noqa: F401
from mpreid_tpu_torch.ops import attention as tattn


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """chunk rows → ``tc_kernels`` built with that chunk, each built once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    built = {}

    def get(rows):
        if rows not in built:
            built[rows] = tc_kernels(tmp_path_factory.mktemp(f"emulated_c{rows}"), rows)
        return built[rows]

    return get


# (L, dh, masked, layout, chunk, heads, B): L 161 is 11 query blocks, two
# rounds of 6 warps, in chunks of 3, 3, 3 and 2 blocks; L 77 is 5 blocks,
# in chunks of 3 and 2 at dh 128 and of one block each at dh 64
CHUNKED = [(161, 64, True, "packed", 48, 2, 1), (77, 128, True, "head_major", 48, 2, 2),
           (77, 64, False, "head_major", 16, 2, 2)]


@pytest.mark.parametrize("length,dh,masked,layout,chunk,heads,b", CHUNKED)
def test_chunked_instances_give_the_whole_instances_bits(kernels, chunked, length, dh, masked,
                                                         layout, chunk, heads, b):
    seed = length + dh
    qkv, do, mask, out, dqkv = _run(chunked(chunk), length, dh, masked, layout, seed, heads, b)
    *_, whole, dwhole = _run(kernels, length, dh, masked, layout, seed, heads, b)
    assert torch.equal(out, whole) and torch.equal(dqkv, dwhole)
    want = tattn.attention_plain(qkv, heads, mask, layout)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    want = tattn.attention_bwd_plain(qkv, do, heads, mask, layout).float()
    assert (dqkv.float() - want).abs().max().item() <= 3e-2 * max(1.0, want.abs().max().item())


def test_a_chunk_of_the_whole_sequence_stages_once(chunked):
    """A chunk as long as the sequence: the chunked instances stage it once
    for every sweep and round, and still match the plain versions."""
    check_tc_case(chunked(48), 33, 64, True, "packed")
