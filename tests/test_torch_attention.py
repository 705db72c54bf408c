"""The port's attention (mpreid_tpu_torch/ops/attention.py) against the JAX
package's: the einsum reference and the Pallas kernels in interpret mode.

Inputs come from a numpy seed and go into both packages unchanged. Shapes
are small (B 2, 2 heads × 32) at the vision length (129) and a ragged one
(17), with and without the additive causal mask that the text tower uses.
fp32 is held to 1e-5; bf16 to 2e-2 (outputs are averages of O(1) values
rounded to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.models.text import causal_mask
from mpreid_tpu.ops import attention as jattn
from mpreid_tpu_torch.ops import attention as tattn

HEADS, DH, B = 2, 32, 2
D = HEADS * DH
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=0)}


def _inputs(length, dtype, masked, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, length, 3 * D)).astype(np.float32)
    mask = np.array(causal_mask(length)) if masked else None
    jq = jnp.asarray(qkv, dtype=getattr(jnp, dtype))
    tq = torch.from_numpy(qkv).to(getattr(torch, dtype))
    tm = torch.from_numpy(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    return jq, jm, tq, tm


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


CASES = [(length, masked, dtype)
         for length in (17, 129) for masked in (False, True)
         for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("length,masked,dtype", CASES)
def test_plain_packed_matches_mha_reference(length, masked, dtype):
    jq, jm, tq, tm = _inputs(length, dtype, masked)
    want = jattn.mha_reference(jq, HEADS, jm)
    got = tattn.attention_plain(tq, HEADS, tm, layout="packed")
    assert got.dtype == tq.dtype and got.shape == (B, length, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("length,masked,dtype", CASES)
def test_plain_packed_matches_pallas_interpret(length, masked, dtype):
    jq, jm, tq, tm = _inputs(length, dtype, masked, seed=1)
    want = jattn.fused_attention(jq, HEADS, jm, force="interpret")
    got = tattn.attention_plain(tq, HEADS, tm, layout="packed")
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("length,masked,dtype", CASES)
def test_plain_head_major_matches_pallas_hm_interpret(length, masked, dtype):
    jq, jm, tq, tm = _inputs(length, dtype, masked, seed=2)
    want = jattn.fused_attention_hm(jq, HEADS, jm, force="interpret")
    got = tattn.attention_plain(tq, HEADS, tm, layout="head_major")
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_wrapper_matches_mha_reference_hm(masked):
    """The public wrapper on a CPU tensor, head-major layout, against the
    JAX head-major reference."""
    jq, jm, tq, tm = _inputs(129, "float32", masked, seed=3)
    want = jattn.mha_reference_hm(jq, HEADS, jm)
    got = tattn.fused_attention(tq, HEADS, tm, layout="head_major")
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_layouts_agree_through_head_major_perm():
    """Permuting packed columns with head_major_perm turns the packed
    problem into the head-major one: both layouts give one answer."""
    _, _, tq, _ = _inputs(17, "float32", False, seed=4)
    perm = torch.from_numpy(tattn.head_major_perm(D, HEADS).astype(np.int64))
    packed = tattn.attention_plain(tq, HEADS, layout="packed")
    hm = tattn.attention_plain(tq[..., perm], HEADS, layout="head_major")
    torch.testing.assert_close(hm, packed, atol=0, rtol=0)


@pytest.mark.parametrize("d,heads", [(64, 2), (768, 12), (512, 8)])
def test_head_major_perms_match_jax(d, heads):
    np.testing.assert_array_equal(tattn.head_major_perm(d, heads),
                                  jattn.head_major_perm(d, heads))
    np.testing.assert_array_equal(tattn.head_major_perm_inverse(d, heads),
                                  jattn.head_major_perm_inverse(d, heads))


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="layout"):
        tattn.fused_attention(torch.zeros(1, 3, 3 * D), HEADS, layout="hm_native")
