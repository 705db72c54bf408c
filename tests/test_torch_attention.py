"""The port's attention (mpreid_tpu_torch/ops/attention.py) against the JAX
package's: the einsum reference and the Pallas kernels in interpret mode.

Inputs come from a numpy seed and go into both packages unchanged. Shapes
are small (B 2, 2 heads × 32) at the vision length (129) and a ragged one
(17), with and without the additive causal mask that the text tower uses.
fp32 is held to 1e-5; bf16 to 2e-2 (outputs are averages of O(1) values
rounded to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.models.text import causal_mask
from mpreid_tpu.ops import attention as jattn
from mpreid_tpu_torch.ops import attention as tattn

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

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


# ---------------------------------------------------------------------------
# backward: attention_bwd_plain and the FusedAttention autograd Function
# against jax.vjp of the Pallas kernels in interpret mode. fp32 is held to
# 1e-5 · max(1, max |ref|); bf16 to 3e-2 · max(1, max |ref|): dq and dk are
# products of ds rounded to bf16 and dv of p rounded to bf16, and the
# outputs themselves are rounded to bf16 (8 bits of mantissa, 4e-3 relative),
# so a sum taken in another order can land one or two bf16 steps away.
# ---------------------------------------------------------------------------

BWD_CASES = [(length, masked, dtype)
             for length in (17, 77) for masked in (False, True)
             for dtype in ("float32", "bfloat16")]
BWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _cotangent(length, dtype, seed):
    do = np.random.default_rng(seed).standard_normal((B, length, D)).astype(np.float32)
    return jnp.asarray(do, dtype=getattr(jnp, dtype)), torch.from_numpy(do).to(getattr(torch, dtype))


def _jax_dqkv(fn, jq, jm, jdo):
    _, vjp = jax.vjp(lambda q: fn(q, HEADS, jm, force="interpret"), jq)
    return vjp(jdo)[0]


def _assert_bwd_close(got, want, dtype):
    got, want = _np(got), _np(want)
    bound = BWD_TOL[dtype] * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("length,masked,dtype", BWD_CASES)
def test_bwd_plain_packed_matches_pallas_interpret(length, masked, dtype):
    jq, jm, tq, tm = _inputs(length, dtype, masked, seed=5)
    jdo, tdo = _cotangent(length, dtype, seed=6)
    want = _jax_dqkv(jattn.fused_attention, jq, jm, jdo)
    got = tattn.attention_bwd_plain(tq, tdo, HEADS, tm, layout="packed")
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("length,masked,dtype", BWD_CASES)
def test_bwd_plain_head_major_matches_pallas_hm_interpret(length, masked, dtype):
    jq, jm, tq, tm = _inputs(length, dtype, masked, seed=7)
    jdo, tdo = _cotangent(length, dtype, seed=8)
    want = _jax_dqkv(jattn.fused_attention_hm, jq, jm, jdo)
    got = tattn.attention_bwd_plain(tq, tdo, HEADS, tm, layout="head_major")
    _assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("length,masked,dtype", BWD_CASES)
def test_autograd_function_matches_jax_vjp(layout, length, masked, dtype):
    """fused_attention on a CPU tensor that requires a gradient: the forward
    and qkv.grad against the JAX package's custom VJP."""
    jfn = jattn.fused_attention if layout == "packed" else jattn.fused_attention_hm
    jq, jm, tq, tm = _inputs(length, dtype, masked, seed=9)
    jdo, tdo = _cotangent(length, dtype, seed=10)
    jout, vjp = jax.vjp(lambda q: jfn(q, HEADS, jm, force="interpret"), jq)
    tq.requires_grad_(True)
    before = tattn.fused_attention_bwd.launches
    out = tattn.fused_attention(tq, HEADS, tm, layout=layout)
    out.backward(tdo)
    assert tattn.fused_attention_bwd.launches == before  # CPU: the plain versions
    np.testing.assert_allclose(_np(out.detach()), _np(jout), **TOL[dtype])
    _assert_bwd_close(tq.grad, vjp(jdo)[0], dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_autograd_function_saves_only_qkv_and_mask(masked):
    _, _, tq, tm = _inputs(17, "float32", masked)
    tq.requires_grad_(True)
    out = tattn.fused_attention(tq, HEADS, tm)
    assert type(out.grad_fn).__name__ == "FusedAttentionBackward"
    saved = out.grad_fn.saved_tensors
    assert len(saved) == (2 if masked else 1)
    assert saved[0].data_ptr() == tq.data_ptr()
    if masked:
        assert saved[1].data_ptr() == tm.data_ptr()


def test_bwd_plain_equals_autograd_of_plain_in_fp32():
    """In fp32 no rounding point matters, so the written-out backward is the
    derivative of the plain forward."""
    _, _, tq, tm = _inputs(17, "float32", True, seed=11)
    tdo = _cotangent(17, "float32", seed=12)[1]
    tq.requires_grad_(True)
    tattn.attention_plain(tq, HEADS, tm).backward(tdo)
    got = tattn.attention_bwd_plain(tq.detach(), tdo, HEADS, tm)
    torch.testing.assert_close(got, tq.grad, atol=1e-5, rtol=1e-5)
