"""Which attention kernel a tensor takes, and the plain versions at the
256×256 vehicle length (L 257) against the JAX package.

``attention_route`` decides the kernel family from (dtype, head width)
alone, before any launch: bf16 goes to the tensor-core kernels ("tc"),
fp32 to the CUDA-core kernels ("simt"). The plain versions are what the
kernels are held to on the card, so at L 257 (configs/veri/vit_base.yml,
configs/VehicleID/vit_base.yml) they are held here to the JAX einsum
reference and to the Pallas kernels in interpret mode, tiny heads (B 2,
2 heads × 32) as in tests/test_torch_attention.py. Forward: fp32 to 1e-5,
bf16 to 2e-2 (averages of O(1) values rounded to bf16). Backward: fp32 to
1e-5 · max(1, max |ref|), bf16 to 3e-2 · max(1, max |ref|) (dq, dk of ds
rounded to bf16, dv of p rounded to bf16: an fp32 sum in another order can
land a bf16 step or two away).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.models.text import causal_mask
from mpreid_tpu.ops import attention as jattn
from mpreid_tpu_torch.kernels import build
from mpreid_tpu_torch.ops import attention as tattn

REPO = Path(__file__).resolve().parent.parent
HEADS, DH, B, L = 2, 32, 2, 257
D = HEADS * DH
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=0)}
BWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"), (torch.float32, "simt")])
def test_route_is_a_function_of_dtype_and_head_width(dtype, route, dh):
    assert tattn.attention_route(dtype, dh) == route
    assert route in tattn.ROUTES


@pytest.mark.parametrize("dtype,dh,error", [
    (torch.float16, 64, TypeError), (torch.float64, 128, TypeError),
    (torch.bfloat16, 32, ValueError), (torch.float32, 96, ValueError),
])
def test_route_refuses_what_no_kernel_takes(dtype, dh, error):
    with pytest.raises(error):
        tattn.attention_route(dtype, dh)


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_cpu_tensors_count_no_route(layout):
    """The CPU path runs the plain versions and counts no launch on any route."""
    qkv = torch.zeros(1, 5, 3 * D, requires_grad=True)
    before = (dict(tattn.fused_attention.launches_by_route),
              dict(tattn.fused_attention_bwd.launches_by_route))
    tattn.fused_attention(qkv, HEADS, layout=layout).sum().backward()
    assert (tattn.fused_attention.launches_by_route,
            tattn.fused_attention_bwd.launches_by_route) == before


def _inputs(dtype, masked, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, L, 3 * D)).astype(np.float32)
    do = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = np.array(causal_mask(L)) if masked else None
    jq, jdo = (jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in (qkv, do))
    tq, tdo = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (qkv, do))
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    return jq, jm, jdo, tq, tm, tdo


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


CASES = [(masked, dtype) for masked in (False, True) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("masked,dtype", CASES)
def test_plain_at_l257_matches_mha_reference(masked, dtype):
    jq, jm, _, tq, tm, _ = _inputs(dtype, masked, seed=20)
    want = jattn.mha_reference(jq, HEADS, jm)
    got = tattn.attention_plain(tq, HEADS, tm, layout="packed")
    assert got.shape == (B, L, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("masked,dtype", CASES)
def test_plain_at_l257_matches_pallas_interpret(layout, masked, dtype):
    jfn = jattn.fused_attention if layout == "packed" else jattn.fused_attention_hm
    jq, jm, _, tq, tm, _ = _inputs(dtype, masked, seed=21)
    want = jfn(jq, HEADS, jm, force="interpret")
    got = tattn.attention_plain(tq, HEADS, tm, layout=layout)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("masked,dtype", CASES)
def test_bwd_plain_at_l257_matches_pallas_interpret(layout, masked, dtype):
    """The backward the vehicle configs' train step takes, against jax.vjp
    of the Pallas kernel (whose VMEM holds the whole sequence)."""
    jfn = jattn.fused_attention if layout == "packed" else jattn.fused_attention_hm
    jq, jm, jdo, tq, tm, tdo = _inputs(dtype, masked, seed=22)
    _, vjp = jax.vjp(lambda q: jfn(q, HEADS, jm, force="interpret"), jq)
    want = _np(vjp(jdo)[0])
    got = _np(tattn.attention_bwd_plain(tq, tdo, HEADS, tm, layout=layout))
    bound = BWD_TOL[dtype] * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


KERNEL = "_ZN12_GLOBAL__N_117mha_bwd_tc_kernelILi{dh}EEEvPK"
PTXAS_LOG = f"""\
ptxas info    : Compiling entry function '{KERNEL.format(dh=128)}' for 'sm_90a'
ptxas info    : Function properties for {KERNEL.format(dh=128)}
    0 bytes stack frame, {{spill128}} bytes spill stores, {{spill128}} bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers
ptxas info    : Compiling entry function '{KERNEL.format(dh=64)}' for 'sm_90a'
ptxas info    : Function properties for {KERNEL.format(dh=64)}
    0 bytes stack frame, {{spill64}} bytes spill stores, {{spill64}} bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
"""


@pytest.mark.parametrize("spill64,spill128,raises", [(0, 0, False), (0, 8, False), (16, 0, True)])
def test_chip_smoke_reads_ptxas_and_refuses_spills_at_dh64(monkeypatch, spill64, spill128, raises):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    log = PTXAS_LOG.format(spill64=spill64, spill128=spill128)
    monkeypatch.setattr(build, "LOGS", {"attention_bwd_tc": log})
    if raises:
        with pytest.raises(AssertionError, match="spills registers at dh 64"):
            chip_smoke.ptxas_report(("attention_bwd_tc",))
        return
    got = chip_smoke.ptxas_report(("attention_bwd_tc", "attention_fwd_tc"))
    assert got["attention_bwd_tc"] == {
        "dh128": {"spill_stores": spill128, "spill_loads": spill128, "registers": 200},
        "dh64": {"spill_stores": 0, "spill_loads": 0, "registers": 154}}
    assert got["attention_fwd_tc"] == "built before this process: not reported"
