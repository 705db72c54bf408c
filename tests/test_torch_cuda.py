"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a card. The file
imports nothing of JAX, so on the card's machine it runs without the
repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

fp32 is held to 1e-5 and bf16 to 2e-2, as in chip_smoke.py. bf16 attention
runs on the bf16 tensor-core kernels (route "tc"), fp32 on the kernels that
take each product on the tensor cores in three TF32 passes (route
"tf32x3").
"""

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.ops import attention as tattn

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ROUTE = {torch.float32: "tf32x3", torch.bfloat16: "tc"}
# every padding edge of the 16-row blocks, the text and vision lengths, and
# the 256x256 vehicle configs' L 257
LENGTHS = [1, 15, 16, 17, 77, 129, 257]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(card, b, length, heads, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, 3 * heads * dh)).astype(np.float32)
    return torch.from_numpy(x).to(card, dtype)


def _causal(card, length):
    return torch.full((length, length), float("-inf"), device=card).triu(1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dh", [64, 128])
def test_kernel_matches_plain(card, layout, dtype, length, masked, dh):
    qkv = _qkv(card, 3, length, 2, dh, dtype)
    mask = _causal(card, length) if masked else None
    before = tattn.fused_attention.launches
    routed = tattn.fused_attention.launches_by_route[ROUTE[dtype]]
    got = tattn.fused_attention(qkv, 2, mask, layout=layout)
    want = tattn.attention_plain(qkv, 2, mask, layout=layout)
    torch.cuda.synchronize()
    assert tattn.fused_attention.launches == before + 1
    assert tattn.fused_attention.launches_by_route[ROUTE[dtype]] == routed + 1
    assert got.dtype == dtype and got.shape == (3, length, 2 * dh)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_at_the_vision_shape(card):
    qkv = _qkv(card, 64, 129, 12, 64, torch.bfloat16, seed=1)
    got = tattn.fused_attention(qkv, 12)
    want = tattn.attention_plain(qkv, 12)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_kernel_at_the_vehicle_shape(card, layout):
    """configs/veri/vit_base.yml: 256x256 at stride 16, L 257, 12 x 64."""
    qkv = _qkv(card, 64, 257, 12, 64, torch.bfloat16, seed=14)
    got = tattn.fused_attention(qkv, 12, layout=layout)
    want = tattn.attention_plain(qkv, 12, layout=layout)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    qkv = _qkv(card, 2, 17, 2, 64, torch.float32)
    with pytest.raises(TypeError):
        tattn.fused_attention(qkv.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.fused_attention(qkv.transpose(0, 1), 2)
    with pytest.raises(ValueError, match="head widths"):
        tattn.fused_attention(_qkv(card, 2, 17, 2, 32, torch.float32), 2)
    with pytest.raises(ValueError, match="mask"):
        tattn.fused_attention(qkv, 2, _causal(card, 16))


@pytest.mark.cuda
def test_tiny_model_on_the_card_matches_the_cpu(card):
    from mpreid_tpu_torch.config import get_default_cfg
    from mpreid_tpu_torch.models import make_model

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.MODEL.DEBUG_TINY = True
    cfg.MODEL.DEVICE = "cpu"
    cfg.INPUT.SIZE_TRAIN = [64, 32]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cpu_model = make_model(cfg, 8, 2, 1)
    gpu_model = make_model(cfg, 8, 2, 1, device=card)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 64, 32, 3))
                         .astype(np.float32))
    before = tattn.fused_attention.launches
    with torch.no_grad():
        want = cpu_model.forward_eval(x)
        got = gpu_model.forward_eval(x.to(card)).cpu()
    assert tattn.fused_attention.launches == before + 2  # one per block
    assert (got - want).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# attention backward kernel (kernels/csrc/attention_bwd.cu): fp32 to
# 1e-5 · max(1, max |plain|), bf16 to 3e-2 · max(1, max |plain|) (an fp32
# sum in another order can round to the neighbouring bf16 value)
# ---------------------------------------------------------------------------

BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def _bwd_err(got, want):
    return (got.float() - want.float()).abs().max().item() / max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dh", [64, 128])
def test_bwd_kernel_matches_plain(card, layout, dtype, length, masked, dh):
    """L 257 in bf16 at dh 64 pins the fault of the CUDA-core backward, which
    held the L x L probabilities in shared memory and refused bf16 above L
    178; at dh 128 it is past the 208 rows the tensor-core backward stages
    whole, so it streams them."""
    qkv = _qkv(card, 3, length, 2, dh, dtype, seed=3)
    do = _qkv(card, 3, length, 2, dh, dtype, seed=4)[..., :2 * dh].contiguous()
    mask = _causal(card, length) if masked else None
    before = tattn.fused_attention_bwd.launches
    routed = tattn.fused_attention_bwd.launches_by_route[ROUTE[dtype]]
    got = tattn.fused_attention_bwd(qkv, do, 2, mask, layout=layout)
    want = tattn.attention_bwd_plain(qkv, do, 2, mask, layout=layout)
    torch.cuda.synchronize()
    assert tattn.fused_attention_bwd.launches == before + 1
    assert tattn.fused_attention_bwd.launches_by_route[ROUTE[dtype]] == routed + 1
    assert got.dtype == dtype and got.shape == qkv.shape
    assert _bwd_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dh", [64, 128])
def test_bwd_kernel_is_deterministic(card, masked, dh):
    """No atomics and every sum in a fixed order: two launches on the same
    inputs give the same bits."""
    qkv = _qkv(card, 8, 129, 4, dh, torch.bfloat16, seed=15)
    do = _qkv(card, 8, 129, 4, dh, torch.bfloat16, seed=16)[..., :4 * dh].contiguous()
    mask = _causal(card, 129) if masked else None
    first = tattn.fused_attention_bwd(qkv, do, 4, mask)
    second = tattn.fused_attention_bwd(qkv, do, 4, mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_dtype_takes_its_route(card, dtype):
    """bf16 launches count on "tc", fp32 on "tf32x3", forward and backward."""
    qkv = _qkv(card, 2, 77, 2, 64, dtype, seed=17).requires_grad_(True)
    do = _qkv(card, 2, 77, 2, 64, dtype, seed=18)[..., :128].contiguous()
    counters = (tattn.fused_attention, tattn.fused_attention_bwd)
    before = [dict(fn.launches_by_route) for fn in counters]
    tattn.fused_attention(qkv, 2, _causal(card, 77)).backward(do)
    torch.cuda.synchronize()
    for fn, was in zip(counters, before):
        moved = {r: fn.launches_by_route[r] - was[r] for r in tattn.ROUTES}
        assert moved == {r: int(r == ROUTE[dtype]) for r in tattn.ROUTES}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 129, 12, False), (64, 77, 8, True), (64, 257, 12, False)])
def test_bwd_kernel_at_the_main_shapes(card, shape):
    b, length, heads, masked = shape
    qkv = _qkv(card, b, length, heads, 64, torch.bfloat16, seed=5)
    do = _qkv(card, b, length, heads, 64, torch.bfloat16, seed=6)[..., :heads * 64].contiguous()
    mask = _causal(card, length) if masked else None
    got = tattn.fused_attention_bwd(qkv, do, heads, mask)
    want = tattn.attention_bwd_plain(qkv, do, heads, mask)
    torch.cuda.synchronize()
    assert _bwd_err(got, want) <= BWD_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("length", [163, 257, 442])
def test_fp32_bwd_kernel_at_the_long_shapes(card, length, layout):
    """The fp32 backward at the lengths its earlier designs refused: 163
    (configs/cross/sysu_rgb2ir.yml, 288x144), 257 (the 256x256 vehicle
    configs) and 442 (256x256 at stride 12), B 64 x 12 heads x 64, held to
    its plain version at 1e-5 x max(1, max |plain|), and deterministic."""
    qkv = _qkv(card, 64, length, 12, 64, torch.float32, seed=length)
    do = _qkv(card, 64, length, 12, 64, torch.float32, seed=length + 1)[..., :768].contiguous()
    routed = tattn.fused_attention_bwd.launches_by_route["tf32x3"]
    got = tattn.fused_attention_bwd(qkv, do, 12, layout=layout)
    again = tattn.fused_attention_bwd(qkv, do, 12, layout=layout)
    want = tattn.attention_bwd_plain(qkv, do, 12, layout=layout)
    torch.cuda.synchronize()
    assert tattn.fused_attention_bwd.launches_by_route["tf32x3"] == routed + 2
    assert _bwd_err(got, want) <= BWD_TOL[torch.float32]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_launches_both_kernels(card, dtype):
    qkv = _qkv(card, 2, 129, 2, 64, dtype, seed=7).requires_grad_(True)
    do = _qkv(card, 2, 129, 2, 64, dtype, seed=8)[..., :128].contiguous()
    fwd, bwd = tattn.fused_attention.launches, tattn.fused_attention_bwd.launches
    tattn.fused_attention(qkv, 2).backward(do)
    torch.cuda.synchronize()
    assert (tattn.fused_attention.launches, tattn.fused_attention_bwd.launches) == (fwd + 1, bwd + 1)
    want = tattn.attention_bwd_plain(qkv.detach(), do, 2)
    assert _bwd_err(qkv.grad, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(card):
    qkv = _qkv(card, 2, 17, 2, 64, torch.float32)
    do = torch.zeros(2, 17, 128, device=card)
    with pytest.raises(TypeError):
        tattn.fused_attention_bwd(qkv.half(), do.half(), 2)
    with pytest.raises(ValueError, match="do must be"):
        tattn.fused_attention_bwd(qkv, do.bfloat16(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.fused_attention_bwd(qkv, do.transpose(0, 1).contiguous().transpose(0, 1), 2)
    with pytest.raises(ValueError, match="head widths"):
        tattn.fused_attention_bwd(_qkv(card, 2, 17, 2, 32, torch.float32), do[..., :64], 2)
    # no length is refused: bf16 L 400 at dh 64, past the 384 rows the
    # backward stages whole, runs on "tc"
    qkv = _qkv(card, 1, 400, 1, 64, torch.bfloat16, seed=400)
    do = _qkv(card, 1, 400, 1, 64, torch.bfloat16, seed=401)[..., :64].contiguous()
    routed = tattn.fused_attention_bwd.launches_by_route["tc"]
    got = tattn.fused_attention_bwd(qkv, do, 1)
    want = tattn.attention_bwd_plain(qkv, do, 1)
    torch.cuda.synchronize()
    assert tattn.fused_attention_bwd.launches_by_route["tc"] == routed + 1
    assert _bwd_err(got, want) <= BWD_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,dh", [(418, 64), (442, 64), (1000, 64), (215, 128), (600, 128)])
def test_kernels_take_any_length(card, length, dh, dtype):
    """Shared memory does not grow with L in either family: the fp32
    kernels stream their key (or query) tiles, past the 417 (dh 64) and 214
    (dh 128) the CUDA-core kernels stopped at; the bf16 ones stream chunks
    past the 800 / 384 rows (dh 64, forward / backward) and 416 / 208 (dh
    128) they stage whole. Both directions run on their dtype's route and
    match their plain versions, causal mask included."""
    qkv = _qkv(card, 2, length, 2, dh, dtype, seed=length)
    do = _qkv(card, 2, length, 2, dh, dtype, seed=length + 1)[..., :2 * dh].contiguous()
    mask = _causal(card, length)
    counters = (tattn.fused_attention, tattn.fused_attention_bwd)
    before = [fn.launches_by_route[ROUTE[dtype]] for fn in counters]
    got = tattn.fused_attention(qkv, 2, mask)
    want = tattn.attention_plain(qkv, 2, mask)
    dgot = tattn.fused_attention_bwd(qkv, do, 2, mask)
    dwant = tattn.attention_bwd_plain(qkv, do, 2, mask)
    torch.cuda.synchronize()
    assert [fn.launches_by_route[ROUTE[dtype]] for fn in counters] == [n + 1 for n in before]
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert _bwd_err(dgot, dwant) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("length,dh", [(442, 64), (1000, 64), (600, 128)])
def test_streamed_bf16_kernels_are_deterministic(card, length, dh):
    """Past the rows they stage whole the bf16 kernels carry every running
    value across chunks in a fixed order: two launches give the same bits."""
    qkv = _qkv(card, 4, length, 2, dh, torch.bfloat16, seed=length + 2)
    do = _qkv(card, 4, length, 2, dh, torch.bfloat16, seed=length + 3)[..., :2 * dh].contiguous()
    mask = _causal(card, length)
    outs = [tattn.fused_attention(qkv, 2, mask) for _ in range(2)]
    grads = [tattn.fused_attention_bwd(qkv, do, 2, mask) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*outs) and torch.equal(*grads)


# ---------------------------------------------------------------------------
# Adam kernel (kernels/csrc/adam.cu): every operation rounded on its own, as
# the plain version's separate PyTorch ops are, so m and v are held to 1e-6
# relative, and p to 1e-6 relative plus 1e-3·lr (PyTorch divides a CUDA
# tensor by a scalar as a product with the reciprocal, so the step can
# differ in its last bits, which shows where p - step cancels)
# ---------------------------------------------------------------------------

def _adam_leaf(card, n, moment_dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    p = torch.randn(n, device=card, generator=g)
    grad = torch.randn(n, device=card, generator=g) * 1e-3
    m = (torch.randn(n, device=card, generator=g) * 1e-3).to(moment_dtype)
    v = (torch.rand(n, device=card, generator=g) * 1e-6).to(moment_dtype)
    return p, m, v, grad


@pytest.mark.cuda
@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("n", [3072 * 768, 262144 + 13, 5])
def test_adam_kernel_matches_plain(card, moment_dtype, decoupled, n):
    from mpreid_tpu_torch.ops import adam

    p, m, v, grad = _adam_leaf(card, n, moment_dtype)
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    lr = 5e-6 * 2
    scalars = torch.tensor([lr, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device=card)
    args = (scalars, 0.9, 0.999, 1e-8, 1e-4, decoupled)
    before = adam.fused_adam_leaf.launches
    adam.fused_adam_leaf(p, m, v, grad, *args)
    adam.adam_leaf_plain(p2, m2, v2, grad, *args)
    torch.cuda.synchronize()
    assert adam.fused_adam_leaf.launches == before + 1
    for got, want, atol in ((p, p2, 1e-3 * lr), (m, m2, 0.0), (v, v2, 0.0)):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-6, atol=atol)


@pytest.mark.cuda
def test_adam_wrapper_refuses_what_the_kernel_does_not_take(card):
    from mpreid_tpu_torch.ops import adam

    p, m, v, grad = _adam_leaf(card, 64, torch.float32)
    scalars = torch.tensor([1e-3, 0.1, 0.001], device=card)
    args = (scalars, 0.9, 0.999, 1e-8, 0.0, False)
    with pytest.raises(TypeError):
        adam.fused_adam_leaf(p.half(), m, v, grad, *args)
    with pytest.raises(TypeError):
        adam.fused_adam_leaf(p, m.bfloat16(), v, grad, *args)
    with pytest.raises(ValueError, match="shape"):
        adam.fused_adam_leaf(p, m[:32], v, grad, *args)
    with pytest.raises(ValueError, match="aligned"):
        adam.fused_adam_leaf(p[1:], m[1:], v[1:], grad[1:], *args)
    for bad in (scalars.double(), scalars[:2], scalars.cpu()):
        with pytest.raises(ValueError, match="scalars"):
            adam.fused_adam_leaf(p, m, v, grad, bad, *args[1:])


# ---------------------------------------------------------------------------
# the multi-tensor Adam kernel (multi_adam_kernel, ops/adam.py::adam_leaves):
# each element through the per-leaf kernel's function, every operation
# rounded on its own, and the card's torch.sqrt correctly rounded, so the
# table gives the plain version's bits
# ---------------------------------------------------------------------------

TABLE_SIZES = (1, 7, 768, 2304, 99072, 262145)


def _adam_table(card, moment_dtype, seed=0):
    """Leaves (p, m, v, g, lr multiplier, weight decay) of ``TABLE_SIZES``
    elements and one of 1,000 whose tensors start 4 bytes off a 16-byte
    boundary."""
    leaves = []
    for i, n in enumerate(TABLE_SIZES + (1001,)):
        p, m, v, grad = _adam_leaf(card, n, moment_dtype, seed=seed + i)
        if n == 1001:
            p, m, v, grad = p[1:], m[1:], v[1:], grad[1:]
            assert p.data_ptr() % 16 == 4
        leaves.append((p, m, v, grad, 1.0 + i % 2, 1e-4 * (i % 3)))
    return leaves


def _opt_scalars(card, t, lr):
    return {mult: torch.tensor([lr * mult, 1 - 0.9 ** t, 1 - 0.999 ** t], device=card)
            for mult in (1.0, 2.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoupled", [False, True])
def test_multi_adam_kernel_gives_the_plain_bits(card, moment_dtype, decoupled):
    from mpreid_tpu_torch.ops import adam

    leaves = _adam_table(card, moment_dtype)
    plain = [(*(t.clone() for t in leaf[:4]), *leaf[4:]) for leaf in leaves]
    empty = [torch.empty(0, device=card), *(torch.empty(0, device=card, dtype=moment_dtype)
                                              for _ in range(2)), torch.empty(0, device=card)]
    before = (adam.adam_leaves.launches, adam.adam_leaves.leaves, adam.fused_adam_leaf.launches)
    for t in (1, 2, 3):
        scalars = _opt_scalars(card, t, 3e-4)
        # a leaf of no elements among them: skipped, and not counted
        adam.adam_leaves([(p, m, v, g, scalars[mult], wd) for p, m, v, g, mult, wd in leaves]
                         + [(*empty, scalars[1.0], 0.0)], 0.9, 0.999, 1e-8, decoupled)
        for p, m, v, g, mult, wd in plain:
            adam.adam_leaf_plain(p, m, v, g, scalars[mult], 0.9, 0.999, 1e-8, wd, decoupled)
    torch.cuda.synchronize()
    after = (adam.adam_leaves.launches, adam.adam_leaves.leaves, adam.fused_adam_leaf.launches)
    assert [a - b for a, b in zip(after, before)] == [3, 3 * len(leaves), 0]
    for got, want in zip(leaves, plain):
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and torch.equal(a, b), (a.numel(), a.dtype)


@pytest.mark.cuda
def test_adam_leaves_refuses_what_the_kernel_does_not_take(card):
    from mpreid_tpu_torch.ops import adam

    p, m, v, grad = _adam_leaf(card, 64, torch.float32)
    scalars = torch.tensor([1e-3, 0.1, 0.001], device=card)
    args = (0.9, 0.999, 1e-8, False)

    def table(*leaf, wd=0.0):
        return [(p, m, v, grad, scalars, 0.0), (*leaf, wd)]

    with pytest.raises(TypeError):
        adam.adam_leaves(table(p.half(), m, v, grad, scalars), *args)
    with pytest.raises(TypeError, match="one type"):
        adam.adam_leaves(table(p, m.bfloat16(), v.bfloat16(), grad, scalars), *args)
    with pytest.raises(ValueError, match="shape"):
        adam.adam_leaves(table(p, m[:32], v, grad, scalars), *args)
    with pytest.raises(ValueError, match="contiguous"):
        adam.adam_leaves(table(p[::2], m[::2], v[::2], grad[::2], scalars), *args)
    with pytest.raises(ValueError, match="one device"):
        adam.adam_leaves(table(p.cpu(), m.cpu(), v.cpu(), grad.cpu(), scalars), *args)
    for bad in (scalars.double(), scalars[:2], scalars.cpu()):
        with pytest.raises(ValueError, match="scalars"):
            adam.adam_leaves(table(p, m, v, grad, bad), *args)


def _stage2a_optimizer(card, fused):
    """The Uni-Prompt ViT-B/16 of configs/ours/cctv_ir_cctv_rgb.yml on the
    card (751 classes) and its stage-2a optimizer."""
    from pathlib import Path

    from mpreid_tpu_torch.config import get_default_cfg
    from mpreid_tpu_torch.models.factory import build_model_uniprompt
    from mpreid_tpu_torch.solver import make_optimizer

    cfg = get_default_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs" / "ours"
                            / "cctv_ir_cctv_rgb.yml"))
    cfg.SOLVER.STAGE2.FUSED_ADAM = fused
    with torch.device(card):
        model = build_model_uniprompt(cfg, 751, 6, 1)
    gen = torch.Generator(device=card).manual_seed(17)
    with torch.no_grad():
        for p in model.parameters():  # some are left uninitialised by the build
            p.copy_(torch.randn(p.shape, device=card, generator=gen) * 0.02)
    return model, make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_stage2a_update_is_one_launch_with_the_plain_bits(card, fused):
    """``Optimizer.update`` over stage 2a's 161 trainable leaves, 3 steps:
    one launch of the table a step, 161 leaves in it with FUSED_ADAM off (no
    per-leaf launch), 108 beside 53 per-leaf launches with it on; every
    leaf's p, m and v bit for bit the per-op plain path's."""
    from mpreid_tpu_torch.ops import adam

    model, opt = _stage2a_optimizer(card, fused)
    train, _ = opt.partition(model)
    big = {k for k, p in train.items() if p.numel() >= adam.MIN_FUSED_SIZE}
    assert len(train) == 161 and len(big) == 53
    state, plain = opt.init(model), opt.init(model)
    plain_p = {k: p.detach().clone() for k, p in train.items()}
    gen = torch.Generator(device=card).manual_seed(23)
    lr = 5e-6
    before = (adam.fused_adam_leaf.launches, adam.adam_leaves.launches, adam.adam_leaves.leaves)
    for _ in range(3):
        grads = {k: torch.randn(p.shape, device=card, generator=gen) * 1e-3
                 for k, p in train.items()}
        opt.update(grads, state, train, lr)
        opt.set_lr(plain, lr)
        plain.step.add_(1)
        scalars = opt.step_scalars(plain)
        for k in train:
            adam.adam_leaf_plain(plain_p[k], plain.mu[k], plain.nu[k], grads[k],
                                 scalars[opt.lr_mult[k]], opt.b1, opt.b2, opt.eps, opt.wd[k],
                                 opt.name == "AdamW")
    torch.cuda.synchronize()
    after = (adam.fused_adam_leaf.launches, adam.adam_leaves.launches, adam.adam_leaves.leaves)
    want = [3 * 53, 3, 3 * 108] if fused else [0, 3, 3 * 161]
    assert [a - b for a, b in zip(after, before)] == want
    for k, p in train.items():
        for a, b in ((p.detach(), plain_p[k]), (state.mu[k], plain.mu[k]),
                     (state.nu[k], plain.nu[k])):
            assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# the training path on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_linear_bf16_backward_on_the_card(card):
    """linear_f32acc in bf16 takes a gradient on the card (fp32-summed dx and
    dW rounded to bf16): within one bf16 step (2⁻⁷ relative) of the fp32
    products, plus 1e-4 of the largest value for fp32 sums taken in another
    order where they cancel."""
    from mpreid_tpu_torch.models.layers import linear_f32acc

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 129, 768)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2304, 768)).astype(np.float32) * 0.03)
    dy = torch.from_numpy(rng.standard_normal((4, 129, 2304)).astype(np.float32))
    xc = x.to(card, torch.bfloat16).requires_grad_(True)
    wc = w.to(card).requires_grad_(True)
    dyc = dy.to(card, torch.bfloat16)
    linear_f32acc(xc, wc, None, torch.bfloat16).backward(dyc)
    wb, dyf = wc.detach().bfloat16().float(), dyc.float().reshape(-1, 2304)
    dx = (dyf @ wb).reshape(xc.shape)
    dw = dyf.t() @ xc.detach().float().reshape(-1, 768)
    assert wc.grad.dtype == torch.float32
    for got, want in ((xc.grad.float(), dx), (wc.grad, dw)):
        assert ((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-4 * want.abs().max()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_bmm_f32_on_the_card_matches_the_cpu(card, out_dtype):
    """The RN50 attention pool's products (``ops/matmul.py::bmm_f32``) at
    its shape (64 × 32 heads, L 129, dh 64): bf16 operands summed in fp32 on
    the card, forward and both gradients, against the same function on the
    CPU (bf16 values, fp32 math), each to TOL of its dtype × max(1, max|cpu|)."""
    from mpreid_tpu_torch.ops.matmul import bmm_f32

    rng = np.random.default_rng(12)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
            for s in ((64, 32, 129, 64), (64, 32, 64, 129)))
    g = torch.from_numpy(rng.standard_normal((64, 32, 129, 129)).astype(np.float32))
    g = g.to(out_dtype)
    results = []
    for device in ("cpu", card):
        ad, bd = (t.to(device).detach().requires_grad_(True) for t in (a, b))
        out = bmm_f32(ad, bd, out_dtype)
        out.backward(g.to(device))
        results.append([t.detach().cpu() for t in (out, ad.grad, bd.grad)])
    for want, got in zip(*results):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= TOL[got.dtype] * scale


@pytest.mark.cuda
def test_tiny_train_step_on_the_card_matches_the_cpu(card):
    """fp32 tiny train step, augmentation off: loss and gradients on the card
    (both attention kernels, 2 launches each) against the CPU's plain path,
    each leaf to a norm-relative 1e-4 (floored at 1e-3 of the largest)."""
    from mpreid_tpu_torch.config import get_default_cfg
    from mpreid_tpu_torch.engine import loss_and_grads
    from mpreid_tpu_torch.losses import make_loss
    from mpreid_tpu_torch.models import make_model
    from mpreid_tpu_torch.solver import make_optimizer

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.MODEL.DEBUG_TINY = True
    cfg.MODEL.DEVICE = "cpu"
    cfg.INPUT.SIZE_TRAIN = [64, 32]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.DATALOADER.SAMPLER = "softmax_triplet"
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((8, 64, 32, 3))
                         .astype(np.float32))
    target = torch.arange(2).repeat_interleave(4)
    results = []
    for device in ("cpu", card):
        model = make_model(cfg, 8, 2, 1, device=device)
        loss_fn, _ = make_loss(cfg, 8)
        opt = make_optimizer(cfg.SOLVER, model)
        fwd, bwd = tattn.fused_attention.launches, tattn.fused_attention_bwd.launches
        loss, _, grads, _ = loss_and_grads(model, cfg, loss_fn, opt, x.to(device),
                                           target.to(device))
        torch.cuda.synchronize()
        launched = (tattn.fused_attention.launches - fwd, tattn.fused_attention_bwd.launches - bwd)
        assert launched == ((0, 0) if device == "cpu" else (2, 2))
        results.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    (cpu_loss, cpu_g), (card_loss, card_g) = results
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    floor = 1e-3 * max(g.norm().item() for g in cpu_g.values())
    for name, g in card_g.items():
        assert (g - cpu_g[name]).norm().item() <= 1e-4 * max(cpu_g[name].norm().item(), floor), name


# ---------------------------------------------------------------------------
# pairwise L1 / min-sum kernels (kernels/csrc/pairwise_cross.cu), against the
# plain versions: fp32 sums of K terms in another order, so max abs error
# ≤ 1e-5 × max(1, max|plain|)
# ---------------------------------------------------------------------------

def _pairwise(name):
    from mpreid_tpu_torch.ops import pairwise

    return getattr(pairwise, name), getattr(pairwise, f"{name}_plain")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["l1_cross", "minsum_cross"])
@pytest.mark.parametrize("q", [1, 7, 64, 65, 129])
@pytest.mark.parametrize("g,n", [(1, 1), (70, 600), (129, 33), (65, 1031)])
def test_pairwise_kernel_matches_plain(card, name, q, g, n):
    kernel, plain = _pairwise(name)
    rng = np.random.default_rng(q * 1000 + g + n)
    a = torch.from_numpy(np.abs(rng.standard_normal((q, n))).astype(np.float32)).to(card)
    b = torch.from_numpy(np.abs(rng.standard_normal((g, n))).astype(np.float32)).to(card)
    before = kernel.launches
    got = kernel(a, b)
    want = plain(a, b)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (q, g)
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["l1_cross", "minsum_cross"])
def test_pairwise_kernel_takes_strided_rows(card, name):
    """Densified sparse rows are a view with row stride n + 1."""
    kernel, plain = _pairwise(name)
    rng = np.random.default_rng(3)
    wide = torch.from_numpy(rng.random((40, 301), np.float32)).to(card)
    a, b = wide[:13, :300], wide[13:, :300]
    got = kernel(a, b)
    want = plain(a.contiguous(), b.contiguous())
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["l1_cross", "minsum_cross"])
def test_pairwise_wrapper_refuses_what_the_kernel_does_not_take(card, name):
    kernel, _ = _pairwise(name)
    a = torch.rand(8, 16, device=card)
    with pytest.raises(TypeError, match="fp32"):
        kernel(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous rows"):
        kernel(a.t(), a.t())
    with pytest.raises(ValueError, match="one device"):
        kernel(a, a.cpu())


@pytest.mark.cuda
def test_reranking_on_the_card_matches_the_cpu(card):
    """Dense re-ranking (one l1_cross launch) and sparse exact re-ranking
    (one minsum_cross launch per gallery chunk) on the card against the
    CPU's plain path, fp32, 1e-4 max abs."""
    from mpreid_tpu_torch.ops import l1_cross, minsum_cross, re_ranking, re_ranking_sparse

    rng = np.random.default_rng(12)
    centers = rng.standard_normal((10, 32)).astype(np.float32)
    feats = centers[rng.integers(0, 10, 200)] + 0.5 * rng.standard_normal((200, 32))
    qf, gf = torch.from_numpy(feats[:40].astype(np.float32)), \
        torch.from_numpy(feats[40:].astype(np.float32))
    l1, ms = l1_cross.launches, minsum_cross.launches
    dense = re_ranking(qf.to(card), gf.to(card), k1=20, k2=6)
    sparse = re_ranking_sparse(qf.to(card), gf.to(card), k1=20, k2=6, g_chunk=64)
    torch.cuda.synchronize()
    assert (l1_cross.launches - l1, minsum_cross.launches - ms) == (1, 3)
    for got, want in ((dense, re_ranking(qf, gf, k1=20, k2=6)),
                      (sparse, re_ranking_sparse(qf, gf, k1=20, k2=6, g_chunk=64))):
        assert (got.cpu() - want).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# batch-hard kernel (kernels/csrc/batch_hard.cu), against batch_hard_plain:
# distances to 1e-5 × max(1, max|plain|) (dot products summed in another
# order); indices equal wherever the best two candidates of a row differ by
# more than that; features on a grid of 1/4 (exact distances) hold ties and
# degenerate rows bit for bit
# ---------------------------------------------------------------------------

def _hard_case(card, b, d, dtype, grid=False, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.integers(-4, 5, (b, d)) / 4 if grid else rng.standard_normal((b, d))
    labels = np.repeat(np.arange(-(-b // 4)), 4)[:b]
    return (torch.from_numpy(f.astype(np.float32)).to(card, dtype),
            torch.from_numpy(labels.astype(np.int32)).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d", [(64, 768), (60, 768), (16, 32), (12, 40), (200, 129), (3, 8),
                                 (100, 768), (600, 96)])
def test_batch_hard_kernel_matches_plain(card, dtype, b, d):
    from mpreid_tpu_torch.ops import batch_hard as bh

    f, labels = _hard_case(card, b, d, dtype, seed=b + d)
    before = bh.fused_batch_hard.launches
    got = bh.batch_hard_mining(f, labels)
    want = bh.batch_hard_plain(f, labels)
    torch.cuda.synchronize()
    assert bh.fused_batch_hard.launches == before + 1
    assert [t.dtype for t in got] == [torch.float32, torch.float32, torch.int32, torch.int32]
    fin = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(got[1]), fin)
    scale = max(1.0, want[0].abs().max().item(), want[1][fin].abs().max().item() if fin.any() else 0)
    tol = 1e-5 * scale
    assert (got[0] - want[0]).abs().max().item() <= tol
    if fin.any():
        assert (got[1] - want[1])[fin].abs().max().item() <= tol
    # indices: equal wherever no other candidate lies within the tolerance
    from mpreid_tpu_torch.losses.triplet import euclidean_dist

    dist = euclidean_dist(f.float(), f.float())
    same = labels[:, None] == labels[None, :]
    for vals, idx, ref, mask in ((want[0], got[2], want[2], same),
                                 (want[1], got[3], want[3], ~same)):
        clear = (((dist - vals[:, None]).abs() <= tol) & mask).sum(1) == 1
        assert torch.equal(idx[clear], ref[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("labels", [
    [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3],   # a singleton identity
    [0] * 12,                                # one identity: no negatives
    list(range(12)),                         # every row its own identity
    [0, 1, 0, 1, 2, 2, 2, 2, 0, 1, 3, 3],   # with duplicated rows: ties
])
def test_batch_hard_kernel_degenerate_rows_and_ties(card, dtype, labels):
    from mpreid_tpu_torch.ops import batch_hard as bh

    rng = np.random.default_rng(5)
    base = rng.integers(-4, 5, (4, 96)) / 4
    f = torch.from_numpy(np.concatenate([base, base, base]).astype(np.float32)).to(card, dtype)
    lab = torch.tensor(labels, dtype=torch.int32, device=card)
    got = bh.batch_hard_mining(f, lab)
    want = bh.batch_hard_plain(f, lab)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)
    solo = torch.tensor([labels.count(x) == 1 for x in labels], device=card)
    assert bool((got[0][solo] == 1e-6).all())
    assert torch.equal(got[2][solo].long(), torch.nonzero(solo).flatten())


@pytest.mark.cuda
@pytest.mark.parametrize("margin", [0.3, None])
def test_batch_hard_loss_on_the_card_matches_triplet_loss(card, margin):
    """batch_hard_triplet_loss's value and gradient (the kernel forward, the
    torch VJP) against autograd through losses/triplet.py, fp32."""
    from mpreid_tpu_torch.losses.triplet import triplet_loss
    from mpreid_tpu_torch.ops import batch_hard as bh

    f, labels = _hard_case(card, 64, 768, torch.float32, seed=11)
    x = (f * 0.1).requires_grad_(True)
    y = (f * 0.1).requires_grad_(True)
    loss, _, _ = bh.batch_hard_triplet_loss(x, labels, margin=margin)
    loss.backward()
    want, _, _ = triplet_loss(y, labels.long(), margin=margin)
    want.backward()
    torch.cuda.synchronize()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    assert (x.grad - y.grad).norm().item() <= 1e-4 * y.grad.norm().item()


@pytest.mark.cuda
def test_batch_hard_wrapper_refuses_what_the_kernel_does_not_take(card):
    from mpreid_tpu_torch.ops import batch_hard as bh

    f, labels = _hard_case(card, 16, 32, torch.float32)
    with pytest.raises(TypeError):
        bh.fused_batch_hard(f.half(), labels)
    with pytest.raises(ValueError, match="contiguous rows"):
        bh.fused_batch_hard(f.t().contiguous().t(), labels)


# ---------------------------------------------------------------------------
# the Uni-Prompt path on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["1a", "1b"])
def test_tiny_stage1_step_on_the_card_matches_the_cpu(card, stage):
    """fp32 tiny stage-1 step (SupCon through the frozen text tower to the
    contexts): loss and the contexts' gradients on the card (both attention
    kernels under the causal mask, 2 launches each) against the CPU's plain
    path, to 1e-5 relative and 1e-4 norm-relative."""
    from mpreid_tpu_torch.config import get_default_cfg
    from mpreid_tpu_torch.engine import stage1_loss_and_grads
    from mpreid_tpu_torch.models import make_model_uniprompt
    from mpreid_tpu_torch.solver import make_optimizer

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.MODEL.DEBUG_TINY = True
    cfg.MODEL.DEVICE = "cpu"
    cfg.INPUT.SIZE_TRAIN = [64, 32]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    rng = np.random.default_rng(13)
    feats = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, 8, 8))
    views = torch.from_numpy(rng.integers(0, 15, 8))
    results = []
    for device in ("cpu", card):
        model = make_model_uniprompt(cfg, 8, 14, 15, device=device)
        opt = make_optimizer(cfg.SOLVER[f"STAGE{stage.upper()}"], model, stage=f"stage{stage}")
        fwd, bwd = tattn.fused_attention.launches, tattn.fused_attention_bwd.launches
        loss, grads = stage1_loss_and_grads(model, opt, stage, feats.to(device),
                                            target.to(device),
                                            views.to(device) if stage == "1b" else None)
        torch.cuda.synchronize()
        launched = (tattn.fused_attention.launches - fwd, tattn.fused_attention_bwd.launches - bwd)
        assert launched == ((0, 0) if device == "cpu" else (2, 2))
        results.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    (cpu_loss, cpu_g), (card_loss, card_g) = results
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    assert set(card_g) == set(cpu_g) and cpu_g
    for name, g in card_g.items():
        assert (g - cpu_g[name]).norm().item() <= 1e-4 * cpu_g[name].norm().item(), name


def _tiny_uniprompt_cfg(dtype="float32"):
    from mpreid_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.MODEL.DEBUG_TINY = True
    cfg.MODEL.DEVICE = "cpu"
    cfg.INPUT.SIZE_TRAIN = cfg.INPUT.SIZE_TEST = [64, 32]
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TEST.TTPT.STEPS = 3
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_ttpt_tuner_on_the_card(card, dtype):
    """The TTPT tuner (3 steps over 8 classes) on the card: the text
    tower's attention forward 2 × 4 and backward 2 × 3 times, on the dtype's
    route; in fp32 the entropy trace to 1e-5 norm-relative, the tuned
    features to 1e-4 and the chosen classes equal to the CPU's plain path;
    the model's weights untouched."""
    from mpreid_tpu_torch.engine.ttpt import make_ttpt_tuner
    from mpreid_tpu_torch.models import make_model_uniprompt

    cfg = _tiny_uniprompt_cfg(dtype)
    rng = np.random.default_rng(17)
    agg = rng.standard_normal((6, 32)).astype(np.float32)
    agg = torch.from_numpy(agg / np.linalg.norm(agg, axis=1, keepdims=True))
    results = []
    for device in ("cpu", card):
        model = make_model_uniprompt(cfg, 8, 14, 15, device=device)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        fwd, bwd = tattn.fused_attention.launches, tattn.fused_attention_bwd.launches
        routed = dict(tattn.fused_attention_bwd.launches_by_route)
        feats, trace, sim = make_ttpt_tuner(model, cfg)(agg.to(device))
        torch.cuda.synchronize()
        launched = (tattn.fused_attention.launches - fwd, tattn.fused_attention_bwd.launches - bwd)
        assert launched == ((0, 0) if device == "cpu" else (8, 6))
        if device != "cpu":
            route = ROUTE[getattr(torch, dtype)]
            assert tattn.fused_attention_bwd.launches_by_route[route] - routed[route] == 6
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
        results.append([t.float().cpu() for t in (feats, trace, sim)])
    (f_cpu, t_cpu, s_cpu), (f_card, t_card, s_card) = results
    assert torch.isfinite(f_card).all() and torch.isfinite(t_card).all()
    if dtype == "float32":
        assert (t_card - t_cpu).norm().item() <= 1e-5 * t_cpu.norm().item()
        assert (f_card - f_cpu).abs().max().item() <= 1e-4
        assert torch.equal(s_card.argmax(1), s_cpu.argmax(1))


def _tuner_update_mismatches(device) -> list:
    """Run the fp32 tuner's eager body (3 steps over 8 classes) on
    ``device``, recording each context that reaches ``get_text`` and each
    gradient; recompute every AdamW update from the recorded gradients in
    fp32 numpy, with the JAX tuner's bias corrections (fp32 1 − b^t) and true
    division, from the recorded context before it. The square root alone is
    the device's own ``torch.sqrt`` of the host's v̂ (torch's CPU one is not
    correctly rounded everywhere). → for each step, the count of elements of
    the recomputed context that differ from the recorded one."""
    from mpreid_tpu_torch.engine import ttpt
    from mpreid_tpu_torch.models import make_model_uniprompt

    cfg = _tiny_uniprompt_cfg("float32")
    steps, lr = cfg.TEST.TTPT.STEPS, cfg.TEST.TTPT.LR
    model = make_model_uniprompt(cfg, 8, 14, 15, device=device)
    agg = np.random.default_rng(19).standard_normal((6, 32)).astype(np.float32)
    agg /= np.linalg.norm(agg, axis=1, keepdims=True)
    ctxs, grads = [], []
    get_text = model.get_text

    def recording(*args, ctx_generic=None, **kwargs):
        ctxs.append(ctx_generic.detach().cpu().numpy())
        if ctx_generic.requires_grad:
            ctx_generic.register_hook(lambda g: grads.append(g.detach().cpu().numpy()))
        return get_text(*args, ctx_generic=ctx_generic, **kwargs)

    model.get_text = recording
    ttpt._make_tuner_body(lambda: model, cfg)(torch.from_numpy(agg).to(device))
    assert len(ctxs) == steps + 1 and len(grads) == steps
    f = np.float32
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 1e-2
    t = np.arange(1, steps + 1, dtype=f)
    bc1, bc2 = f(1) - np.power(f(b1), t), f(1) - np.power(f(b2), t)
    m = v = np.zeros_like(ctxs[0])
    wrong = []
    for i, g in enumerate(grads):
        m = f(b1) * m + f(1 - b1) * g
        v = f(b2) * v + f(1 - b2) * np.square(g)
        mh, vh = m / bc1[i], v / bc2[i]
        root = torch.sqrt(torch.from_numpy(vh).to(device)).cpu().numpy()
        want = ctxs[i] - f(lr) * (mh / (root + f(eps)) + f(wd) * ctxs[i])
        wrong.append(int(np.sum(want != ctxs[i + 1])))
    return wrong


@pytest.mark.cuda
def test_tuner_update_is_the_fp32_host_update_on_the_card(card):
    """Every context the tuner makes on the card equals, bit for bit, the
    AdamW update recomputed on the host in fp32 from the card's gradients,
    as the JAX tuner forms it (``_tuner_update_mismatches``): the card
    divides m and v by the fp32 bias corrections. (A division by a Python
    number, which torch's CUDA kernel turns into a product with the
    reciprocal, is an ulp off in some elements.) The graphed tuner equals
    this eager body bit for bit
    (``test_graphed_tta_and_ttpt_steps_equal_their_eager_bodies``)."""
    assert _tuner_update_mismatches(card) == [0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["arcface", "cosface", "amsoftmax", "circle"])
def test_tiny_margin_head_step_on_the_card_matches_the_cpu(card, kind):
    """fp32 tiny baseline step with MODEL.COS_LAYER: the loss to 1e-5
    relative and every gradient to 1e-4 norm-relative (floored at 1e-3 of
    the largest leaf's) against the CPU's plain path."""
    from mpreid_tpu_torch.engine import loss_and_grads
    from mpreid_tpu_torch.losses import make_loss
    from mpreid_tpu_torch.models import make_model
    from mpreid_tpu_torch.solver import make_optimizer

    cfg = _tiny_uniprompt_cfg()
    cfg.MODEL.COS_LAYER, cfg.MODEL.COS_LAYER_TYPE = True, kind
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.standard_normal((8, 64, 32, 3)).astype(np.float32))
    target = torch.arange(8) // 4
    results = []
    for device in ("cpu", card):
        model = make_model(cfg, 8, 6, 1, device=device)
        loss_fn, _ = make_loss(cfg, 8)
        opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
        loss, _, grads, _ = loss_and_grads(model, cfg, loss_fn, opt, x.to(device),
                                           target.to(device))
        results.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    (cpu_loss, cpu_g), (card_loss, card_g) = results
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    floor = 1e-3 * max(g.norm().item() for g in cpu_g.values())
    for name, g in card_g.items():
        assert (g - cpu_g[name]).norm().item() <= 1e-4 * max(cpu_g[name].norm().item(), floor), name


# ---------------------------------------------------------------------------
# the data axis on the card (mpreid_tpu_torch.parallel): two ranks sharing
# the one card over gloo (NCCL refuses two ranks on one device), and NCCL at
# a world of 1
# ---------------------------------------------------------------------------

def _tiny_dp_cfg(device: str, dtype: str = "float32", **solver):
    from mpreid_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.MODEL.NAME, cfg.MODEL.DEBUG_TINY, cfg.MODEL.DEVICE = "ViT-B-16", True, device
    cfg.INPUT.SIZE_TRAIN = [64, 32]
    cfg.TPU.COMPUTE_DTYPE = dtype
    for key, value in solver.items():
        cfg.SOLVER[key] = value
    return cfg


def _dp_batch(device, n=16):
    rng = np.random.default_rng(4)
    return {"images": torch.from_numpy(rng.integers(0, 256, (n, 64, 32, 3), dtype=np.uint8))
            .to(device), "pids": torch.arange(n, device=device) // 4}


def _card_dp_job(n_steps: int, **solver):
    """Two ranks on cuda:0: the data-parallel gradients and ``n_steps``
    steps, replicated and ZeRO'd → rank's results on the CPU."""
    from mpreid_tpu_torch.engine import initial_state, loss_and_grads, make_train_step
    from mpreid_tpu_torch.losses import make_loss
    from mpreid_tpu_torch.models import make_model
    from mpreid_tpu_torch.ops import adam
    from mpreid_tpu_torch.parallel import make_mesh, shard_batch, zero_sharded
    from mpreid_tpu_torch.solver import make_optimizer

    torch.cuda.set_device(0)
    card, mesh = torch.device("cuda", 0), make_mesh()
    cfg = _tiny_dp_cfg("cuda", **solver)
    cfg.INPUT.PROB = cfg.INPUT.RE_PROB = 0.0
    model = make_model(cfg, 8, 2, 1, device=card)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    batch = shard_batch(_dp_batch(card), mesh)
    loss_fn, _ = make_loss(cfg, 8)
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    from mpreid_tpu_torch.ops.augment import eval_preprocess

    x = eval_preprocess(batch["images"], mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD)
    loss, _, grads, _ = loss_and_grads(model, cfg, loss_fn, opt, x, batch["pids"], mesh=mesh)
    out = {"loss": float(loss), "grads": {k: g.cpu() for k, g in grads.items()}}
    for zero in (False, True):
        model.load_state_dict(w0)
        o = make_optimizer(cfg.SOLVER, model, stage="baseline")
        o = zero_sharded(o, mesh, model) if zero else o
        state = initial_state(model, o)
        step = make_train_step(model, cfg, loss_fn, o, mesh=mesh)
        before = adam.fused_adam_leaf.launches
        for _ in range(n_steps):
            state, _ = step(state, batch, 1e-3, torch.Generator(device=card).manual_seed(0))
        torch.cuda.synchronize()
        out[zero] = {"params": {k: p.detach().cpu() for k, p in model.named_parameters()},
                     "adam": adam.fused_adam_leaf.launches - before}
    return out


@pytest.mark.cuda
def test_two_ranks_on_the_card_equal_one_process_and_zero_is_bitwise(card):
    from mpreid_tpu_torch.engine import loss_and_grads
    from mpreid_tpu_torch.losses import make_loss
    from mpreid_tpu_torch.models import make_model
    from mpreid_tpu_torch.ops.augment import eval_preprocess
    from mpreid_tpu_torch.parallel.launch import spawn
    from mpreid_tpu_torch.solver import make_optimizer

    ranks = spawn(_card_dp_job, 2, (2,), timeout=300)
    cfg = _tiny_dp_cfg("cuda")
    model = make_model(cfg, 8, 2, 1, device=card)
    batch = _dp_batch(card)
    x = eval_preprocess(batch["images"], mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD)
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    loss, _, grads, _ = loss_and_grads(model, cfg, make_loss(cfg, 8)[0], opt, x, batch["pids"])
    floor = 1e-3 * max(g.norm().item() for g in grads.values())
    for out in ranks:
        assert abs(out["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for k, g in grads.items():
            assert (out["grads"][k] - g.cpu()).norm().item() <= 1e-5 * max(g.norm().item(), floor)
        for k, p in out[False]["params"].items():
            assert torch.equal(out[True]["params"][k], p), k


def _card_zero_kernel_job():
    """Two fused-Adam updates of three card leaves (MIN_FUSED_SIZE, one
    less, 5 elements), replicated and ZeRO'd → (parameters, kernel launches)
    of each."""
    from mpreid_tpu_torch.ops import adam
    from mpreid_tpu_torch.parallel import make_mesh, zero_sharded
    from mpreid_tpu_torch.solver import optim

    torch.cuda.set_device(0)
    out = {}
    for zero in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(3)
        module = torch.nn.Module()
        for name, n in (("big", adam.MIN_FUSED_SIZE), ("odd", adam.MIN_FUSED_SIZE - 1),
                        ("small", 5)):
            module.register_parameter(name, torch.nn.Parameter(
                torch.randn(n, device="cuda", generator=gen)))
        cfg = _tiny_dp_cfg("cuda", FUSED_ADAM=True)
        opt = optim.Optimizer("Adam", module, cfg.SOLVER, stage="baseline")
        opt = zero_sharded(opt, make_mesh(), module) if zero else opt
        state = opt.init(module)
        train, _ = opt.partition(module)
        before = (adam.fused_adam_leaf.launches, adam.adam_leaves.launches,
                  adam.adam_leaves.leaves)
        for _ in range(2):
            grads = {k: torch.randn(p.shape, device="cuda", generator=gen)
                     for k, p in train.items()}
            state = opt.update(grads, state, train, 1e-3)
        torch.cuda.synchronize()
        after = (adam.fused_adam_leaf.launches, adam.adam_leaves.launches,
                 adam.adam_leaves.leaves)
        # the table's entries a step: "odd" and "small", or this rank's
        # slices of them that hold any elements
        table = sum(k not in getattr(opt, "zero_keys", ())
                    or opt.span(p.numel())[1] > opt.span(p.numel())[0]
                    for k, p in train.items() if k != "big")
        out[zero] = ({k: p.detach().cpu() for k, p in module.named_parameters()},
                     [a - b for a, b in zip(after, before)], 2 * table)
    return out


@pytest.mark.cuda
def test_zero_slices_take_the_kernel_the_whole_leaf_takes(card):
    """ZeRO on the card with the fused Adam kernel: each rank's half of a
    MIN_FUSED_SIZE leaf launches the kernel, the leaf one element smaller
    and the 5-element one (or this rank's slices of them) go into one table
    launch a step, and the parameters equal the replicated update's bit for
    bit."""
    from mpreid_tpu_torch.parallel.launch import spawn

    for out in spawn(_card_zero_kernel_job, 2, timeout=180):
        (p_rep, n_rep, leaves_rep), (p_zero, n_zero, leaves_zero) = out[False], out[True]
        assert n_rep == [2, 2, leaves_rep] and leaves_rep == 4
        assert n_zero == [2, 2, leaves_zero] and leaves_zero >= 2
        for k, p in p_rep.items():
            assert torch.equal(p_zero[k], p), k


def _card_gather_job():
    from mpreid_tpu_torch.parallel import collectives as C

    r = torch.distributed.get_rank()
    x = torch.arange(6, device="cuda", dtype=torch.float32).reshape(3, 2) + 10 * r
    return {"gathered": C.all_gather(x).cpu(), "bf16": C.all_gather(x.bfloat16()).cpu(),
            "through_all_reduce": C.gathers_through_all_reduce(x)}


@pytest.mark.cuda
def test_gather_of_card_tensors_under_gloo(card):
    from mpreid_tpu_torch.parallel.launch import spawn

    want = torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * r for r in range(2)])
    for out in spawn(_card_gather_job, 2, timeout=120):
        assert out["through_all_reduce"]
        assert torch.equal(out["gathered"], want) and torch.equal(out["bf16"], want.bfloat16())


def _nccl_job():
    t = torch.full((4,), 2.0, device="cuda")
    torch.distributed.all_reduce(t)
    return torch.distributed.get_backend(), t.cpu()


@pytest.mark.cuda
def test_nccl_at_a_world_of_one(card):
    from mpreid_tpu_torch.parallel.launch import spawn

    backend, t = spawn(_nccl_job, 1, backend="nccl", timeout=120)[0]
    assert backend == "nccl" and torch.equal(t, torch.full((4,), 2.0))


# the model axis, GPipe, the sharded sparse re-ranking and the dry run, with
# ranks sharing the card over gloo

def _tiny_tp_model(card, seed=0):
    import dataclasses

    from mpreid_tpu_torch.models import VIT_B16, ReIDModel

    clip = dataclasses.replace(VIT_B16, embed_dim=32, vision_layers=2, vision_width=128,
                               h_resolution=4, w_resolution=2)
    model = ReIDModel(clip, 7, camera_num=2, view_num=1)
    model.init_(torch.Generator().manual_seed(seed))
    return model.to(card)


def _card_tp_step(mesh):
    """Loss and whole gradients of a tiny fp32 ViT's step (two heads of 64,
    7 classes), sliced over ``mesh``'s model axis when given."""
    from mpreid_tpu_torch.engine import loss_and_grads
    from mpreid_tpu_torch.losses import make_loss
    from mpreid_tpu_torch.ops import attention as attn
    from mpreid_tpu_torch.ops.augment import eval_preprocess
    from mpreid_tpu_torch.parallel import gather_whole, shard_module
    from mpreid_tpu_torch.solver import make_optimizer

    card = torch.device("cuda", 0)
    cfg = _tiny_dp_cfg("cuda")
    model = _tiny_tp_model(card)
    if mesh is not None:
        shard_module(model, mesh, tp_towers=True)
    batch = _dp_batch(card)
    x = eval_preprocess(batch["images"], mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD)
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    before = attn.fused_attention.launches
    loss, _, grads, _ = loss_and_grads(model, cfg, make_loss(cfg, 7)[0], opt, x,
                                       batch["pids"] % 7, mesh=mesh)
    return {"loss": float(loss), "launches": attn.fused_attention.launches - before,
            "grads": {k: g.cpu() for k, g in gather_whole(grads, model).items()}}


def _card_tp_job():
    from mpreid_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    return _card_tp_step(make_mesh(data=1, model=2))


@pytest.mark.cuda
def test_model_axis_on_the_card_equals_one_process(card):
    """Two ranks on a 1 × 2 mesh (TP towers, 4 + 3 classes) launch the
    attention kernel over their one local head and give one process's loss
    and gradients."""
    from mpreid_tpu_torch.parallel.launch import spawn

    want = _card_tp_step(None)
    floor = 1e-2 * max(g.norm().item() for g in want["grads"].values())
    for out in spawn(_card_tp_job, 2, timeout=300):
        assert out["launches"] == 2
        assert abs(out["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for k, g in want["grads"].items():
            assert (out["grads"][k] - g).norm().item() <= 1e-5 * max(g.norm().item(), floor), k


def _card_pipe_blocks(card):
    from mpreid_tpu_torch.models.layers import ResidualAttentionBlock

    gen = torch.Generator().manual_seed(1)
    blocks = torch.nn.ModuleList(ResidualAttentionBlock(128, 2) for _ in range(4))
    for b in blocks:
        b.init_(gen)
    x = torch.randn(8, 77, 128, generator=gen)
    return blocks.to(card), x.to(card), torch.randn(8, 77, 128, generator=gen).to(card)


def _card_pipe_job():
    from mpreid_tpu_torch.models.text import causal_mask
    from mpreid_tpu_torch.parallel.pipeline import pipe_mesh, pipelined_blocks

    torch.cuda.set_device(0)
    card = torch.device("cuda", 0)
    blocks, x, w = _card_pipe_blocks(card)
    x.requires_grad_(True)
    params = {f"resblocks.{i}.{k}": p for i, b in enumerate(blocks)
              for k, p in b.named_parameters()}
    y = pipelined_blocks(blocks[0], params, 4, x, pipe_mesh(2), microbatches=4,
                         mask=causal_mask(77, card))
    (y * w).sum().backward()
    return y.detach().cpu(), x.grad.cpu()


@pytest.mark.cuda
def test_gpipe_on_the_card_equals_sequential(card):
    from mpreid_tpu_torch.models.text import causal_mask
    from mpreid_tpu_torch.parallel.launch import spawn

    blocks, x, w = _card_pipe_blocks(card)
    x.requires_grad_(True)
    h = x
    for b in blocks:
        h = b(h, causal_mask(77, card))
    (h * w).sum().backward()
    for y, dx in spawn(_card_pipe_job, 2, timeout=300):
        assert (y - h.detach().cpu()).norm() <= 1e-5 * h.norm().item()
        assert (dx - x.grad.cpu()).norm() <= 1e-5 * x.grad.norm().item()


def _card_rerank_feats(card):
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((40, 64)).astype(np.float32)
    feats = centers[rng.integers(0, 40, 700)] + 0.6 * rng.standard_normal((700, 64))
    feats = torch.from_numpy(feats.astype(np.float32)).to(card)
    return feats[:200], feats[200:]


def _card_sparse_job():
    from mpreid_tpu_torch.ops import pairwise
    from mpreid_tpu_torch.ops.reranking_sparse import re_ranking_sparse_sharded
    from mpreid_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    qf, gf = _card_rerank_feats(torch.device("cuda", 0))
    before = pairwise.minsum_cross.launches
    out = re_ranking_sparse_sharded(qf, gf, make_mesh(data=2), k1=20, k2=6, g_chunk=128)
    return out.cpu(), pairwise.minsum_cross.launches - before


@pytest.mark.cuda
def test_sharded_sparse_re_ranking_on_the_card(card):
    from mpreid_tpu_torch.ops.reranking_sparse import re_ranking_sparse
    from mpreid_tpu_torch.parallel.launch import spawn

    qf, gf = _card_rerank_feats(card)
    want = re_ranking_sparse(qf, gf, k1=20, k2=6, g_chunk=128).cpu()
    for got, launches in spawn(_card_sparse_job, 2, timeout=300):
        assert launches == 2  # the rank's 250 gallery rows in chunks of 128
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card(card):
    from mpreid_tpu_torch.parallel.dryrun import dryrun_multichip

    ranks = dryrun_multichip(4, device="cuda", timeout=600)
    assert len(ranks[0]["lines"]) == 3
    for out in ranks:
        assert out["launches"]["l1_cross"] > 0 and out["launches"]["minsum_cross"] > 0
        assert out["launches"]["attention_fwd"]["tf32x3"] > 0


# ---------------------------------------------------------------------------
# the compiled epochs (engine/compiled.py): one captured CUDA graph replayed
# a step, against the eager step loop bit for bit; the Adam kernel's scalars
# read from device memory
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_adam_kernel_reads_its_scalars_from_memory(card):
    """The kernel captured once in a CUDA graph, its scalars tensor then
    rewritten: each replay takes the values the tensor holds (bit-equal to an
    eager launch with them) and agrees with the plain version."""
    from mpreid_tpu_torch.ops import adam

    p, m, v, grad = _adam_leaf(card, 262144 + 13, torch.float32)
    scalars = torch.tensor([1e-3, 0.1, 0.001], device=card)
    args = (0.9, 0.999, 1e-8, 1e-4, True)
    graph_p, graph_m, graph_v = p.clone(), m.clone(), v.clone()
    adam.fused_adam_leaf(graph_p, graph_m, graph_v, grad, scalars, *args)  # warm-up
    graph_p.copy_(p), graph_m.copy_(m), graph_v.copy_(v)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        adam.fused_adam_leaf(graph_p, graph_m, graph_v, grad, scalars, *args)
    for t, lr in ((1, 5e-4), (2, 2e-5), (3, 3e-3)):
        step = torch.tensor([lr, 1 - 0.9 ** t, 1 - 0.999 ** t], device=card)
        eager = [x.clone() for x in (graph_p, graph_m, graph_v)]
        plain = [x.clone() for x in (graph_p, graph_m, graph_v)]
        scalars.copy_(step)
        graph.replay()
        adam.fused_adam_leaf(*eager, grad, step, *args)
        adam.adam_leaf_plain(*plain, grad, step, *args)
        torch.cuda.synchronize()
        for got, want in zip((graph_p, graph_m, graph_v), eager):
            assert torch.equal(got, want)
        for got, want, atol in zip((graph_p, graph_m, graph_v), plain, (1e-3 * lr, 0.0, 0.0)):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=atol)


def _graph_cfg(moe_dropout=None, remat=False, fused=False):
    from mpreid_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.MODEL.DEBUG_TINY = True
    cfg.MODEL.DEVICE = "cuda"
    cfg.INPUT.SIZE_TRAIN = cfg.INPUT.SIZE_TEST = [64, 32]
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.REMAT = remat
    cfg.DATALOADER.SAMPLER = "softmax_triplet"
    cfg.SOLVER.FUSED_ADAM = fused
    cfg.SOLVER.STAGE2.FUSED_ADAM = fused
    if moe_dropout is not None:
        cfg.MODEL.MOE.ENABLED = True
        cfg.MODEL.MOE.NUM_EXPERTS, cfg.MODEL.MOE.TOP_K, cfg.MODEL.MOE.MOE_LAYERS = 4, 2, 2
        cfg.MODEL.MOE.DROPOUT = moe_dropout
    return cfg


def _graph_rows(seed, n=6, ids=8, per_id=6):
    """PK rows (2 ids × 4 images) into ``ids × per_id`` images."""
    rng = np.random.default_rng(seed)
    return np.stack([np.concatenate([i * per_id + rng.permutation(per_id)[:4]
                                     for i in rng.choice(ids, 2, replace=False)])
                     for _ in range(n)])


def _assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                assert torch.equal(x[k], y[k]), k
        else:
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["baseline", "baseline_fused_adam", "moe_dropout_remat"])
def test_graphed_train_epoch_equals_the_step_loop(card, case, monkeypatch):
    """Two epochs of 6 PK batches at different lr, augmentation on, bf16:
    the graphed ``make_train_epoch`` (2 warm-up steps, 1 capture, 10
    replays) against ``make_train_step`` over the same rows from one state
    and generator state: every loss and accuracy, parameter, buffer, moment,
    the step and the generator bit for bit; the kernel launches counted for
    every replay."""
    import copy

    from mpreid_tpu_torch.engine import initial_state, make_train_epoch, make_train_step
    from mpreid_tpu_torch.losses import make_loss
    from mpreid_tpu_torch.models import make_model, make_model_uniprompt, switch_to_moe
    from mpreid_tpu_torch.engine import precompute_text_features
    from mpreid_tpu_torch.ops import adam
    from mpreid_tpu_torch.solver import make_optimizer
    from mpreid_tpu_torch.solver import optim as toptim

    if case == "baseline_fused_adam":
        monkeypatch.setattr(toptim, "MIN_FUSED_SIZE", 4096)  # the tiny model's larger leaves
    cfg = _graph_cfg(0.1 if case == "moe_dropout_remat" else None,
                     remat=case == "moe_dropout_remat", fused=case == "baseline_fused_adam")
    if case == "moe_dropout_remat":
        dense = cfg.clone()
        dense.MODEL.MOE.ENABLED = False
        model = switch_to_moe(cfg, make_model_uniprompt(dense, 8, 6, 15))
        kwargs = dict(uniprompt=True, text_features=precompute_text_features(cfg, model, 8))
        opt_cfg, stage = cfg.SOLVER.STAGE2, "stage2b"
    else:
        model = make_model(cfg, 8, camera_num=6, view_num=1)
        kwargs, opt_cfg, stage = {}, cfg.SOLVER, "baseline"
    loss_fn, _ = make_loss(cfg, 8)
    rng = np.random.default_rng(5)
    data = [torch.from_numpy(a).to(card) for a in (
        rng.integers(0, 256, (48, 64, 32, 3), dtype=np.uint8),
        np.repeat(np.arange(8), 6).astype(np.int32), rng.integers(0, 6, 48).astype(np.int32),
        rng.integers(0, 15, 48).astype(np.int32))]
    runs = []
    for mode in ("graph", "loop"):
        m = copy.deepcopy(model)
        opt = make_optimizer(opt_cfg, m, stage=stage)
        state = initial_state(m, opt)
        gen = torch.Generator(device=card).manual_seed(11)
        epoch = make_train_epoch(m, cfg, loss_fn, opt, **kwargs)
        step = make_train_step(m, cfg, loss_fn, opt, **kwargs)
        fwd, adam0 = tattn.fused_attention.launches, adam.fused_adam_leaf.launches
        table0 = adam.adam_leaves.launches, adam.adam_leaves.leaves
        out = []
        for e, lr in enumerate((1e-3, 2e-4)):
            rows = _graph_rows(e)
            if mode == "graph":
                state, (losses, accs) = epoch(state, *data, rows, lr, gen)
                out += [losses, accs]
                continue
            for row in rows:
                idx = torch.as_tensor(row, device=card)
                batch = dict(zip(("images", "pids", "camids", "trackids"),
                                 (t.index_select(0, idx) for t in data)))
                state, metrics = step(state, batch, lr, gen)
                out += [metrics["loss"][None], metrics["acc"][None]]
        torch.cuda.synchronize()
        if mode == "graph":
            assert epoch.compiled.stats["captures"] == 1
            assert epoch.compiled.stats["replays"] == 10
            assert epoch.compiled.stats["pool_bytes"] > 0
            out = [torch.cat(out[0::2]), torch.cat(out[1::2])]
        else:
            out = [torch.cat(out[0::2]), torch.cat(out[1::2])]
        launched = (tattn.fused_attention.launches - fwd, adam.fused_adam_leaf.launches - adam0,
                    adam.adam_leaves.launches - table0[0], adam.adam_leaves.leaves - table0[1])
        runs.append((out, launched, m.state_dict(), state.opt_state.mu, state.opt_state.nu,
                     state.opt_state.step, gen.get_state()))
        epoch.release()
    (g_out, g_n, *g_rest), (l_out, l_n, *l_rest) = runs
    _assert_same(g_out, l_out)
    _assert_same(g_rest, l_rest)
    assert g_n == l_n and g_n[0] > 0 and (g_n[1] > 0) == (case == "baseline_fused_adam")
    # one table launch an update, every replay counted: 12 updates, each
    # with every trained leaf off the per-leaf kernel
    table = sum(not opt.kernel_route(p) for p in opt.partition(m)[0].values())
    assert g_n[2] == 12 and g_n[3] == 12 * table > 0
    assert int(runs[0][5]) == 12


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["1a", "1b"])
def test_graphed_stage1_epoch_equals_the_step_loop(card, stage):
    """Two epochs of 5 batches of 8 bank rows at different lr: the graphed
    ``make_stage1_epoch`` against ``make_stage1_step`` over the same rows
    from one set of contexts, losses, contexts and moments bit for bit; a
    parameter given new storage makes the next call capture again."""
    import copy

    from mpreid_tpu_torch.engine import initial_state, make_stage1_epoch, make_stage1_step
    from mpreid_tpu_torch.models import make_model_uniprompt
    from mpreid_tpu_torch.solver import make_optimizer

    cfg = _graph_cfg()
    model = make_model_uniprompt(cfg, 8, 14, 15)
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((40, 32)).astype(np.float32)).to(card)
    feats = feats.to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, 8, 40)).to(card)
    views = torch.from_numpy(rng.integers(0, 15, 40)).to(card)
    stage_cfg = cfg.SOLVER[f"STAGE{stage.upper()}"]
    runs = []
    for mode in ("graph", "loop"):
        m = copy.deepcopy(model)
        opt = make_optimizer(stage_cfg, m, stage=f"stage{stage}")
        state = initial_state(m, opt)
        epoch = make_stage1_epoch(m, cfg, opt, stage)
        step = make_stage1_step(m, cfg, opt, stage)
        losses = []
        for e, lr in enumerate((1e-3, 2e-4)):
            rows = np.random.default_rng(e).permutation(40).reshape(5, 8)
            if mode == "graph":
                state, out = epoch(state, feats, labels, views, rows, lr)
                losses.append(out)
                continue
            for row in rows:
                sel = torch.as_tensor(row, device=card)
                state, metrics = step(state, feats[sel], labels[sel],
                                      views[sel] if stage == "1b" else None, lr)
                losses.append(metrics["loss"][None])
        torch.cuda.synchronize()
        runs.append(copy.deepcopy((torch.cat(losses), m.state_dict(), state.opt_state.mu,
                                   state.opt_state.nu, state.opt_state.step)))
        if mode == "graph":
            assert epoch.compiled.stats["captures"] == 1
            assert epoch.compiled.stats["replays"] == 8
            ctx = next(p for k, p in m.named_parameters() if k.startswith("prompt_learner.ctx"))
            ctx.data = ctx.data.clone()  # new storage: the old graph would write freed memory
            epoch(state, feats, labels, views, rows, lr)
            assert epoch.compiled.stats["captures"] == 2
            epoch.release()
    _assert_same(runs[0], runs[1])
    assert int(runs[0][4]) == 10


@pytest.mark.cuda
def test_a_generator_snapshot_cannot_serve_a_captured_recompute(card):
    """Why ``models/vit.py::RematDraws`` places clones before each replay: a
    generator's state cannot be cloned inside a CUDA graph capture (so no
    graph-safe snapshot can be taken at a block's forward), and a clone
    registered before the capture but not placed before a replay draws
    other bits than the forward it should repeat."""
    n = 1000
    side = torch.cuda.Stream()

    def warmed_up(seed):
        gen = torch.Generator(device=card).manual_seed(seed)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            start = gen.get_offset()
            torch.rand(100, generator=gen, device=card)
            before_forward = gen.get_offset() - start
            torch.rand(n, generator=gen, device=card)
        torch.cuda.current_stream().wait_stream(side)
        return gen, before_forward

    gen, _ = warmed_up(3)
    refused = torch.cuda.CUDAGraph()
    refused.register_generator_state(gen)
    with pytest.raises(RuntimeError, match="during CUDA graph capture"):
        with torch.cuda.graph(refused, stream=side, capture_error_mode="thread_local"):
            torch.rand(100, generator=gen, device=card)
            gen.clone_state()
    torch.cuda.synchronize()

    gen, before_forward = warmed_up(5)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    clone = gen.clone_state()
    graph.register_generator_state(clone)
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        torch.rand(100, generator=gen, device=card)
        forward = torch.rand(n, generator=gen, device=card)
        recompute = torch.rand(n, generator=clone, device=card)
    for _ in range(2):
        graph.replay()
        assert not torch.equal(forward, recompute)
    # placed where the step generator stands at the forward, it repeats it
    clone.manual_seed(gen.initial_seed())
    clone.set_offset(gen.get_offset() + before_forward)
    graph.replay()
    assert torch.equal(forward, recompute)


# ---------------------------------------------------------------------------
# the compiled steps: each graphed step against its eager body, bit for bit
# ---------------------------------------------------------------------------

def _eval_batches(n, seed=0, hw=(64, 32), batch=8):
    rng = np.random.default_rng(seed)
    return [{"images": rng.integers(0, 256, (batch, *hw, 3), dtype=np.uint8),
             "pids": np.arange(batch, dtype=np.int32),
             "camids": rng.integers(0, 6, batch).astype(np.int32),
             "trackids": np.zeros(batch, np.int32)} for _ in range(n)]


@pytest.mark.cuda
def test_graphed_eval_step_equals_its_eager_body(card):
    """Five batches through ``make_eval_step`` (two warm-up calls, the third
    captures, two replays) against ``_make_eval_body`` on the same batches:
    every batch's features bit for bit, each a copy of the graph's static
    output; 2 attention launches a replayed batch, counted."""
    from mpreid_tpu_torch.engine import make_eval_step
    from mpreid_tpu_torch.engine.steps import _make_eval_body
    from mpreid_tpu_torch.models import make_model

    cfg = _graph_cfg()
    model = make_model(cfg, 8, camera_num=6, view_num=1).eval()
    depth = len(model.image_encoder.transformer.resblocks)
    step = make_eval_step(model, cfg)
    body = _make_eval_body(lambda: model, cfg)
    batches = _eval_batches(5)
    before = tattn.fused_attention.launches
    got = [step(b) for b in batches]
    torch.cuda.synchronize()
    assert tattn.fused_attention.launches - before == 5 * depth
    want = [body(torch.from_numpy(b["images"]).to(card), None, None)[0] for b in batches]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert g.data_ptr() != step.compiled.static[0].data_ptr()
    assert step.compiled.stats["captures"] == 1 and step.compiled.stats["replays"] == 3
    assert step.compiled.stats["pool_bytes"] > 0
    step.release()


@pytest.mark.cuda
def test_graphed_bank_and_text_steps_equal_their_eager_bodies(card):
    """``make_image_bank_step`` over four batches and ``make_text_step`` over
    four full batches and a short tail (eager, the graph kept), each against
    its eager body bit for bit."""
    from mpreid_tpu_torch.engine import make_image_bank_step, make_text_step
    from mpreid_tpu_torch.engine.steps import _make_bank_body, _make_text_body
    from mpreid_tpu_torch.models import make_model_uniprompt

    cfg = _graph_cfg()
    model = make_model_uniprompt(cfg, 8, 14, 15)
    bank, bank_body = make_image_bank_step(model, cfg), _make_bank_body(model, cfg)
    for b in _eval_batches(4, seed=1):
        got = bank(b)
        assert not got.is_inference()
        assert torch.equal(got, bank_body(torch.from_numpy(b["images"]).to(card))[0])
    assert bank.compiled.stats["captures"] == 1 and bank.compiled.stats["replays"] == 2
    text, text_body = make_text_step(model, "2"), _make_text_body(model, "2")
    for lo, hi in ((0, 3), (3, 6), (0, 3), (5, 8), (6, 8)):
        labels = torch.arange(lo, hi, device=card)
        held = text.compiled.key
        assert torch.equal(text(labels), text_body(labels, None)[0])
        if hi - lo == 2:
            assert text.compiled.key == held
    assert text.compiled.stats == dict(text.compiled.stats, captures=1, replays=2, eager_steps=3)
    bank.release()
    text.release()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["baseline", "baseline_fused_adam", "moe_dropout_remat"])
def test_graphed_train_step_equals_its_eager_body(card, case, monkeypatch):
    """Six steps over host (numpy) PK batches at two lr, augmentation on,
    bf16: ``make_train_step`` (two warm-up steps, the third captures, three
    replays) against ``_make_step_body`` called eagerly on the same batches
    from one state and generator state: every loss and accuracy, parameter,
    buffer, moment, the step and the generator bit for bit; the kernel
    launches counted for every replay."""
    import copy

    from mpreid_tpu_torch.engine import initial_state, make_train_step
    from mpreid_tpu_torch.engine import precompute_text_features
    from mpreid_tpu_torch.engine.steps import _make_step_body
    from mpreid_tpu_torch.losses import make_loss
    from mpreid_tpu_torch.models import make_model, make_model_uniprompt, switch_to_moe
    from mpreid_tpu_torch.ops import adam
    from mpreid_tpu_torch.solver import make_optimizer
    from mpreid_tpu_torch.solver import optim as toptim

    if case == "baseline_fused_adam":
        monkeypatch.setattr(toptim, "MIN_FUSED_SIZE", 4096)  # the tiny model's larger leaves
    cfg = _graph_cfg(0.1 if case == "moe_dropout_remat" else None,
                     remat=case == "moe_dropout_remat", fused=case == "baseline_fused_adam")
    if case == "moe_dropout_remat":
        dense = cfg.clone()
        dense.MODEL.MOE.ENABLED = False
        model = switch_to_moe(cfg, make_model_uniprompt(dense, 8, 6, 15))
        kwargs = dict(uniprompt=True, text_features=precompute_text_features(cfg, model, 8))
        opt_cfg, stage = cfg.SOLVER.STAGE2, "stage2b"
    else:
        model = make_model(cfg, 8, camera_num=6, view_num=1)
        kwargs, opt_cfg, stage = {}, cfg.SOLVER, "baseline"
    loss_fn, _ = make_loss(cfg, 8)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (48, 64, 32, 3), dtype=np.uint8)
    pids = np.repeat(np.arange(8), 6).astype(np.int32)
    batches = [{"images": images[row], "pids": pids[row],
                "camids": np.zeros(8, np.int32), "trackids": np.zeros(8, np.int32)}
               for row in _graph_rows(3)]
    runs = []
    for mode in ("graph", "eager"):
        m = copy.deepcopy(model)
        opt = make_optimizer(opt_cfg, m, stage=stage)
        state = initial_state(m, opt)
        gen = torch.Generator(device=card).manual_seed(11)
        step = make_train_step(m, cfg, loss_fn, opt, **kwargs)
        body = _make_step_body(m, cfg, loss_fn, opt, None, None, kwargs.get("uniprompt", False),
                               kwargs.get("text_features"))
        fwd, adam0 = tattn.fused_attention.launches, adam.fused_adam_leaf.launches
        out = []
        for i, batch in enumerate(batches):
            lr = 1e-3 if i < 3 else 2e-4
            if mode == "graph":
                state, metrics = step(state, batch, lr, gen)
            else:
                opt.set_lr(state.opt_state, lr)
                state, metrics = body(state, torch.from_numpy(batch["images"]).to(card),
                                      torch.from_numpy(batch["pids"]).to(card), None, None, gen)
            out += [metrics["loss"][None], metrics["acc"][None]]
        torch.cuda.synchronize()
        if mode == "graph":
            assert step.compiled.stats["captures"] == 1 and step.compiled.stats["replays"] == 4
        launched = (tattn.fused_attention.launches - fwd, adam.fused_adam_leaf.launches - adam0)
        runs.append(([torch.cat(out[0::2]), torch.cat(out[1::2])], launched, m.state_dict(),
                     state.opt_state.mu, state.opt_state.nu, state.opt_state.step,
                     gen.get_state()))
        step.release()
    (g_out, g_n, *g_rest), (e_out, e_n, *e_rest) = runs
    _assert_same(g_out, e_out)
    _assert_same(g_rest, e_rest)
    assert g_n == e_n and g_n[0] > 0 and (g_n[1] > 0) == (case == "baseline_fused_adam")
    assert int(runs[0][5]) == 6


@pytest.mark.cuda
def test_graphed_stage1_trailing_step_equals_its_eager_body(card):
    """The trailing partial batch of ``do_train_stage1`` (5 bank rows) over
    four epochs through ``make_stage1_step``: eager in the first two, captured
    in the third, replayed in the fourth, against ``_make_stage1_body``
    bit for bit: losses, contexts and moments."""
    import copy

    from mpreid_tpu_torch.engine import initial_state, make_stage1_step
    from mpreid_tpu_torch.engine.steps import _make_stage1_body
    from mpreid_tpu_torch.models import make_model_uniprompt
    from mpreid_tpu_torch.solver import make_optimizer

    cfg = _graph_cfg()
    model = make_model_uniprompt(cfg, 8, 14, 15)
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((45, 32)).astype(np.float32)).to(card)
    feats = feats.to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, 8, 45)).to(card)
    views = torch.from_numpy(rng.integers(0, 15, 45)).to(card)
    runs = []
    for mode in ("graph", "eager"):
        m = copy.deepcopy(model)
        opt = make_optimizer(cfg.SOLVER.STAGE1B, m, stage="stage1b")
        state = initial_state(m, opt)
        step, body = make_stage1_step(m, cfg, opt, "1b"), _make_stage1_body(opt, "1b")
        losses = []
        for epoch in range(4):
            sel = torch.as_tensor(np.random.default_rng(epoch).permutation(45)[40:], device=card)
            lr = 1e-3 / (1 + epoch)
            if mode == "graph":
                state, metrics = step(state, feats[sel], labels[sel], views[sel], lr)
                losses.append(metrics["loss"][None])
            else:
                opt.set_lr(state.opt_state, lr)
                losses.append(body(state, feats[sel], labels[sel], views[sel])[None])
        torch.cuda.synchronize()
        if mode == "graph":
            assert step.compiled.stats["captures"] == 1 and step.compiled.stats["replays"] == 2
        runs.append(copy.deepcopy((torch.cat(losses), m.state_dict(), state.opt_state.mu,
                                   state.opt_state.nu, state.opt_state.step)))
        step.release()
    _assert_same(runs[0], runs[1])


@pytest.mark.cuda
def test_a_failed_capture_raises(card):
    """A body that reads a device value on the host cannot be captured: the
    third call raises and nothing carries on eagerly."""
    from mpreid_tpu_torch.engine.compiled import CompiledStep

    def body(x):
        return (x * float(x.sum()),)

    step = CompiledStep(card)
    x = np.ones(4, np.float32)
    for _ in range(2):
        assert step(body, (x,))[0].tolist() == [4.0] * 4
    with pytest.raises(RuntimeError):
        step(body, (x,))
    assert step.graph is None
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the TTA / TTPT steps (engine/ttpt.py): each graphed step against its eager
# body, bit for bit
# ---------------------------------------------------------------------------

def _ttpt_graph_model(dtype):
    from mpreid_tpu_torch.models import make_model_uniprompt

    cfg = _graph_cfg()
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TEST.TTA_ENABLED = True
    cfg.TEST.TTPT.STEPS = 3
    return cfg, make_model_uniprompt(cfg, 8, 14, 15).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_tta_and_ttpt_steps_equal_their_eager_bodies(card, dtype):
    """The four steps of engine/ttpt.py, each over five calls with one key
    (two warm-up calls, the third captures, two replays), against its eager
    body on the same inputs, bit for bit: (a) the TTA query step at
    boundaries 0, 3, 8, 5 and 8 on one graph, (b) the plain step with the
    norm fused, (c) the TTPT query input (ordinary tensors), (d) the tuner
    (3 steps over 8 classes) on (c)'s outputs: features, entropy trace and
    sim; the tuner's launches counted for every replay; the model
    untouched."""
    from mpreid_tpu_torch.engine import (
        make_eval_step, make_tta_query_step, make_ttpt_query_step, make_ttpt_tuner,
    )
    from mpreid_tpu_torch.engine import ttpt
    from mpreid_tpu_torch.engine.steps import _make_eval_body

    cfg, model = _ttpt_graph_model(dtype)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tdepth = len(model.text_encoder.transformer.resblocks)
    batches = _eval_batches(5, seed=7)

    def images(batch):
        return torch.from_numpy(batch["images"]).to(card)

    def same(step, body_of, calls, eager_inputs):
        body = body_of(lambda: model, cfg)
        outs = []
        for call in calls:
            got = step(*call)
            want = body(*eager_inputs(*call))
            got = got if isinstance(got, tuple) else (got,)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            outs.append(got)
        stats = step.compiled.stats
        assert stats["captures"] == 1 and stats["replays"] == 3 and stats["pool_bytes"] > 0
        return outs

    same(make_tta_query_step(model, cfg), ttpt._make_tta_query_body,
         list(zip(batches, (0, 3, 8, 5, 8))),
         lambda b, k: (images(b), None, None, torch.tensor(k, device=card)))
    same(make_eval_step(model, cfg, feat_norm=True),
         lambda m, c: _make_eval_body(m, c, feat_norm=True), [(b,) for b in batches],
         lambda b: (images(b), None, None))
    aggs = [a for (a,) in same(make_ttpt_query_step(model, cfg), ttpt._make_ttpt_query_body,
                               [(b,) for b in batches], lambda b: (images(b), None, None))]
    assert not any(a.is_inference() for a in aggs)
    fwd, bwd = tattn.fused_attention.launches, tattn.fused_attention_bwd.launches
    tuner = make_ttpt_tuner(model, cfg)
    outs = same(tuner, ttpt._make_tuner_body, [(a,) for a in aggs], lambda a: (a,))
    torch.cuda.synchronize()
    assert tattn.fused_attention.launches - fwd == 2 * 5 * 4 * tdepth  # graphed and eager
    assert tattn.fused_attention_bwd.launches - bwd == 2 * 5 * 3 * tdepth
    assert all(o[1].shape == (3,) and torch.isfinite(o[1]).all() for o in outs)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    tuner.release()


@pytest.mark.cuda
def test_a_failed_tuner_capture_raises(card):
    """A tuner whose text forward reads a device value on the host cannot be
    captured: its third call raises, no graph is kept, nothing carries on
    eagerly, and the parameters' requires_grad flags are restored."""
    from mpreid_tpu_torch.engine import make_ttpt_tuner

    cfg, model = _ttpt_graph_model("bfloat16")
    flags = {n: p.requires_grad for n, p in model.named_parameters()}
    real = model.get_text

    def syncing(*args, **kwargs):
        out = real(*args, **kwargs)
        float(out.detach().sum())  # a host read, which a capture refuses
        return out

    model.get_text = syncing
    tuner = make_ttpt_tuner(model, cfg)
    agg = torch.nn.functional.normalize(torch.randn(6, 32, device=card), dim=1)
    for _ in range(2):
        assert tuner(agg)[1].shape == (3,)
    with pytest.raises(RuntimeError):
        tuner(agg)
    assert tuner.compiled.graph is None
    assert {n: p.requires_grad for n, p in model.named_parameters()} == flags
    torch.cuda.synchronize()
