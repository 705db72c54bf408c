"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a card. The file
imports nothing of JAX, so on the card's machine it runs without the
repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

fp32 is held to 1e-5 and bf16 to 2e-2, as in chip_smoke.py. bf16 attention
runs on the tensor-core kernels (route "tc"), fp32 on the CUDA-core ones
(route "simt").
"""

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.ops import attention as tattn

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ROUTE = {torch.float32: "simt", torch.bfloat16: "tc"}
# the longest L each attention kernel takes: what one block's shared memory
# (232,448 bytes) holds
MAX_LEN = {("fwd", torch.bfloat16, 64): 800, ("fwd", torch.bfloat16, 128): 416,
           ("fwd", torch.float32, 64): 417, ("fwd", torch.float32, 128): 214,
           ("bwd", torch.bfloat16, 64): 384, ("bwd", torch.bfloat16, 128): 208,
           ("bwd", torch.float32, 64): 417, ("bwd", torch.float32, 128): 214}
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
    longest = MAX_LEN["fwd", dtype, dh]
    if length > longest:
        with pytest.raises(ValueError, match=f"L above {longest} needs more shared memory"):
            tattn.fused_attention(qkv, 2, mask, layout=layout)
        return
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
    178; the tensor-core backward's shared memory grows as O(L)."""
    qkv = _qkv(card, 3, length, 2, dh, dtype, seed=3)
    do = _qkv(card, 3, length, 2, dh, dtype, seed=4)[..., :2 * dh].contiguous()
    mask = _causal(card, length) if masked else None
    longest = MAX_LEN["bwd", dtype, dh]
    if length > longest:
        with pytest.raises(ValueError, match=f"L above {longest} needs more shared memory"):
            tattn.fused_attention_bwd(qkv, do, 2, mask, layout=layout)
        return
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
    """bf16 launches count on "tc", fp32 on "simt", forward and backward."""
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
@pytest.mark.parametrize("length", [163, 257])
def test_fp32_bwd_kernel_at_the_long_shapes(card, length, layout):
    """The CUDA-core backward at the lengths it refused while it held L x L
    in shared memory: 163 (configs/cross/sysu_rgb2ir.yml, 288x144) and 257
    (the 256x256 vehicle configs), B 64 x 12 heads x 64, held to its plain
    version at 1e-5 x max(1, max |plain|), and deterministic."""
    qkv = _qkv(card, 64, length, 12, 64, torch.float32, seed=length)
    do = _qkv(card, 64, length, 12, 64, torch.float32, seed=length + 1)[..., :768].contiguous()
    routed = tattn.fused_attention_bwd.launches_by_route["simt"]
    got = tattn.fused_attention_bwd(qkv, do, 12, layout=layout)
    again = tattn.fused_attention_bwd(qkv, do, 12, layout=layout)
    want = tattn.attention_bwd_plain(qkv, do, 12, layout=layout)
    torch.cuda.synchronize()
    assert tattn.fused_attention_bwd.launches_by_route["simt"] == routed + 2
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
    with pytest.raises(ValueError, match="L above 384 needs more shared memory"):
        tattn.fused_attention_bwd(_qkv(card, 1, 400, 1, 64, torch.bfloat16),
                                  torch.zeros(1, 400, 64, device=card, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="L above 417 needs more shared memory"):
        tattn.fused_attention_bwd(_qkv(card, 1, 418, 1, 64, torch.float32),
                                  torch.zeros(1, 418, 64, device=card), 1)


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
    args = (lr, 1 - 0.9 ** 3, 1 - 0.999 ** 3, 0.9, 0.999, 1e-8, 1e-4, decoupled)
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
    args = (1e-3, 0.1, 0.001, 0.9, 0.999, 1e-8, 0.0, False)
    with pytest.raises(TypeError):
        adam.fused_adam_leaf(p.half(), m, v, grad, *args)
    with pytest.raises(TypeError):
        adam.fused_adam_leaf(p, m.bfloat16(), v, grad, *args)
    with pytest.raises(ValueError, match="shape"):
        adam.fused_adam_leaf(p, m[:32], v, grad, *args)
    with pytest.raises(ValueError, match="aligned"):
        adam.fused_adam_leaf(p[1:], m[1:], v[1:], grad[1:], *args)


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
@pytest.mark.parametrize("b,d", [(64, 768), (60, 768), (16, 32), (12, 40), (200, 129), (3, 8)])
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
