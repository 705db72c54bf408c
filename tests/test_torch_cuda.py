"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a card. The file
imports nothing of JAX, so on the card's machine it runs without the
repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

fp32 is held to 1e-5 and bf16 to 2e-2, as in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.ops import attention as tattn

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


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
@pytest.mark.parametrize("length", [17, 77, 129])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dh", [64, 128])
def test_kernel_matches_plain(card, layout, dtype, length, masked, dh):
    qkv = _qkv(card, 3, length, 2, dh, dtype)
    mask = _causal(card, length) if masked else None
    before = tattn.fused_attention.launches
    got = tattn.fused_attention(qkv, 2, mask, layout=layout)
    want = tattn.attention_plain(qkv, 2, mask, layout=layout)
    torch.cuda.synchronize()
    assert tattn.fused_attention.launches == before + 1
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
