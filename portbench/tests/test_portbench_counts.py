"""The counts against PERF.md's bound times and hand arithmetic."""

import pytest

from portbench.counts import attention as A
from portbench.counts import models as M


@pytest.mark.parametrize("shape, fwd_ms, bwd_ms", [
    (A.Shape(64, 129, 12), 0.0151, 0.0265),           # vision, L 129, 12 x 64
    (A.Shape(64, 77, 8, causal=True), 0.0060, 0.0105),  # text, L 77, 8 x 64, causal
])
def test_attention_bounds(shape, fwd_ms, bwd_ms):
    assert round(A.fwd_least_seconds(shape) * 1e3, 4) == fwd_ms
    assert round(A.bwd_least_seconds(shape) * 1e3, 4) == bwd_ms


def test_vit_b16_per_image():
    tokens, d = 129, 768
    block = 2 * tokens * d * (3 * d) + 2 * tokens * d * d + 2 * 2 * tokens * d * 4 * d
    attn = 2 * 2 * 12 * tokens * tokens * 64
    patch = 2 * 128 * 768 * 768
    proj = 2 * tokens * 768 * 512
    forward = patch + 12 * (block + attn) + proj
    assert M.vit_eval_per_image() == forward
    heads = 2 * (768 + 512) * 751 + 2 * 512 * 751
    dense = 12 * block + proj + heads
    train = patch + dense + 12 * attn + patch + 2 * dense + 2 * 12 * attn
    assert M.vit_train_per_image(text_classes=751) == train
    assert 68.0e9 < train < 68.5e9


def test_text_stage1_per_row():
    tokens, d = 77, 512
    block = 2 * tokens * d * 12 * d
    attn = 2 * 2 * 8 * (77 * 78 // 2) * 64
    assert M.text_stage1_per_row() == 12 * block + 12 * attn + 12 * block + 12 * 2 * attn \
        + 3 * 2 * 512 * 512


def test_rn50_per_image():
    def conv(cin, cout, k, h, w):
        return 2 * cin * cout * k * k * h * w
    stem = conv(32, 32, 3, 128, 64) + conv(32, 64, 3, 128, 64)
    # layer1 at 64 x 32
    l1 = sum(conv(cin, 64, 1, 64, 32) + conv(64, 64, 3, 64, 32) + conv(64, 256, 1, 64, 32)
             for cin in (64, 256, 256)) + conv(64, 256, 1, 64, 32)
    # layer2: the first block's 3x3 at 64 x 32, then 32 x 16
    l2 = conv(256, 128, 1, 64, 32) + conv(128, 128, 3, 64, 32) + conv(128, 512, 1, 32, 16) \
        + conv(256, 512, 1, 32, 16) + 3 * (conv(512, 128, 1, 32, 16) + conv(128, 128, 3, 32, 16)
                                           + conv(128, 512, 1, 32, 16))
    l3 = conv(512, 256, 1, 32, 16) + conv(256, 256, 3, 32, 16) + conv(256, 1024, 1, 16, 8) \
        + conv(512, 1024, 1, 16, 8) + 5 * (conv(1024, 256, 1, 16, 8) + conv(256, 256, 3, 16, 8)
                                           + conv(256, 1024, 1, 16, 8))
    l4 = conv(1024, 512, 1, 16, 8) + conv(512, 512, 3, 16, 8) + conv(512, 2048, 1, 16, 8) \
        + conv(1024, 2048, 1, 16, 8) + 2 * (conv(2048, 512, 1, 16, 8) + conv(512, 512, 3, 16, 8)
                                            + conv(512, 2048, 1, 16, 8))
    f = M.rn50_forward()
    assert f["stem0"] == conv(3, 32, 3, 128, 64)
    assert f["convs"] == stem + l1 + l2 + l3 + l4
    assert f["pool"] == 3 * 2 * 129 * 2048 * 2048 + 2 * 2 * 129 * 129 * 2048 + 2 * 2048 * 1024
