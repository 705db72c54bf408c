"""Operations a model needs per item, two per multiply-add, from its
shapes. The rule for every count: what the mathematics of the step
requires, nothing recomputed counted. A training step is the forward, the
gradients of the activations and the gradients of the trained weights: the
backward of a product is two products, one where its input needs no
gradient (the images) or its weight is frozen (stage 1's text tower), none
where neither does. Normalisations, activations and losses are left out
(a fraction of a percent)."""

from __future__ import annotations

from .attention import Shape, bwd_flops, fwd_flops


def transformer_block(tokens: int, width: int) -> float:
    """The products of one CLIP block per sequence, attention's excluded:
    q|k|v, the output projection, the MLP (4 × width)."""
    return 2.0 * tokens * width * (3 * width + width + 8 * width)


def vit_forward(hw=(256, 128), patch=16, width=768, layers=12, embed=512, classes=751,
                text_classes: int = 0) -> dict:
    """ViT-B/16 and the ReID heads, per image: ``patch`` the patchify
    product, ``blocks`` the blocks' products, ``attention`` (and
    ``attention_bwd``) the attention products, ``proj`` the projection of
    every token, ``heads`` the two classifiers and, with ``text_classes``,
    the image-to-text logits."""
    n_patch = (hw[0] // patch) * (hw[1] // patch)
    tokens = n_patch + 1
    attn = Shape(1, tokens, width // 64)
    return {
        "patch": 2.0 * n_patch * 3 * patch * patch * width,
        "blocks": layers * transformer_block(tokens, width),
        "attention": layers * fwd_flops(attn),
        "attention_bwd": layers * bwd_flops(attn),
        "proj": 2.0 * tokens * width * embed,
        "heads": 2.0 * (width + embed) * classes + 2.0 * embed * text_classes,
    }


def vit_train_per_image(**kw) -> float:
    """Forward, then dX and dW of every product but patchify's dX (the
    images need none)."""
    f = vit_forward(**kw)
    dense = f["blocks"] + f["proj"] + f["heads"]
    return (f["patch"] + dense + f["attention"]) + (f["patch"] + 2 * dense + f["attention_bwd"])


def vit_eval_per_image(**kw) -> float:
    """The tower's forward to the features (no classifier)."""
    f = vit_forward(**kw)
    return f["patch"] + f["blocks"] + f["attention"] + f["proj"]


def text_stage1_per_row(length=77, width=512, layers=12, embed=512) -> float:
    """Stage 1 per bank row: the text tower's forward (causal), the
    activations' gradients only (the tower is frozen), the projection of
    the end-of-text token, and the two similarity products against the
    batch."""
    attn = Shape(1, length, width // 64, causal=True)
    blocks = layers * transformer_block(length, width)
    return (blocks + layers * fwd_flops(attn)) + (blocks + layers * bwd_flops(attn)) \
        + 3 * 2.0 * width * embed


def _conv(cin, cout, k, h, w) -> float:
    return 2.0 * cin * cout * k * k * h * w


def rn50_forward(hw=(256, 128), layers=(3, 4, 6, 3), width=64, embed=1024, classes=751) -> dict:
    """CLIP's ModifiedResNet at ``hw`` with layer4 at stride 1, per image:
    ``stem0`` the first conv (its input is the image), ``convs`` every other
    conv, ``pool`` the attention pool's products, ``heads`` the classifiers."""
    h, w = hw[0] // 2, hw[1] // 2
    stem0 = _conv(3, width // 2, 3, h, w)
    convs = _conv(width // 2, width // 2, 3, h, w) + _conv(width // 2, width, 3, h, w)
    h, w = h // 2, w // 2
    inplanes = width
    for i, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, 1))):
        planes = width * 2 ** i
        for j in range(blocks):
            s = stride if j == 0 else 1
            convs += _conv(inplanes, planes, 1, h, w) + _conv(planes, planes, 3, h, w)
            ho, wo = h // s, w // s
            convs += _conv(planes, planes * 4, 1, ho, wo)
            if j == 0:
                convs += _conv(inplanes, planes * 4, 1, ho, wo)
            inplanes, h, w = planes * 4, ho, wo
    tokens = h * w + 1
    c = inplanes
    pool = 3 * 2.0 * tokens * c * c + 4.0 * tokens * tokens * c + 2.0 * c * embed
    return {"stem0": stem0, "convs": convs, "pool": pool,
            "heads": 2.0 * (c + embed) * classes}


def rn50_train_per_image(**kw) -> float:
    f = rn50_forward(**kw)
    rest = f["convs"] + f["pool"] + f["heads"]
    return f["stem0"] + rest + 2 * rest + f["stem0"]
