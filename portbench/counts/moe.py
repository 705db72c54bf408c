"""Operations of a stage-2b step of the Uni-Prompt MoE ViT per image, by
``models.py``'s rule (two per multiply-add; what the mathematics of the step
requires), counting the experts each token is routed to (``top_k`` of the
``experts``), not the experts a dispatch happens to run: the count stays
the same whatever dispatch computes the step.

A step is the forward, the gradients of the activations everywhere but
patchify's (the images need none) and the gradients of stage 2b's trained
weights: patchify, every block's attention projections and LayerNorms, the
dense blocks' MLPs, the gates and ``proj``; not the experts, the
classifiers or the text features. With shared routing only the first MoE
block runs its gate."""

from __future__ import annotations

from .attention import Shape, bwd_flops, fwd_flops


def stage2b_per_image(hw=(256, 128), patch=16, width=768, layers=12, embed=512, classes=751,
                      text_classes=751, experts=4, top_k=2, moe_layers=2,
                      shared_routing=True) -> float:
    """Operations per image: the forward, the activations' gradients and the
    trained weights' gradients."""
    n_patch = (hw[0] // patch) * (hw[1] // patch)
    tokens = n_patch + 1
    attn = Shape(1, tokens, width // 64)
    projections = 2.0 * tokens * width * 4 * width  # q|k|v and the output projection
    mlp = 2.0 * tokens * width * 8 * width  # c_fc and c_proj of one MLP
    gating = 1 if shared_routing else moe_layers
    gates = gating * 2.0 * tokens * width * experts
    patchify = 2.0 * n_patch * 3 * patch * patch * width
    head = 2.0 * tokens * width * embed  # proj, of every token as models.py counts it
    heads = 2.0 * (width + embed) * classes + 2.0 * embed * text_classes
    dense_mlps = (layers - moe_layers) * mlp
    routed = moe_layers * top_k * mlp
    forward = (patchify + layers * (projections + fwd_flops(attn)) + dense_mlps + routed + gates
               + head + heads)
    grad_x = layers * (projections + bwd_flops(attn)) + dense_mlps + routed + gates + head + heads
    grad_w = patchify + layers * projections + dense_mlps + gates + head
    return forward + grad_x + grad_w
