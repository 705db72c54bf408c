"""The towers and heads of the reference, as CLIP (arXiv:2103.00020,
``clip/model.py``) and CLIP-ReID (arXiv:2211.13977) define them.

``W`` maps state-dict names to fp32 tensors. Attention has heads of 64
(CLIP's rule for every tower and for the RN50 attention pool). The
products go through ``prec``, and so do the activations a tower hands on
(each block's output, its features: ``prec.store``); the rest is fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import tokens
from .precision import Precision

HEAD_DIM = 64
LN_EPS = 1e-5
BN_EPS = 1e-5


def layer_norm(x, W, name):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], LN_EPS)


def attention(x, W, name, prec: Precision, mask: Optional[torch.Tensor] = None):
    """Multi-head self-attention with CLIP's packed [q|k|v] in-projection."""
    b, n, d = x.shape
    h = d // HEAD_DIM
    qkv = prec.linear(x, W[name + ".in_proj_weight"], W[name + ".in_proj_bias"])
    q, k, v = (t.reshape(b, n, h, HEAD_DIM).transpose(1, 2) for t in qkv.split(d, dim=-1))
    logits = prec.mm(q, k.transpose(-1, -2)) * HEAD_DIM ** -0.5
    if mask is not None:
        logits = logits + mask
    out = prec.mm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, n, d)
    return prec.linear(out, W[name + ".out_proj.weight"], W[name + ".out_proj.bias"])


def block(x, W, name, prec: Precision, mask=None):
    """CLIP's residual attention block (pre-LN, QuickGELU MLP of 4 × width)."""
    x = x + attention(layer_norm(x, W, name + ".ln_1"), W, name + ".attn", prec, mask)
    h = prec.linear(layer_norm(x, W, name + ".ln_2"), W[name + ".mlp.c_fc.weight"],
                    W[name + ".mlp.c_fc.bias"])
    h = h * torch.sigmoid(1.702 * h)
    return x + prec.linear(h, W[name + ".mlp.c_proj.weight"], W[name + ".mlp.c_proj.bias"])


def n_blocks(W, prefix: str) -> int:
    marker = prefix + ".transformer.resblocks."
    return len({k[len(marker):].split(".")[0] for k in W if k.startswith(marker)})


def vision(x_nhwc, W, prec: Precision, p: str = "image_encoder"):
    """ViT: normalised (B, H, W, 3) images → (feat_last, feat, feat_proj): the
    class token after all blocks but the last, after all blocks and
    ``ln_post``, and that times ``proj``."""
    conv = W[p + ".conv1.weight"]
    patch = conv.shape[-1]
    x = prec.conv2d(x_nhwc.permute(0, 3, 1, 2), conv, stride=patch)  # (B, width, gh, gw)
    x = x.flatten(2).transpose(1, 2)
    cls = W[p + ".class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + W[p + ".positional_embedding"]
    x = layer_norm(x, W, p + ".ln_pre")
    depth = n_blocks(W, p)
    for i in range(depth - 1):
        x = prec.store(block(x, W, f"{p}.transformer.resblocks.{i}", prec))[0]
    last = x[:, 0]
    x = block(x, W, f"{p}.transformer.resblocks.{depth - 1}", prec)
    x = layer_norm(x[:, 0], W, p + ".ln_post")
    return prec.store(last, x, prec.mm(x, W[p + ".proj"]))


def text(prompts, W, prec: Precision, p: str = "text_encoder"):
    """CLIP's text transformer over prompt embeddings (B, 77, width): causal
    mask, ``ln_final``, the end-of-text token, ``text_projection``."""
    n = prompts.shape[1]
    mask = torch.full((n, n), float("-inf"), device=prompts.device).triu(1)
    x = prompts + W[p + ".positional_embedding"]
    for i in range(n_blocks(W, p)):
        x = prec.store(block(x, W, f"{p}.transformer.resblocks.{i}", prec, mask))[0]
    x = layer_norm(x[:, tokens.EOT_POSITION], W, p + ".ln_final")
    return prec.store(prec.mm(x, W[p + ".text_projection"]))[0]


def prompts(W, labels, stage: str):
    """The Uni-Prompt prompt embeddings of ``labels``: the template's start
    token, the identity's 8 generic context vectors, 4 modality and 4
    platform ones (zeros in stage 1a; without view labels, the mean over the
    modalities and over the platforms), the template's remaining tokens."""
    emb = W["text_encoder.token_embedding.weight"]
    ids = torch.tensor(tokens.template(), device=emb.device)
    table = emb[ids]
    b = labels.shape[0]
    generic = W["prompt_learner.ctx_generic"][labels]
    if stage == "1a":
        modal = generic.new_zeros((b, tokens.N_MODAL, generic.shape[-1]))
        plat = generic.new_zeros((b, tokens.N_PLAT, generic.shape[-1]))
    else:
        modal = W["prompt_learner.ctx_modality"].mean(0, keepdim=True).expand(b, -1, -1)
        plat = W["prompt_learner.ctx_platform"].mean(0, keepdim=True).expand(b, -1, -1)
    head = table[:1].expand(b, -1, -1)
    tail = table[1 + tokens.N_CTX:].expand(b, -1, -1)
    return torch.cat([head, generic, modal, plat, tail], dim=1)


def batch_norm(x, W, name, dims):
    """Batch statistics (train mode): the mean and the biased variance."""
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    shape = [1] * x.dim()
    shape[1] = -1
    return ((x - mean) / torch.sqrt(var + BN_EPS) * W[name + ".weight"].view(shape)
            + W[name + ".bias"].view(shape))


def _bn2d(x, W, name):
    return batch_norm(x, W, name, (0, 2, 3))


def _bottleneck(x, W, name, stride, prec):
    out = F.relu(_bn2d(prec.conv2d(x, W[name + ".conv1.weight"]), W, name + ".bn1"))
    out = F.relu(_bn2d(prec.conv2d(out, W[name + ".conv2.weight"], padding=1), W, name + ".bn2"))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = _bn2d(prec.conv2d(out, W[name + ".conv3.weight"]), W, name + ".bn3")
    if name + ".downsample.0.weight" in W:
        if stride > 1:
            x = F.avg_pool2d(x, stride)
        x = _bn2d(prec.conv2d(x, W[name + ".downsample.0.weight"]), W, name + ".downsample.1")
    return F.relu(out + x)


def resnet(x_nhwc, W, prec: Precision, p: str = "image_encoder"):
    """CLIP's ModifiedResNet in train mode (batch statistics), layer4 at
    stride 1 as CLIP-ReID sets it → (feat_last, feat, feat_proj): the spatial
    means of layer3 and layer4 and the attention pool's mean token."""
    x = x_nhwc.permute(0, 3, 1, 2)
    x = F.relu(_bn2d(prec.conv2d(x, W[p + ".conv1.weight"], stride=2, padding=1), W, p + ".bn1"))
    x = F.relu(_bn2d(prec.conv2d(x, W[p + ".conv2.weight"], padding=1), W, p + ".bn2"))
    x = F.relu(_bn2d(prec.conv2d(x, W[p + ".conv3.weight"], padding=1), W, p + ".bn3"))
    x = prec.store(F.avg_pool2d(x, 2))[0]
    maps = []
    for i, stride in zip(range(1, 5), (1, 2, 2, 1)):
        j = 0
        while f"{p}.layer{i}.{j}.conv1.weight" in W:
            x = prec.store(_bottleneck(x, W, f"{p}.layer{i}.{j}", stride if j == 0 else 1,
                                       prec))[0]
            j += 1
        maps.append(x)
    return prec.store(maps[2].mean(dim=(2, 3)), maps[3].mean(dim=(2, 3)),
                      attention_pool(maps[3], W, prec))


def attention_pool(x, W, prec: Precision, p: str = "image_encoder.attnpool"):
    """CLIP's attention pool: the mean token prepended, positions added, every
    token attending to every token; the mean token's output."""
    b, c = x.shape[:2]
    t = x.flatten(2).transpose(1, 2)
    t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1) + W[p + ".positional_embedding"]
    h = c // HEAD_DIM

    def proj(name):
        y = prec.linear(t, W[f"{p}.{name}.weight"], W[f"{p}.{name}.bias"])
        return y.reshape(b, -1, h, HEAD_DIM).transpose(1, 2)

    q, k, v = proj("q_proj"), proj("k_proj"), proj("v_proj")
    probs = torch.softmax(prec.mm(q, k.transpose(-1, -2)) * HEAD_DIM ** -0.5, dim=-1)
    out = prec.mm(probs, v).transpose(1, 2).reshape(b, -1, c)
    return prec.linear(out[:, 0], W[p + ".c_proj.weight"], W[p + ".c_proj.bias"])


def tower(x_nhwc, W, prec: Precision):
    """The image tower the weights hold: the ViT, or the RN50."""
    if "image_encoder.conv1.weight" in W and "image_encoder.class_embedding" in W:
        return vision(x_nhwc, W, prec)
    return resnet(x_nhwc, W, prec)


def reid_heads(feat, feat_proj, W, prec: Precision) -> Dict[str, torch.Tensor]:
    """CLIP-ReID's two BNNecks (train mode) and bias-free classifiers."""
    f = batch_norm(feat, W, "bottleneck", (0,))
    fp = batch_norm(feat_proj, W, "bottleneck_proj", (0,))
    return {"score": prec.linear(f, W["classifier.weight"]),
            "score_proj": prec.linear(fp, W["classifier_proj.weight"])}
