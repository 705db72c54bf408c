"""The Uni-Prompt MoE image tower and its stage 2b, as the MP-ReID
reference defines them (arXiv:2503.17096; its ``model/clip/model.py``:
the MoE block ``:163-258``, the shared routing ``:304-330``, the
load-balancing loss ``:342-377``; its ``train_uniprompt.py``: stage 2b
trains the gates and the image encoder but the experts), over CLIP ViT-B/16
(arXiv:2103.00020).

``W`` holds the reference's names. A MoE block ``i`` of the image tower has
the gate ``...resblocks.{i}.gate.weight`` (E, D), no bias, and its experts
``...resblocks.{i}.experts.{m}.c_fc.weight`` (4D, D), ``.c_fc.bias``,
``.c_proj.weight`` (D, 4D), ``.c_proj.bias``: each one CLIP's MLP. Every
other name is ``models.py``'s. ``moe`` is a configuration's ``moe`` block:
``experts``, ``top_k``, ``layers`` (the first that many blocks are MoE
blocks), ``shared_routing``, ``aux_coeff``.

The MoE block: attention as in CLIP's block; ``ln_2``; the gate's logits
(one product); the softmax in fp32; the ``top_k`` experts of each token,
ranked by probability, ties lowest index first; their probabilities
renormalised to sum 1; then, expert by expert, the expert's MLP
(QuickGELU) over the tokens routed to it, weighted, added back into the
block's output (``index_add``). With shared routing the first MoE block
routes, and every later MoE block takes its experts and weights. The
tower's ``last`` token is the last block's (the reference's MoE tower
returns its final tokens as both ``x11`` and ``x12``); ``feat`` and
``proj`` are CLIP's. The loss is stage 2's (``train.stage2_loss``) plus
``aux_coeff`` × the mean over the routing blocks of the Switch
Transformer's loss: E · Σ over the ranks r < top_k and experts e of the
share of tokens whose r-th choice is e times e's mean probability.

Departures from the reference repository:
- fp32 throughout (TF32 off), where the reference runs CLIP's mixed
  precision; the products and the tower's hand-offs go through ``prec``
  as ``models.py``'s do, so the control rounds the gate's and the experts'
  products to fp8 as it does the dense blocks';
- ties between probabilities are broken lowest index first (the
  reference's ``torch.topk`` promises no order among ties);
- no expert dropout (the configuration's is 0);
- the reference's upcycling call (``switch_to_moe_model``) is never
  defined there; the weights here are seeded, the gates non-zero;
- the aux loss is taken per routing block and averaged, where the
  reference concatenates the blocks' logits first: with shared routing
  there is one routing block, and the two agree.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from . import augment, losses, models
from .adam import Adam
from .precision import Precision


def quick_gelu(h):
    return h * torch.sigmoid(1.702 * h)


def trains(name: str) -> bool:
    """Stage 2b's trained leaves: the gates and the image encoder but its
    experts; never the BNNecks' shifts (CLIP-ReID keeps them at zero)."""
    parts = name.split(".")
    if parts[0] in ("bottleneck", "bottleneck_proj") and parts[-1] == "bias":
        return False
    return "gate" in name or (parts[0] == "image_encoder" and "experts" not in name)


def route(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, E) gate logits → (the (N, top_k) experts of each token, best
    first, ties lowest index first; their probabilities renormalised)."""
    probs = torch.softmax(logits.float(), dim=-1)
    selected = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :top_k]
    top = probs.gather(1, selected)
    return selected, top / top.sum(dim=1, keepdim=True)


def experts(flat, W, name: str, selected, weights, prec: Precision):
    """Each expert's MLP over the tokens routed to it, times the token's
    weight for it, summed into an (N, D) output."""
    out = torch.zeros_like(flat)
    m = 0
    while f"{name}.experts.{m}.c_fc.weight" in W:
        hit = selected == m                                    # (N, top_k)
        rows = hit.any(dim=1).nonzero().squeeze(1)
        if rows.numel():
            e = f"{name}.experts.{m}"
            weight = (weights * hit).sum(dim=1)[rows]
            h = prec.linear(flat[rows], W[e + ".c_fc.weight"], W[e + ".c_fc.bias"])
            y = prec.linear(quick_gelu(h), W[e + ".c_proj.weight"], W[e + ".c_proj.bias"])
            out = out.index_add(0, rows, weight[:, None] * y)
        m += 1
    return out


def block(x, W, name: str, prec: Precision, top_k: int, routing=None, given=None):
    """A MoE block → (output, its gate logits or None where ``routing`` was
    given, the routing it used: (selected, weights), its own choice of
    experts or None). ``given`` (N, top_k): experts chosen elsewhere (the
    port's), which the block routes to with its own weights for them."""
    x = x + models.attention(models.layer_norm(x, W, name + ".ln_1"), W, name + ".attn", prec)
    b, n, d = x.shape
    flat = models.layer_norm(x, W, name + ".ln_2").reshape(b * n, d)
    logits = own = None
    if routing is None:
        logits = prec.linear(flat, W[name + ".gate.weight"])
        routing = route(logits, top_k)
        own = routing[0]
        if given is not None:
            chosen = given[:b * n]
            top = torch.softmax(logits.float(), dim=-1).gather(1, chosen)
            routing = (chosen, top / top.sum(dim=1, keepdim=True))
    return x + experts(flat, W, name, *routing, prec).reshape(b, n, d), logits, routing, own


def vision(x_nhwc, W, prec: Precision, moe: dict, p: str = "image_encoder", given=None):
    """The MoE ViT: normalised (B, H, W, 3) images → (feat_last, feat,
    feat_proj, the routing blocks' gate logits, the first block's own
    choice of experts). ``given``: the first block's experts, chosen
    elsewhere (``block``)."""
    conv = W[p + ".conv1.weight"]
    patch = conv.shape[-1]
    x = prec.conv2d(x_nhwc.permute(0, 3, 1, 2), conv, stride=patch)
    x = x.flatten(2).transpose(1, 2)
    cls = W[p + ".class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + W[p + ".positional_embedding"]
    x = models.layer_norm(x, W, p + ".ln_pre")
    depth = models.n_blocks(W, p)
    first = chosen = None
    gating = []
    for i in range(depth):
        name = f"{p}.transformer.resblocks.{i}"
        if i < moe["layers"]:
            shared = first if moe["shared_routing"] else None
            x, logits, routing, own = block(x, W, name, prec, moe["top_k"], shared,
                                            given if i == 0 else None)
            if logits is not None:
                gating.append(logits)
            if first is None:
                first, chosen = routing, own
        else:
            x = models.block(x, W, name, prec)
        if i < depth - 1:
            x = prec.store(x)[0]
    last = x[:, 0]
    x = models.layer_norm(x[:, 0], W, p + ".ln_post")
    return (*prec.store(last, x, prec.mm(x, W[p + ".proj"])), gating, chosen)


def balance_loss(logits, top_k: int):
    """The Switch Transformer's load-balancing loss of one routing block."""
    probs = torch.softmax(logits.float(), dim=-1)
    n, e = probs.shape
    selected = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :top_k]
    share = torch.stack([torch.bincount(selected[:, r], minlength=e) for r in range(top_k)])
    return e * (share.float() / n * probs.mean(dim=0)).sum()


def stage2b_loss(cfg: dict, classes: int, text: torch.Tensor, prec: Precision, moe: dict,
                 keep: float = 1.0, given=None):
    """Stage 2b's loss: stage 2's (ID on the class token's BN feature, the
    triplet on the class token, image-to-text cross entropy against every
    identity's text feature) plus the aux loss. Each call's first routing
    block's own choice of experts is kept in ``loss.routes``. ``given``:
    the first call's experts of the first routing block, chosen elsewhere
    (the port's at the first checked batch), taken with the reference's own
    weights for them; the later calls route themselves."""
    m, inp = cfg["MODEL"], cfg["INPUT"]

    def loss(W, images, labels, gen):
        x = augment.augment(images, gen, inp["PIXEL_MEAN"], inp["PIXEL_STD"], inp["PROB"],
                            inp["RE_PROB"], inp["PADDING"])
        n = max(1, int(round(len(labels) * keep)))  # less than all: train.py's planted fault
        x, labels = x[:n], labels[:n]
        _, feat, proj, gating, chosen = vision(x, W, prec, moe,
                                               given=None if loss.routes else given)
        loss.routes.append(chosen.detach())
        heads = models.reid_heads(feat, proj, W, prec)
        i2t = prec.mm(proj, text.t())
        aux = torch.stack([balance_loss(g, moe["top_k"]) for g in gating]).mean()
        return (m["ID_LOSS_WEIGHT"] * losses.ce_smooth(heads["score"], labels, classes)
                + m["TRIPLET_LOSS_WEIGHT"] * losses.triplet(feat, labels, cfg["SOLVER"]["MARGIN"])
                + m["I2T_LOSS_WEIGHT"] * losses.ce_smooth(i2t, labels, classes)
                + moe["aux_coeff"] * aux)

    loss.routes = []
    return loss


def follow(W0: Dict[str, torch.Tensor], solver: dict, lr: float, batches: List[tuple],
           loss: Callable, gen=None) -> dict:
    """Stage-2b steps from ``W0`` over ``batches``, as ``train.follow``
    takes them → its dict, and ``routes``: the first step's first routing
    block's experts of each token, (N, top_k) in ascending order."""
    W = {k: v.clone() for k, v in W0.items()}
    train = {k: W[k].requires_grad_(True) for k in W if trains(k)}
    opt = Adam(train, solver)
    out = {"losses": [], "grad_norms": {}}
    for step, (inputs, labels) in enumerate(batches):
        value = loss(W, inputs, labels.long(), gen)
        grads = torch.autograd.grad(value, list(train.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(train.items(), grads)}
        if step == 0:
            out["grad_norms"] = {k: float(torch.linalg.norm(
                opt.effective_grad(k, p.detach(), grads[k]).double())) for k, p in train.items()}
            out["loss_grads"] = grads
        opt.step({k: p.detach() for k, p in train.items()}, grads, lr)
        out["losses"].append(float(value.detach()))
    out["params"] = {k: p.detach() for k, p in train.items()}
    out["routes"] = loss.routes[0].sort(dim=1).values
    return out


def route_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of tokens whose set of experts differs between two (N,
    top_k) routings in ascending order (over the tokens both hold)."""
    n = min(len(a), len(b))
    return float((a[:n].cpu() != b[:n].cpu()).any(dim=1).double().mean())

