"""Stage 2b of the Uni-Prompt MoE ViT through the device-resident training
epoch: ``train_epoch.py``'s unit on ``port.build``'s MoE model (the
factory builds it from ``MODEL.MOE``) and stage 2b's optimizer
(``make_optimizer(..., stage="stage2b")``: the gates and the image encoder
but its experts), as ``train_uniprompt.py`` runs stage 2b after the switch
to the MoE tower.

The check (``numbers``) holds the port to ``reference/moe.py``: the worst-leaf
gaps of ``train_epoch.py`` taken without the gates, ``delta_diff`` over
every leaf and over the gates alone (``gate_delta_diff``), and
``route_gap``, the share of tokens whose set of experts differs between the
port and the reference at the first checked batch, at the seeded weights.
The port's routing is the one its first step took: the first row of set-up
runs eagerly, and a forward hook on the first MoE block keeps its gate
logits (a replayed row is the same step, bit for bit:
tests/test_torch_cuda.py). With the traffic's ``given_routes`` the
reference routes that batch to the port's experts, with its own weights for
them, so one flipped token does not move every gradient. The reference takes
the weights under its own names: the port's stacked experts split into
``experts.{m}.*``.

Each unit also keeps its images and the change of the port's expert-layer
counter (``models/moe.py::expert_layers.rows``, the rows the expert
products took) in ``expert_units``, for
``metrics/moe_zero_weight_rows_pct.train.py``; a port without that counter
keeps none."""

from __future__ import annotations

import math
from pathlib import Path

import torch

from portbench.counts import moe as moe_counts
from portbench.data import images, pk, weights
from portbench.harness import compare, manifest, port
from portbench.reference import moe as ref_moe
from portbench.reference import train as ref
from portbench.reference.precision import Precision

base = manifest.program("train_epoch", Path(__file__).resolve().parents[2])
CHECKED_STEPS = base.CHECKED_STEPS

# the port's stacked expert leaves and the reference's names of one expert's slice
EXPERT_LEAVES = (("c_fc_weight", "c_fc.weight"), ("c_fc_bias", "c_fc.bias"),
                 ("c_proj_weight", "c_proj.weight"), ("c_proj_bias", "c_proj.bias"))


def reference_names(W: dict) -> dict:
    """The port's ``experts.c_fc_weight`` (E, ...) stacks as the reference's
    ``experts.{m}.c_fc.weight`` slices; every other leaf as it is."""
    out = {}
    for name, t in W.items():
        head, _, leaf = name.rpartition(".")
        stacked = dict(EXPERT_LEAVES).get(leaf)
        if stacked is not None and head.endswith(".experts"):
            for m in range(t.shape[0]):
                out[f"{head}.{m}.{stacked}"] = t[m]
        else:
            out[name] = t
    return out


OWN = ("grad_gap_no_gates", "delta_gap_no_gates", "gate_delta_gap", "gate_delta_diff",
       "route_gap")


def gates(prog: dict, ref: dict, keep: bool):
    """(prog, ref) of the leaves that are gates (``keep``) or are not."""
    names = [k for k in ref if (".gate." in k) == keep]
    return {k: prog[k] for k in names if k in prog}, {k: ref[k] for k in names}


class Program(base.Program):
    def setup(self) -> None:
        from mpreid_tpu_torch.engine.steps import make_train_epoch
        from mpreid_tpu_torch.engine.train_state import initial_state
        from mpreid_tpu_torch.engine.uniprompt import precompute_text_features
        from mpreid_tpu_torch.losses import make_loss
        from mpreid_tpu_torch.models import moe
        from mpreid_tpu_torch.solver import make_optimizer

        ctx, t, cfg = self.ctx, self.ctx.traffic, self.ctx.cfg
        self.uniprompt = True
        self.counter = getattr(moe, "expert_layers", None)
        self.expert_units = []
        model, self.shapes = port.build(ctx, True)
        classes = t["classes"]
        text = precompute_text_features(cfg, model, classes)
        loss_fn, _ = make_loss(cfg, classes)
        self.opt = make_optimizer(port.node_at(cfg, t["solver"]), model, stage=t["stage"])
        self.epoch = make_train_epoch(model, cfg, loss_fn, self.opt, uniprompt=True,
                                      text_features=text)
        self.state = initial_state(model, self.opt)
        self.data = images.train_set(t["images"], classes, tuple(cfg.INPUT.SIZE_TRAIN),
                                     ctx.streams["images"], ctx.device)
        self.rows = pk.Rows(images.identity_layout(t["images"], classes), t["batch"],
                            t["instances"], ctx.streams["order"] % 2 ** 31)
        self.gen = torch.Generator(device=ctx.device).manual_seed(ctx.streams["augment"])
        self.lr = float(t["lr"])
        first = self.rows.take(CHECKED_STEPS)
        logits = []
        hook = model.image_encoder.transformer.resblocks[0].register_forward_hook(
            lambda module, args, out: logits.append(out[1].detach().clone()))
        try:
            self.state, (losses, _) = self.epoch(self.state, *self.data, first[:1], self.lr,
                                                 self.gen)
        finally:
            hook.remove()
        with self.keeper.keeping(ctx.device):
            self.kept = {"losses": losses.tolist(),
                         "grads": port.first_gradients(self.opt, self.state),
                         "routes": moe.top_k_indices(torch.softmax(logits[0].float(), -1),
                                                     cfg.MODEL.MOE.TOP_K).sort(-1).values.cpu()}
        self.state, (losses, _) = self.epoch(self.state, *self.data, first[1:], self.lr, self.gen)
        with self.keeper.keeping(ctx.device):
            idx = torch.from_numpy(first.reshape(-1)).to(ctx.device)
            self.kept.update(losses=self.kept["losses"] + losses.tolist(),
                             params=port.trained_params(self.opt, self.state),
                             images=self.data[0].index_select(0, idx),
                             pids=self.data[1].index_select(0, idx))

    def unit(self) -> int:
        if self.counter is None:
            return super().unit()
        before = self.counter.rows
        items = super().unit()
        self.expert_units.append((items, self.counter.rows - before))
        return items

    # ------------------------------------------------------------ the check
    def reference(self, kept: dict, prec: Precision, keep: float = 1.0) -> dict:
        ctx, t = self.ctx, self.ctx.traffic
        config = ctx.cell.config
        W0 = reference_names(weights.make(self.shapes, ctx.streams["weights"], ctx.device))
        text = ref.text_features(W0, t["classes"], prec)
        given = kept["routes"].to(ctx.device) if t.get("given_routes") else None
        loss = ref_moe.stage2b_loss(config["cfg"], t["classes"], text, prec, self.moe(), keep,
                                    given)
        b = t["batch"]
        batches = [(kept["images"][i * b:(i + 1) * b], kept["pids"][i * b:(i + 1) * b])
                   for i in range(CHECKED_STEPS)]
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.streams["augment"])
        out = ref_moe.follow(W0, port.node_at(config["cfg"], t["solver"]), self.lr, batches,
                             loss, gen)
        out["W0"] = W0
        return out

    def moe(self) -> dict:
        """The reference's ``moe`` settings, from the cell's config node."""
        m = self.ctx.cfg.MODEL.MOE
        return {"experts": int(m.NUM_EXPERTS), "top_k": int(m.TOP_K),
                "layers": int(m.MOE_LAYERS), "shared_routing": bool(m.SHARED_ROUTING),
                "aux_coeff": float(m.AUX_LOSS_COEFF)}

    def numbers(self, kept: dict, r: dict, every: bool = False) -> list:
        """``train_epoch.py``'s numbers and five more. A gate's gradient sums
        the tokens' small, mostly cancelling terms and reads precision as a
        loss does, so the worst-leaf gaps are taken without the gates
        (``grad_gap_no_gates``, ``delta_gap_no_gates``) and the gates' change
        on its own: the worst gate's gap of norms (``gate_delta_gap``) and
        ``delta_diff`` over the gates alone (``gate_delta_diff``), which
        sees a gate moved the wrong way; and ``route_gap``. A leaf the
        reference trains and the port does not reads as unchanged."""
        masks = compare.moved(r["loss_grads"])
        kept = dict(kept, params={**{k: r["W0"][k] for k in masks}, **kept["params"]})
        limits = {k: v for k, v in self.ctx.limits.items() if k not in OWN}
        out = port.train_numbers(kept, r, limits, every)
        delta_p = compare.change_norms(kept["params"], r["W0"], masks)
        delta_r = compare.change_norms(r["params"], r["W0"], masks)
        values = {
            "grad_gap_no_gates": compare.worst_leaf(*gates(kept["grads"], r["grad_norms"], False)),
            "delta_gap_no_gates": compare.worst_leaf(*gates(delta_p, delta_r, False)),
            "gate_delta_gap": compare.worst_leaf(*gates(delta_p, delta_r, True)),
            "gate_delta_diff": compare.difference(kept["params"], r["params"], r["W0"],
                                                  gates(masks, masks, True)[1]),
            "route_gap": ref_moe.route_gap(kept["routes"], r["routes"]),
        }
        port.free()
        for name in (OWN if every else [n for n in self.ctx.limits if n in OWN]):
            out.append(compare.number(name, values[name], self.ctx.limits.get(name, math.inf)))
        by_name = {n["name"]: n for n in out}
        order = list(self.ctx.limits) + [n for n in by_name if n not in self.ctx.limits]
        return [by_name[n] for n in order]

    @staticmethod
    def as_reading(r: dict) -> dict:
        return dict(base.Program.as_reading(r), routes=r["routes"])

    # -------------------------------------------------------- for readers
    def flops_per_item(self) -> float:
        cfg, t = self.ctx.cfg, self.ctx.traffic
        model, m = self.ctx.cell.config["model"], self.moe()
        return moe_counts.stage2b_per_image(
            hw=tuple(cfg.INPUT.SIZE_TRAIN), patch=model["vision_patch_size"],
            width=model["vision_width"], layers=model["vision_layers"],
            embed=model["embed_dim"], classes=t["classes"], text_classes=t["classes"],
            experts=m["experts"], top_k=m["top_k"], moe_layers=m["layers"],
            shared_routing=m["shared_routing"])
