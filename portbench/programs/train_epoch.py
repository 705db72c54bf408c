"""The device-resident training epoch: ``engine/steps.py::make_train_epoch``
over a train set on the card (``TPU.DEVICE_DATASET``), as
``engine/processor.py::train_epochs`` runs it for the baseline
(``do_train``) and for Uni-Prompt stage 2 (``engine/uniprompt.py::
do_train_stage2``, with ``precompute_text_features`` first).

Unit of work: the next ``rows_per_unit`` batch rows of the PK epochs, one
call of the epoch, its losses fetched at the end. Items: images.

Set-up builds the model, the optimizer, the epoch and the state once, and
drives them through the first steps with the window's own call and feed:
one row (eager), the moments kept; three rows (two eager, the capture and
its first replay), the trained leaves kept. The window replays only."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from portbench.counts import models as counts
from portbench.counts.attention import Shape
from portbench.data import images, pk, weights
from portbench.harness import port
from portbench.reference import train as ref
from portbench.reference.precision import Precision, fp32_only

CHECKED_STEPS = 4


class Program:
    def __init__(self, ctx):
        self.ctx = ctx
        self.keeper = port.Keeper()

    @property
    def check_seconds(self) -> float:
        return self.keeper.seconds

    def setup(self) -> None:
        from mpreid_tpu_torch.engine.steps import make_train_epoch
        from mpreid_tpu_torch.engine.train_state import initial_state
        from mpreid_tpu_torch.engine.uniprompt import precompute_text_features
        from mpreid_tpu_torch.losses import make_loss
        from mpreid_tpu_torch.solver import make_optimizer

        ctx, t, cfg = self.ctx, self.ctx.traffic, self.ctx.cfg
        self.uniprompt = bool(t["uniprompt"])
        model, self.shapes = port.build(ctx, self.uniprompt)
        classes = t["classes"]
        text = precompute_text_features(cfg, model, classes) if self.uniprompt else None
        loss_fn, _ = make_loss(cfg, classes)
        self.opt = make_optimizer(port.node_at(cfg, t["solver"]), model, stage=t["stage"])
        self.epoch = make_train_epoch(model, cfg, loss_fn, self.opt, uniprompt=self.uniprompt,
                                      text_features=text)
        self.state = initial_state(model, self.opt)
        self.data = images.train_set(t["images"], classes, tuple(cfg.INPUT.SIZE_TRAIN),
                                     ctx.streams["images"], ctx.device)
        self.rows = pk.Rows(images.identity_layout(t["images"], classes), t["batch"],
                            t["instances"], ctx.streams["order"] % 2 ** 31)
        self.gen = torch.Generator(device=ctx.device).manual_seed(ctx.streams["augment"])
        self.lr = float(t["lr"])
        first = self.rows.take(CHECKED_STEPS)
        self.state, (losses, _) = self.epoch(self.state, *self.data, first[:1], self.lr, self.gen)
        with self.keeper.keeping(ctx.device):
            self.kept = {"losses": losses.tolist(),
                         "grads": port.first_gradients(self.opt, self.state)}
        self.state, (losses, _) = self.epoch(self.state, *self.data, first[1:], self.lr, self.gen)
        with self.keeper.keeping(ctx.device):
            idx = torch.from_numpy(first.reshape(-1)).to(ctx.device)
            self.kept.update(losses=self.kept["losses"] + losses.tolist(),
                             params=port.trained_params(self.opt, self.state),
                             images=self.data[0].index_select(0, idx),
                             pids=self.data[1].index_select(0, idx))

    def unit(self) -> int:
        rows = self.rows.take(self.ctx.traffic["rows_per_unit"])
        with record_function("portbench.unit"):
            self.state, (losses, _) = self.epoch(self.state, *self.data, rows, self.lr, self.gen)
            with record_function("portbench.fetch"):
                losses.tolist()
        return rows.size

    def finish(self) -> dict:
        kept = self.kept
        self.epoch.release()
        del self.epoch, self.state, self.data, self.kept
        port.free()
        return kept

    # ------------------------------------------------------------ the check
    def reference(self, kept: dict, prec: Precision, keep: float = 1.0) -> dict:
        ctx, t = self.ctx, self.ctx.traffic
        config = ctx.cell.config
        W0 = weights.make(self.shapes, ctx.streams["weights"], ctx.device)
        if self.uniprompt:
            text = ref.text_features(W0, t["classes"], prec)
            loss = ref.stage2_loss(config["cfg"], t["classes"], text, prec, keep)
        else:
            loss = ref.baseline_loss(config["cfg"], t["classes"], prec, keep)
        b = t["batch"]
        batches = [(kept["images"][i * b:(i + 1) * b], kept["pids"][i * b:(i + 1) * b])
                   for i in range(CHECKED_STEPS)]
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.streams["augment"])
        out = ref.follow(W0, t["stage"], port.node_at(config["cfg"], t["solver"]), self.lr, batches,
                         loss, gen)
        out["W0"] = W0
        return out

    def check(self, kept: dict) -> list:
        fp32_only()
        return self.numbers(kept, self.reference(kept, Precision("fp32")))

    def numbers(self, kept: dict, r: dict, every: bool = False) -> list:
        return port.train_numbers(kept, r, self.ctx.limits, every)

    @staticmethod
    def as_reading(r: dict) -> dict:
        """A reference's output in the place of the port's readings."""
        return {"losses": r["losses"], "grads": r["grad_norms"], "params": r["params"]}

    # -------------------------------------------------------- for readers
    def flops_per_item(self) -> float:
        cfg, t = self.ctx.cfg, self.ctx.traffic
        hw = tuple(cfg.INPUT.SIZE_TRAIN)
        if self.uniprompt:
            return counts.vit_train_per_image(hw=hw, classes=t["classes"],
                                              text_classes=t["classes"])
        return counts.rn50_train_per_image(hw=hw, classes=t["classes"])

    def attention(self):
        """The attention kernels' shape in the window, None without them."""
        if not self.uniprompt:
            return None
        h, w = self.ctx.cfg.INPUT.SIZE_TRAIN
        model = self.ctx.cell.config["model"]
        patch = model["vision_patch_size"]
        return Shape(self.ctx.traffic["batch"], (h // patch) * (w // patch) + 1,
                     model["vision_width"] // 64)
