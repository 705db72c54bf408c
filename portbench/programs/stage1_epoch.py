"""Uni-Prompt stage 1a: one epoch as ``engine/uniprompt.py::do_train_stage1``
runs it: the epoch's order from ``np.random.default_rng``, its full batches
through one ``engine/steps.py::make_stage1_epoch`` call over the bank on
the card, the losses fetched, the trailing rows through
``make_stage1_step``, its loss fetched.

Unit of work: one such epoch. Items: bank rows.

Set-up builds the model, the optimizer, the epoch, the trailing step and
the state once and drives them with the window's calls: the first row of
the first order (eager), the moments kept; its next three rows (two eager,
the capture and its first replay), the contexts kept; then the trailing
step three times (two eager, the capture)."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from portbench.counts import models as counts
from portbench.counts.attention import Shape
from portbench.data import images, weights
from portbench.harness import port
from portbench.reference import train as ref
from portbench.reference.precision import Precision, fp32_only

CHECKED_STEPS = 4
STAGE = "1a"


class Program:
    def __init__(self, ctx):
        self.ctx = ctx
        self.keeper = port.Keeper()

    @property
    def check_seconds(self) -> float:
        return self.keeper.seconds

    def setup(self) -> None:
        from mpreid_tpu_torch.engine.steps import make_stage1_epoch, make_stage1_step
        from mpreid_tpu_torch.engine.train_state import initial_state
        from mpreid_tpu_torch.models.factory import compute_dtype
        from mpreid_tpu_torch.solver import make_optimizer

        ctx, t, cfg = self.ctx, self.ctx.traffic, self.ctx.cfg
        model, self.shapes = port.build(ctx, uniprompt=True)
        self.opt = make_optimizer(port.node_at(cfg, t["solver"]), model, stage=t["stage"])
        self.epoch = make_stage1_epoch(model, cfg, self.opt, STAGE)
        self.step = make_stage1_step(model, cfg, self.opt, STAGE)
        self.state = initial_state(model, self.opt)
        feats, labels = images.bank(t["rows"], t["classes"],
                                    model.text_encoder.text_projection.shape[1],
                                    compute_dtype(cfg), ctx.streams["bank"], ctx.device)
        self.bank = (feats, labels, torch.zeros_like(labels))
        self.batch = t["batch"]
        self.full = t["rows"] // self.batch
        self.rng = np.random.default_rng(ctx.streams["order"])
        self.lr = float(t["lr"])
        perm = self.rng.permutation(t["rows"])
        first = perm[:CHECKED_STEPS * self.batch].reshape(CHECKED_STEPS, self.batch)
        self.state, losses = self.epoch(self.state, *self.bank, first[:1], self.lr)
        with self.keeper.keeping(ctx.device):
            self.kept = {"losses": losses.tolist(),
                         "grads": port.first_gradients(self.opt, self.state)}
        self.state, losses = self.epoch(self.state, *self.bank, first[1:], self.lr)
        with self.keeper.keeping(ctx.device):
            idx = torch.from_numpy(first.reshape(-1)).to(ctx.device)
            self.kept.update(losses=self.kept["losses"] + losses.tolist(),
                             params=port.trained_params(self.opt, self.state),
                             feats=feats.index_select(0, idx), labels=labels.index_select(0, idx))
        rest = perm[self.full * self.batch:]
        for _ in range(3):
            self._trailing(rest)

    def _trailing(self, rest) -> None:
        if len(rest):
            sel = torch.from_numpy(rest).to(self.ctx.device)
            feats, labels, views = self.bank
            self.state, metrics = self.step(self.state, feats[sel], labels[sel], None, self.lr)
            float(metrics["loss"])

    def unit(self) -> int:
        with record_function("portbench.unit"):
            perm = self.rng.permutation(self.ctx.traffic["rows"])
            rows = perm[:self.full * self.batch].reshape(self.full, self.batch)
            self.state, losses = self.epoch(self.state, *self.bank, rows, self.lr)
            with record_function("portbench.fetch"):
                losses.tolist()
            with record_function("portbench.trailing"):
                self._trailing(perm[self.full * self.batch:])
        return len(perm)

    def finish(self) -> dict:
        kept = self.kept
        self.epoch.release()
        self.step.release()
        del self.epoch, self.step, self.state, self.bank, self.kept
        port.free()
        return kept

    # ------------------------------------------------------------ the check
    def reference(self, kept: dict, prec: Precision, keep: float = 1.0) -> dict:
        ctx, t = self.ctx, self.ctx.traffic
        W0 = weights.make(self.shapes, ctx.streams["weights"], ctx.device)
        b = self.batch
        batches = [(kept["feats"][i * b:(i + 1) * b], kept["labels"][i * b:(i + 1) * b])
                   for i in range(CHECKED_STEPS)]
        out = ref.follow(W0, t["stage"], port.node_at(ctx.cell.config["cfg"], t["solver"]), self.lr,
                         batches, ref.stage1_loss(prec, keep))
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
        m = self.ctx.cell.config["model"]
        return counts.text_stage1_per_row(m["context_length"], m["transformer_width"],
                                          m["transformer_layers"], m["embed_dim"])

    def attention(self):
        m = self.ctx.cell.config["model"]
        return Shape(self.batch, m["context_length"], m["transformer_width"] // 64, causal=True)
