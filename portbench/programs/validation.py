"""A complete evaluation: ``engine/processor.py::run_validation`` over an
in-memory loader of decoded query and gallery images in host memory:
the upload, the graphed eval step (``processor.cached_eval_step``, kept
across passes), the features, the distances, CMC and mAP
(``engine/evaluator.py::R1mAPEvaluator``).

Unit of work: one ``run_validation``. Items: query + gallery images.

The evaluator's outputs (features, distances, CMC, mAP) are read for the
comparison through a subclass that keeps what ``compute`` returns, put in
the evaluator's place in ``processor``'s namespace; it changes nothing the
pass computes. Set-up runs one pass (two eager batches, the capture,
replays); the window's passes replay only."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from portbench.counts import models as counts
from portbench.counts.attention import Shape
from portbench.data import images, weights
from portbench.harness import compare, port
from portbench.reference import augment, evaluation, models
from portbench.reference.precision import Precision, fp32_only


def keeping_evaluator(base, kept: list):
    class Keeping(base):
        def compute(self):
            out = super().compute()
            kept[:] = [out]
            return out

    return Keeping


class Program:
    def __init__(self, ctx):
        self.ctx = ctx
        self.check_seconds = 0.0

    def setup(self) -> None:
        from mpreid_tpu_torch.engine import processor

        ctx, t, cfg = self.ctx, self.ctx.traffic, self.ctx.cfg
        self.model, self.shapes = port.build(ctx, uniprompt=True)
        hw = tuple(cfg.INPUT.SIZE_TEST)
        self.images, self.pids, self.camids = images.eval_set(
            t["query"], t["gallery"], t["ids"], hw, ctx.streams["val"], ctx.device, t["noise"])
        self.loader = images.EvalLoader(self.images, self.pids, self.camids, t["batch"])
        self.outputs = []
        self.scores = []  # every pass's (rank-1, mAP)
        self.processor, self.evaluator = processor, processor.R1mAPEvaluator
        processor.R1mAPEvaluator = keeping_evaluator(self.evaluator, self.outputs)
        self.unit()
        self.scores.clear()

    def unit(self) -> int:
        with record_function("portbench.unit"):
            cmc, mAP = self.processor.run_validation(self.ctx.cfg, self.model, self.loader,
                                                     self.ctx.traffic["query"])
        self.scores.append((float(cmc[0]), float(mAP)))
        return len(self.images)

    def finish(self) -> dict:
        cmc, mAP, distmat, _, _, qf, gf = self.outputs[0]
        kept = {"cmc": np.asarray(cmc), "mAP": float(mAP), "distmat": distmat,
                "feats": np.concatenate([qf, gf]), "scores": list(self.scores)}
        self.processor.release_eval_steps(self.model)
        self.processor.R1mAPEvaluator = self.evaluator
        del self.model, self.outputs[:]
        port.free()
        return kept

    # ------------------------------------------------------------ the check
    @torch.no_grad()
    def reference(self, kept: dict, prec: Precision, block: int = 256) -> dict:
        """Features of every image (the tower's class token after ``ln_post``
        and its projection, the configuration's ``NECK_FEAT`` 'before'),
        L2-normalised; distances; CMC; mAP."""
        ctx, cfg = self.ctx, self.ctx.cell.config["cfg"]
        W0 = weights.make(self.shapes, ctx.streams["weights"], ctx.device)
        feats = []
        for lo in range(0, len(self.images), block):
            x = torch.from_numpy(self.images[lo:lo + block]).to(ctx.device)
            x = augment.normalise(x, cfg["INPUT"]["PIXEL_MEAN"], cfg["INPUT"]["PIXEL_STD"])
            _, feat, proj = models.vision(x, W0, prec)
            feats.append(torch.cat([feat, proj], dim=1))
        del W0
        f = evaluation.normalised(torch.cat(feats))
        nq = ctx.traffic["query"]
        dist = evaluation.distances(f[:nq], f[nq:])
        dev = f.device
        cmc, mAP = evaluation.cmc_map(dist, torch.from_numpy(self.pids[:nq]).to(dev),
                                      torch.from_numpy(self.pids[nq:]).to(dev))
        return {"feats": f, "distmat": dist, "cmc": cmc.cpu().numpy(), "mAP": mAP}

    def check(self, kept: dict) -> list:
        fp32_only()
        return self.numbers(kept, self.reference(kept, Precision("fp32")))

    @staticmethod
    def as_reading(r: dict) -> dict:
        """A reference's output in the place of the port's readings."""
        return {"feats": r["feats"].cpu().numpy(), "distmat": r["distmat"].cpu().numpy(),
                "cmc": r["cmc"], "mAP": r["mAP"], "scores": []}

    def numbers(self, kept: dict, r: dict, every: bool = False) -> list:
        """The widest feature gap (unit vectors), the widest distance gap, and
        every pass's rank-1 and mAP gaps."""
        dev = r["feats"].device
        feat_gap = float(torch.linalg.norm(torch.from_numpy(kept["feats"]).to(dev) - r["feats"],
                                           dim=1).max())
        dist_gap = float((torch.from_numpy(kept["distmat"]).to(dev) - r["distmat"]).abs().max())
        r1, mAP = float(r["cmc"][0]), float(r["mAP"])
        scores = kept["scores"] + [(float(kept["cmc"][0]), kept["mAP"])]
        cmc_gap = float(np.abs(np.asarray(kept["cmc"], np.float64) - r["cmc"]).max())
        port.free()
        return compare.compared({"feat_gap": feat_gap, "dist_gap": dist_gap,
                                 "rank1_gap": max(abs(a - r1) for a, _ in scores),
                                 "cmc_gap": cmc_gap,
                                 "map_gap": max(abs(b - mAP) for _, b in scores)},
                                self.ctx.limits, every)

    # -------------------------------------------------------- for readers
    def flops_per_item(self) -> float:
        m = self.ctx.cell.config["model"]
        return counts.vit_eval_per_image(hw=tuple(self.ctx.cfg.INPUT.SIZE_TEST),
                                         patch=m["vision_patch_size"], width=m["vision_width"],
                                         layers=m["vision_layers"], embed=m["embed_dim"])

    def attention(self):
        m = self.ctx.cell.config["model"]
        h, w = self.ctx.cfg.INPUT.SIZE_TEST
        p = m["vision_patch_size"]
        return Shape(self.ctx.traffic["batch"], (h // p) * (w // p) + 1, m["vision_width"] // 64)
