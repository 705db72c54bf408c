"""What the programs share: the port's model built and filled with the
benchmark's weights, and what a training cell keeps for the comparison."""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict

import torch

from portbench.data import weights

from . import compare


def build(ctx, uniprompt: bool):
    """The port's model for the cell (``models/factory.py``), on the device,
    every parameter set from the seed (``data/weights.py``) → (model, the
    parameters' shapes)."""
    from mpreid_tpu_torch.models.factory import build_model, build_model_uniprompt
    from mpreid_tpu_torch.utils.device import device_from_cfg

    device_from_cfg(ctx.cfg)  # as the port's entries take the device (fp32: TF32 off)
    make = build_model_uniprompt if uniprompt else build_model
    with torch.device(ctx.device):
        model = make(ctx.cfg, ctx.traffic["classes"], ctx.traffic.get("cameras", 6), 1)
    model = model.to(ctx.device).eval()
    return model, weights.fill(model, ctx.streams["weights"])


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def node_at(tree, path: str):
    """``"SOLVER.STAGE2"`` → that node of a config node or of the nested
    settings of a configuration file."""
    for part in path.split("."):
        tree = tree[part]
    return tree


class Keeper:
    """Times what a program keeps for the comparison (not set-up)."""

    def __init__(self):
        self.seconds = 0.0

    @contextlib.contextmanager
    def keeping(self, device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.seconds += time.perf_counter() - t0


@torch.no_grad()
def first_gradients(opt, state) -> Dict[str, float]:
    """Each trained leaf's gradient as Adam took it at the first step, from
    the first moment after it: m₁ = (1 − β₁)·g."""
    return {k: float(torch.linalg.norm((m.float() / (1 - opt.b1)).double()))
            for k, m in state.opt_state.mu.items()}


@torch.no_grad()
def trained_params(opt, state) -> Dict[str, torch.Tensor]:
    """Host copies of the trained leaves."""
    train, _ = opt.partition(state.model)
    return {k: p.detach().to("cpu", copy=True) for k, p in train.items()}


@torch.no_grad()
def train_numbers(kept: dict, r: dict, limits: dict, every: bool = False) -> list:
    """A training cell's numbers, those its ``limits`` name (with ``every``,
    all): ``loss_gap`` the widest relative gap of a step's loss,
    ``loss_gap_mean`` the mean over the steps, ``loss1_gap`` the first
    step's; ``grad_gap`` the worst leaf's gap of the norm of the
    first gradient as Adam took it, ``grad_gap_median`` the median leaf's;
    ``delta_gap`` the worst leaf's gap of the norm of its change over the
    checked steps, over the elements the reference's gradient moves
    (``compare.moved``), ``delta_gap_median`` the median leaf's,
    ``delta_diff`` the change's whole error (``compare.difference``). ``r`` is
    the reference's ``follow`` with its start ``W0``; ``kept`` the port's
    readings (or, for the control, another reference's)."""
    masks = compare.moved(r["loss_grads"])
    delta_p = compare.change_norms(kept["params"], r["W0"], masks)
    delta_r = compare.change_norms(r["params"], r["W0"], masks)
    steps = [compare.relative(a, b) for a, b in zip(kept["losses"], r["losses"])]
    values = {
        "loss_gap": max(steps),
        "loss_gap_mean": sum(steps) / len(steps),
        "loss1_gap": compare.relative(kept["losses"][0], r["losses"][0]),
        "grad_gap": compare.worst_leaf(kept["grads"], r["grad_norms"]),
        "grad_gap_median": compare.median_leaf(kept["grads"], r["grad_norms"]),
        "delta_gap": compare.worst_leaf(delta_p, delta_r),
        "delta_gap_median": compare.median_leaf(delta_p, delta_r),
        "delta_diff": compare.difference(kept["params"], r["params"], r["W0"], masks),
    }
    free()
    return compare.compared(values, limits, every)
