"""The comparison sees a broken timed path: each fault planted under a
run (no card needed) turns ``correct`` false. The faults a cell on one
chip can have: a step that leaves the state unchanged; half the batch left
out of the loss, the mean taken over the rest; an answer altered where it
is produced. (The exchange between chips does not exist on one chip.)
The control, the fp8 reference in the port's place, fails too."""

import pytest
import torch

from portbench.harness import manifest, runner
from portbench.reference.precision import Precision

from .conftest import TINY, cell

SEED = 2 ** 31 + 901


def _run(name):
    return runner.execute(cell(name), SEED, 0.3, False, "cpu", TINY)


@pytest.mark.parametrize("name", ["vitb16-uniprompt.stage2a", "rn50-baseline.train",
                                  "vitb16-uniprompt.stage1a"])
def test_a_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from mpreid_tpu_torch.solver import optim

    monkeypatch.setattr(optim.Optimizer, "update_leaf", lambda self, *a, **k: None)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", ["vitb16-uniprompt.stage2a", "rn50-baseline.train"])
def test_half_the_batch_left_out(name, monkeypatch):
    from mpreid_tpu_torch.engine import steps

    real = steps.loss_and_grads

    def half(model, cfg, loss_fn, optimizer, x, target, *args, **kw):
        n = x.shape[0] // 2
        return real(model, cfg, loss_fn, optimizer, x[:n], target[:n], *args, **kw)

    monkeypatch.setattr(steps, "loss_and_grads", half)
    assert not _run(name)["correct"]


def test_half_the_stage1_batch_left_out(monkeypatch):
    from mpreid_tpu_torch.engine import steps

    real = steps.stage1_loss_and_grads

    def half(model, optimizer, stage, feats, target, views):
        n = feats.shape[0] // 2
        return real(model, optimizer, stage, feats[:n], target[:n],
                    None if views is None else views[:n])

    monkeypatch.setattr(steps, "stage1_loss_and_grads", half)
    assert not _run("vitb16-uniprompt.stage1a")["correct"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from mpreid_tpu_torch.engine import evaluator

    real = evaluator.R1mAPEvaluator.update

    def altered(self, output):
        feat, pid, camid = output
        if not self.feats:  # the first batch's features: one row changed
            feat = feat.clone()
            feat[0] = -feat[0]
        return real(self, (feat, pid, camid))

    monkeypatch.setattr(evaluator.R1mAPEvaluator, "update", altered)
    assert not _run("vitb16-uniprompt.eval")["correct"]


@pytest.mark.parametrize("name", ["vitb16-uniprompt.stage2a", "vitb16-uniprompt.eval"])
def test_the_fp8_control_fails(name):
    """The reference in fp8 e4m3 products, in the port's place, against the
    fp32 reference, at a size a test run holds."""
    cell_ = cell(name)
    prog = manifest.program(cell_.workload["program"]).Program(
        runner.context(cell_, SEED, "cpu", TINY))
    prog.setup()
    kept = prog.finish()
    r32 = prog.reference(kept, Precision("fp32"))
    r8 = prog.reference(kept, Precision("fp8"))
    numbers = prog.numbers(prog.as_reading(r8), r32)
    assert not all(n["ok"] for n in numbers), numbers
    del r8, r32
    torch.set_grad_enabled(True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vitb16-uniprompt.stage2a", "vitb16-uniprompt.stage1a",
                                  "vitb16-uniprompt.eval"])
def test_the_fp8_control_fails_at_the_cells_size(name, card):
    """On the card at the cell's own size: the port passes, the control
    (the fp8 reference in its place) fails."""
    from portbench.reference.precision import fp32_only

    cell_ = cell(name)
    prog = manifest.program(cell_.workload["program"]).Program(
        runner.context(cell_, SEED, "cuda"))
    prog.setup()
    kept = prog.finish()
    fp32_only()
    r32 = prog.reference(kept, Precision("fp32"))
    assert all(n["ok"] for n in prog.numbers(kept, r32)), prog.numbers(kept, r32)
    control = prog.numbers(prog.as_reading(prog.reference(kept, Precision("fp8"))), r32)
    assert not all(n["ok"] for n in control), control
