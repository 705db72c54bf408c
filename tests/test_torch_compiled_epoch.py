"""The port's compiled epochs (``engine/compiled.py``): ``make_stage1_epoch``
and ``make_train_epoch``, and the Adam leaf's scalars from a tensor.

On the CPU a compiled epoch runs its step body eagerly over the same index
buffer as the card's captured graph, so these tests hold everything but the
capture itself (the ``cuda``-marked cases in tests/test_torch_cuda.py hold
the graphs on the card):

- (a) ``make_stage1_epoch`` against the JAX package's on the same weights,
  bank and ``perm``, stages 1a and 1b, fp32: each step's loss to 1e-4
  relative and the contexts as tests/test_torch_uniprompt.py's
  ``test_stage1_step_matches_jax`` holds them;
- (b) ``make_stage1_epoch`` and ``make_train_epoch`` against the port's
  step loop over the same rows, bit for bit, over two epochs at different
  lr: every step's loss (and accuracy), every parameter and buffer (the BN
  running statistics), the moments, the step, the centers and the
  generator state; fp32 and bf16 moments, the center loss once;
- (c) ``adam_leaf_plain`` with its ``scalars`` tensor against the JAX
  package's Pallas kernel in interpret mode, and bit for bit against the
  plain version that took the scalars as Python floats; the optimizer's
  device scalars against the host's fp32 arithmetic;
- (d) ``do_train_stage1``: the full batches through one epoch call, the
  trailing partial batch through the step, and the JAX package's log lines.

Tiny CLIP (tests/tiny.py) on one thread.
"""

import copy
import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.engine import steps as jsteps
from mpreid_tpu.engine import uniprompt as juni
from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
from mpreid_tpu.ops.adam_kernel import fused_adam_leaf as jax_fused_adam_leaf
from mpreid_tpu.solver import make_optimizer as jax_make_optimizer
from mpreid_tpu.solver import make_scheduler as jax_make_scheduler
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import (
    do_train_stage1, initial_state, make_stage1_epoch, make_stage1_step, make_train_epoch,
    make_train_step,
)
from mpreid_tpu_torch.engine import uniprompt as tuni
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import make_model
from mpreid_tpu_torch.ops import adam as tadam
from mpreid_tpu_torch.solver import make_optimizer, make_scheduler

from test_torch_uniprompt import NC, Pair, _assert_params_close, _bank, _np, _t

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

LRS = (1e-3, 3e-4)  # the two epochs' lr


def _rows(n_rows, n_batches, batch, seed):
    return np.random.default_rng(seed).permutation(n_rows)[:n_batches * batch].reshape(
        n_batches, batch)


# ---------------------------------------------------------------------------
# (a) make_stage1_epoch against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["1a", "1b"])
def test_stage1_epoch_matches_jax(stage):
    p = Pair()
    feats, labels, views = _bank(20)
    perm = _rows(20, 2, 8, seed=3)
    lr = 1e-3
    stage_cfg = p.jcfg.SOLVER[f"STAGE{stage.upper()}"]
    jopt = jax_make_optimizer(stage_cfg, p.variables["params"], stage=f"stage{stage}")
    jstate, jlosses = jsteps.make_stage1_epoch(p.jmodel, p.jcfg, jopt, stage)(
        jax_initial_state(p.variables, jopt), jnp.asarray(feats), jnp.asarray(labels),
        jnp.asarray(views), jnp.asarray(perm), lr)
    opt = make_optimizer(p.tcfg.SOLVER[f"STAGE{stage.upper()}"], p.tmodel, stage=f"stage{stage}")
    epoch = make_stage1_epoch(p.tmodel, p.tcfg, opt, stage)
    state, losses = epoch(initial_state(p.tmodel, opt), _t(feats), _t(labels).long(),
                          _t(views).long(), perm, lr)
    assert losses.shape == (2,) and int(state.opt_state.step) == 2
    assert epoch.compiled.stats == dict(captures=0, replays=0, eager_steps=2, pool_bytes=0)
    np.testing.assert_allclose(_np(losses), _np(jlosses), rtol=1e-4, atol=0)
    _assert_params_close(p.tmodel, p.convert({"params": jstate.params,
                                              "batch_stats": jstate.batch_stats}), lr)


# ---------------------------------------------------------------------------
# (b) the compiled epochs against the step loop, bit for bit
# ---------------------------------------------------------------------------

def _assert_states_equal(a, b):
    """Two runs' (outputs, state, model, generator) bit for bit."""
    (out_a, sa, ma, ga), (out_b, sb, mb, gb) = a, b
    for x, y in zip(out_a, out_b):
        assert x.dtype == y.dtype and torch.equal(x, y), (x, y)
    for (name, t), u in zip(ma.state_dict().items(), mb.state_dict().values()):
        assert torch.equal(t, u), name
    for key in ("mu", "nu"):
        for name, t in getattr(sa.opt_state, key).items():
            assert torch.equal(t, getattr(sb.opt_state, key)[name]), (key, name)
    assert torch.equal(sa.opt_state.step, sb.opt_state.step)
    assert torch.equal(sa.opt_state.lr, sb.opt_state.lr)
    if sa.centers is not None:
        assert torch.equal(sa.centers, sb.centers)
    if ga is not None:
        assert torch.equal(ga.get_state(), gb.get_state())


@pytest.mark.parametrize("stage,moment_dtype", [("1a", "float32"), ("1b", "bfloat16")])
def test_stage1_epoch_equals_the_step_loop_bit_for_bit(stage, moment_dtype):
    p = Pair()
    feats, labels, views = (_t(a) for a in _bank(24))
    labels, views = labels.long(), views.long()
    name = f"STAGE{stage.upper()}"
    p.tcfg.SOLVER[name].MOMENT_DTYPE = moment_dtype
    runs = []
    for mode in ("epoch", "steps"):
        m = copy.deepcopy(p.tmodel)
        opt = make_optimizer(p.tcfg.SOLVER[name], m, stage=f"stage{stage}")
        state = initial_state(m, opt)
        epoch = make_stage1_epoch(m, p.tcfg, opt, stage)
        step = make_stage1_step(m, p.tcfg, opt, stage)
        losses = []
        for e, lr in enumerate(LRS):
            perm = _rows(24, 3, 8, seed=e)
            if mode == "epoch":
                state, out = epoch(state, feats, labels, views, perm, lr)
                losses.append(out)
            else:
                for row in perm:
                    sel = torch.from_numpy(row)
                    state, metrics = step(state, feats[sel], labels[sel],
                                          views[sel] if stage == "1b" else None, lr)
                    losses.append(metrics["loss"][None])
        runs.append(((torch.cat(losses),), state, m, None))
    assert runs[0][1].opt_state.mu["prompt_learner.ctx_" + (
        "generic" if stage == "1a" else "modality")].dtype == getattr(torch, moment_dtype)
    _assert_states_equal(*runs)


def _train_cfg(moment_dtype, center):
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.MODEL.DEBUG_TINY = True
    cfg.MODEL.DEVICE = "cpu"
    cfg.MODEL.SIE_CAMERA = center
    cfg.INPUT.SIZE_TRAIN = [32, 16]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.DATALOADER.SAMPLER = "softmax_triplet"
    cfg.SOLVER.MOMENT_DTYPE = moment_dtype
    cfg.SOLVER.FUSED_ADAM = False
    return cfg


def _train_data(n=40, ids=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 32, 16, 3), dtype=np.uint8),
            (np.arange(n) % ids).astype(np.int32), rng.integers(0, 6, n).astype(np.int32),
            rng.integers(0, 15, n).astype(np.int32))


def _pk_rows(n_batches, seed, n=40, ids=5):
    """PK rows: 2 ids × 4 images per batch of 8."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_batches):
        chosen = rng.choice(ids, 2, replace=False)
        rows.append(np.concatenate([np.flatnonzero(np.arange(n) % ids == i)[rng.permutation(8)[:4]]
                                    for i in chosen]))
    return np.stack(rows)


@pytest.mark.parametrize("moment_dtype,center", [("float32", True), ("bfloat16", False)])
def test_train_epoch_equals_the_step_loop_bit_for_bit(moment_dtype, center):
    """Augmentation on, two epochs of three PK batches at different lr."""
    cfg = _train_cfg(moment_dtype, center)
    model = make_model(cfg, NC, camera_num=6, view_num=1)
    loss_fn, _ = make_loss(cfg, NC)
    kwargs = dict(center_weight=0.0005, center_lr=0.5) if center else {}
    centers = torch.randn(NC, 64, generator=torch.Generator().manual_seed(3)) if center else None
    data = _train_data()
    runs = []
    for mode in ("epoch", "steps"):
        m = copy.deepcopy(model)
        opt = make_optimizer(cfg.SOLVER, m, stage="baseline")
        state = initial_state(m, opt, centers=None if centers is None else centers.clone())
        gen = torch.Generator().manual_seed(7)
        epoch = make_train_epoch(m, cfg, loss_fn, opt, **kwargs)
        step = make_train_step(m, cfg, loss_fn, opt, **kwargs)
        tensors = [torch.from_numpy(a) for a in data]
        losses, accs = [], []
        for e, lr in enumerate(LRS):
            perm = _pk_rows(3, seed=e)
            if mode == "epoch":
                state, (lo, ac) = epoch(state, *tensors, perm, lr, gen)
                losses.append(lo)
                accs.append(ac)
                continue
            for row in perm:
                batch = {"images": data[0][row], "pids": data[1][row], "camids": data[2][row],
                         "trackids": data[3][row]}
                state, metrics = step(state, batch, lr, gen)
                losses.append(metrics["loss"][None])
                accs.append(metrics["acc"][None])
        runs.append(((torch.cat(losses), torch.cat(accs)), state, m, gen))
    assert int(runs[0][1].opt_state.step) == 6
    assert runs[0][1].opt_state.mu["classifier.weight"].dtype == getattr(torch, moment_dtype)
    _assert_states_equal(*runs)
    if center:
        assert not torch.equal(runs[0][1].centers, centers)


# ---------------------------------------------------------------------------
# (c) the Adam leaf's scalars from a tensor
# ---------------------------------------------------------------------------

def _plain_with_floats(p, m, v, g, lr, bc1, bc2, b1, b2, eps, wd, decoupled):
    """The plain leaf update as it took its scalars before, as Python floats."""
    with torch.no_grad():
        if not decoupled:
            g = g + wd * p
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * (g * g)
        step = lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if decoupled:
            step = step + float(np.float32(lr) * np.float32(wd)) * p
        p.sub_(step)
        m.copy_(m32)
        v.copy_(v32)


@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adam_leaf_scalars_tensor(decoupled, moment_dtype):
    """Against the Pallas kernel in interpret mode (tolerances of
    tests/test_torch_train.py's ``test_plain_adam_leaf_matches_pallas_interpret``)
    and bit for bit against the Python-float plain version."""
    rng = np.random.default_rng(21)
    shape = (131, 67)
    p = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    v = np.abs(rng.standard_normal(shape) * 1e-4).astype(np.float32)
    b1, b2, eps, wd, lr, t = 0.9, 0.999, 1e-8, 1e-4, 6e-4, 7
    jmd, tmd = getattr(jnp, moment_dtype), getattr(torch, moment_dtype)
    scalars = jnp.asarray([lr, 1 - b1 ** t, 1 - b2 ** t], jnp.float32)
    jp, jm, jv = jax_fused_adam_leaf(jnp.asarray(p), jnp.asarray(m).astype(jmd),
                                     jnp.asarray(v).astype(jmd), jnp.asarray(g), scalars,
                                     b1, b2, eps, wd, decoupled, jmd, interpret=True)
    tp, tm, tv = _t(p), _t(m).to(tmd), _t(v).to(tmd)
    tadam.adam_leaf_plain(tp, tm, tv, _t(g), _t(np.asarray(scalars)), b1, b2, eps, wd, decoupled)
    np.testing.assert_allclose(_np(tp), _np(jp), rtol=1e-6, atol=1e-7)
    rtol = 2.0 ** -8 if moment_dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=rtol, atol=1e-8)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=rtol, atol=1e-10)
    fp, fm, fv = _t(p), _t(m).to(tmd), _t(v).to(tmd)
    s = np.asarray(scalars)
    _plain_with_floats(fp, fm, fv, _t(g), float(s[0]), float(s[1]), float(s[2]), b1, b2, eps,
                       wd, decoupled)
    for got, want in ((tp, fp), (tm, fm), (tv, fv)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_step_scalars_are_formed_on_the_device(name):
    """``Optimizer.step_scalars`` from the device step and lr: [lr·mult,
    1 − b1^t, 1 − b2^t] in fp32 as the host formed them (the bias
    corrections to an fp32 ulp: torch's and numpy's fp32 pow may round
    apart), the SGD lr itself; ``update`` counts the step in place."""
    cfg = _train_cfg("float32", False)
    cfg.SOLVER.OPTIMIZER_NAME = name
    cfg.SOLVER.BIAS_LR_FACTOR = 2
    params = {"a.weight": torch.nn.Parameter(torch.ones(4)),
              "a.bias": torch.nn.Parameter(torch.ones(4))}
    opt = make_optimizer(cfg.SOLVER, params)
    state = opt.init(params)
    assert state.step.dtype == torch.int32 and state.lr.dtype == torch.float32
    step0 = state.step
    for t, lr in enumerate((3e-4, 1e-3, 7e-5), start=1):
        opt.update({k: torch.full((4,), 0.5) for k in params}, state, params, lr)
        assert state.step is step0 and int(state.step) == t
        table = opt.step_scalars(state)
        assert sorted(table) == [1.0, 2.0]
        for mult, row in table.items():
            lr_mult = np.float32(np.float32(lr) * np.float32(mult))
            if name == "SGD":
                assert row is state.lr and float(row) == np.float32(lr)
                continue
            assert row.dtype == torch.float32 and float(row[0]) == lr_mult
            want = [np.float32(1 - np.float32(b) ** np.float32(t)) for b in (opt.b1, opt.b2)]
            np.testing.assert_allclose(row[1:].numpy(), want, rtol=2.0 ** -23, atol=0)


# ---------------------------------------------------------------------------
# (d) do_train_stage1: the full batches in the epoch, the trailing one in the step
# ---------------------------------------------------------------------------

LINE = re.compile(r"Epoch\[(\d+)\] Iteration\[(\d+)/(\d+)\] Loss: ([0-9.]+), Base Lr: (\S+)")


def test_do_train_stage1_splits_the_epoch_as_jax(monkeypatch, caplog):
    """20 bank rows at batch 8: two full batches through ``make_stage1_epoch``
    and the trailing 4 through ``make_stage1_step`` in each of two epochs;
    the iteration log lines as the JAX package's (the losses to their
    printed digits), the history to 1e-5."""
    p = Pair()
    bank = _bank(20)
    for cfg in (p.jcfg, p.tcfg):
        cfg.SOLVER.STAGE1B.MAX_EPOCHS = 2
        cfg.SOLVER.STAGE1B.BASE_LR = 1e-3
        cfg.SOLVER.STAGE1B.WARMUP_EPOCHS = 0
        cfg.SOLVER.STAGE1B.LOG_PERIOD = 1
        cfg.OUTPUT_DIR = ""
    seen = {"epoch": [], "step": []}
    real_epoch, real_step = tuni.make_stage1_epoch, tuni.make_stage1_step

    def spy_epoch(*args):
        fn = real_epoch(*args)

        def epoch(state, feats, labels, views, perm, lr):
            seen["epoch"].append(np.asarray(perm).shape)
            return fn(state, feats, labels, views, perm, lr)

        epoch.release = fn.release
        return epoch

    def spy_step(*args):
        fn = real_step(*args)

        def step(state, feats, labels, views, lr):
            seen["step"].append(len(labels))
            return fn(state, feats, labels, views, lr)

        return step

    monkeypatch.setattr(tuni, "make_stage1_epoch", spy_epoch)
    monkeypatch.setattr(tuni, "make_stage1_step", spy_step)
    for name in ("mpreid_tpu.train", "mpreid_tpu_torch.train"):
        # a logging config applied earlier in the process may have disabled them
        monkeypatch.setattr(logging.getLogger(name), "disabled", False)
        caplog.set_level(logging.INFO, logger=name)
    jopt = jax_make_optimizer(p.jcfg.SOLVER.STAGE1B, p.variables["params"], stage="stage1b")
    opt = make_optimizer(p.tcfg.SOLVER.STAGE1B, p.tmodel, stage="stage1b")
    with caplog.at_level(logging.INFO):
        _, jhist = juni.do_train_stage1(
            p.jcfg, p.jmodel, p.variables, None, jopt,
            jax_make_scheduler(p.jcfg.SOLVER.STAGE1B, "cosine"), is_stage1b=True, bank=bank,
            stage_cfg=p.jcfg.SOLVER.STAGE1B)
        jlines = [LINE.search(r.getMessage()).groups() for r in caplog.records
                  if r.name == "mpreid_tpu.train" and LINE.search(r.getMessage())]
        caplog.clear()
        state, hist = do_train_stage1(
            p.tcfg, p.tmodel, None, opt, make_scheduler(p.tcfg.SOLVER.STAGE1B, "cosine"),
            is_stage1b=True, bank=(_t(bank[0]), bank[1], bank[2]),
            stage_cfg=p.tcfg.SOLVER.STAGE1B)
        lines = [LINE.search(r.getMessage()).groups() for r in caplog.records
                 if r.name == "mpreid_tpu_torch.train" and LINE.search(r.getMessage())]
    assert seen == {"epoch": [(2, 8), (2, 8)], "step": [4, 4]}
    assert int(state.opt_state.step) == 6
    assert [ln[:3] + ln[4:] for ln in lines] == [ln[:3] + ln[4:] for ln in jlines]
    assert [ln[:3] for ln in lines] == [("1", "1", "3"), ("1", "2", "3"), ("2", "1", "3"),
                                        ("2", "2", "3")]
    for ln, jln in zip(lines, jlines):
        assert abs(float(ln[3]) - float(jln[3])) <= 1e-3
    for h, jh in zip(hist, jhist):
        assert h["epoch"] == jh["epoch"] and abs(h["loss"] - jh["loss"]) <= 1e-5 * abs(jh["loss"])
