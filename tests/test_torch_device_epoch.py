"""The port's device-resident epoch (``TPU.DEVICE_DATASET``) and trace
(``TPU.PROFILE_DIR``) against the JAX package's and against its own step loop.

``epoch_perm`` and ``build_device_dataset`` equal the JAX package's on the
same loaders (the PK sampler's epochs that wrap and that truncate, and the
shuffled loader). ``make_train_epoch`` equals the port's ``make_train_step``
over the same batches bit for bit, from the same state and generator, with
augmentation on (baseline with the center loss, Uni-Prompt stage 2, and the
MoE tower with expert dropout, which draws from the same generator), and
equals the JAX package's ``make_train_epoch`` on the same weights with
augmentation off (the two packages draw from different generators). Then
``do_train``'s device branch, and the trace, which leaves the results as
they were. Tiny CLIP (tests/tiny.py) in fp32 on the CPU; tolerances as
tests/test_torch_train.py's: losses to 1e-4 relative, parameters after the
Adam steps to 0.25·lr·mult per step.
"""

import copy
import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.data import make_dataloader as jax_make_dataloader
from mpreid_tpu.data.synthetic import make_market1501, make_mmmp
from mpreid_tpu.engine import processor as jproc
from mpreid_tpu.engine import steps as jsteps
from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
from mpreid_tpu.losses import make_loss as jax_make_loss
from mpreid_tpu.models.factory import init_variables
from mpreid_tpu.models.reid import ReIDModel as JaxReIDModel
from mpreid_tpu.solver import make_optimizer as jax_make_optimizer
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import make_dataloader
from mpreid_tpu_torch.engine import (
    do_train, do_train_stage2, initial_state, make_train_epoch, make_train_step,
    precompute_text_features,
)
from mpreid_tpu_torch.engine.processor import TRACE_FILE, build_device_dataset, epoch_perm
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import (
    CLIPConfig, ReIDModel, from_jax_variables, make_model, make_model_uniprompt, switch_to_moe,
)
from mpreid_tpu_torch.solver import make_optimizer

from test_torch_moe import _seeded
from tiny import tiny_cfg, tiny_clip_config

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

NC = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_epoch")
    make_market1501(str(root / "market"), n_ids=6, imgs_per_id=8)
    make_mmmp(str(root / "mmmp"))
    return {"market1501": str(root / "market"), "mmmp": str(root / "mmmp")}


def _cfgs(trees, names="market1501", **overrides):
    """(JAX package config, port config), equal, on a synthetic tree."""
    jcfg = tiny_cfg(**{"DATASETS.NAMES": names, "DATASETS.ROOT_DIR": trees[names],
                       "DATASETS.EXP_SETTING": "exp_cctv_ir_cctv_rgb",
                       "DATALOADER.NATIVE_DECODE": False, "OUTPUT_DIR": "",
                       "SOLVER.EVAL_PERIOD": 100, "SOLVER.STAGE2.EVAL_PERIOD": 100,
                       **overrides})
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    tcfg.MODEL.DEVICE = "cpu"
    tcfg.MODEL.DEBUG_TINY = True
    return jcfg, tcfg


# ---------------------------------------------------------------------------
# the epoch's batches and the resident data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["softmax_triplet", "softmax"])
@pytest.mark.parametrize("names", ["market1501", "mmmp"])
def test_epoch_perm_matches_jax(trees, names, sampler):
    """Eight epochs of each loader: the PK sampler's epoch 2 is shorter than
    epoch 0's on the Market-1501 tree (it wraps around) and longer on the
    MMMP one (it is truncated)."""
    jcfg, tcfg = _cfgs(trees, names, **{"DATALOADER.SAMPLER": sampler})
    jloader, tloader = jax_make_dataloader(jcfg)[0], make_dataloader(tcfg)[0]
    for epoch in range(8):
        want = jproc.epoch_perm(jloader, epoch, jcfg.SOLVER.SEED)
        got = epoch_perm(tloader, epoch, tcfg.SOLVER.SEED)
        np.testing.assert_array_equal(got, want)
        assert got.shape == epoch_perm(tloader, 0, tcfg.SOLVER.SEED).shape
    if sampler == "softmax_triplet":
        n0, n2 = (len(tloader.sampler.epoch_indices(e)) for e in (0, 2))
        assert (n2 < n0) if names == "market1501" else (n2 > n0)


def test_build_device_dataset_matches_jax(trees):
    jcfg, tcfg = _cfgs(trees, "mmmp")
    want = jproc.build_device_dataset(jax_make_dataloader(jcfg)[0])
    got = build_device_dataset(make_dataloader(tcfg)[0], torch.device("cpu"))
    assert [t.dtype for t in got] == [torch.uint8] + [torch.int32] * 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the device epoch against the step loop, bit for bit
# ---------------------------------------------------------------------------

def _data(n=40, seed=0, ids=5):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 32, 16, 3), dtype=np.uint8)
    pids = (np.arange(n) % ids).astype(np.int32)
    camids = rng.integers(0, 6, n).astype(np.int32)
    trackids = rng.integers(0, 15, n).astype(np.int32)
    return images, pids, camids, trackids


def _perm(n_batches=3, seed=1):
    """PK rows: 2 ids × 4 images per batch of 8, from the 5 ids of ``_data``."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_batches):
        ids = rng.choice(5, 2, replace=False)
        rows.append(np.concatenate([np.flatnonzero(np.arange(40) % 5 == i)[rng.permutation(8)[:4]]
                                    for i in ids]))
    return np.stack(rows)


def _setup(trees, kind):
    """(cfg, model, step kwargs) for a bit-equality case."""
    overrides = {"MODEL.SIE_CAMERA": True} if kind == "baseline_center" else {}
    if kind == "moe_dropout":
        overrides.update({"MODEL.MOE.ENABLED": True, "MODEL.MOE.NUM_EXPERTS": 4,
                          "MODEL.MOE.TOP_K": 2, "MODEL.MOE.MOE_LAYERS": 2,
                          "MODEL.MOE.DROPOUT": 0.1})
    _, cfg = _cfgs(trees, **overrides)
    if kind == "baseline_center":
        model = make_model(cfg, NC, camera_num=6, view_num=1)
        centers = torch.randn(NC, 64, generator=torch.Generator().manual_seed(3))
        return cfg, model, dict(center_weight=0.0005, center_lr=0.5), centers
    dense = cfg.clone()
    dense.MODEL.MOE.ENABLED = False
    model = switch_to_moe(cfg, make_model_uniprompt(dense, NC, camera_num=6, view_num=15))
    text = precompute_text_features(cfg, model, NC)
    return cfg, model, dict(uniprompt=True, text_features=text), None


@pytest.mark.parametrize("kind", ["baseline_center", "uniprompt", "moe_dropout"])
def test_device_epoch_equals_the_step_loop_bit_for_bit(trees, kind):
    """From one state and one generator state, augmentation on: losses,
    accuracies, every parameter and buffer, the moments and the centers."""
    cfg, model, kwargs, centers = _setup(trees, kind)
    loss_fn, _ = make_loss(cfg, NC)
    stage = "baseline" if kind == "baseline_center" else "stage2a"
    images, pids, camids, trackids = _data()
    perm = _perm()
    lr = 1e-3
    runs = []
    for mode in ("epoch", "steps"):
        m = copy.deepcopy(model)
        opt = make_optimizer(cfg.SOLVER.STAGE2 if stage != "baseline" else cfg.SOLVER, m,
                             stage=stage)
        state = initial_state(m, opt, centers=None if centers is None else centers.clone())
        gen = torch.Generator().manual_seed(7)
        if mode == "epoch":
            epoch = make_train_epoch(m, cfg, loss_fn, opt, **kwargs)
            data = [torch.from_numpy(a) for a in (images, pids, camids, trackids)]
            state, (losses, accs) = epoch(state, *data, perm, lr, gen)
        else:
            step = make_train_step(m, cfg, loss_fn, opt, **kwargs)
            out = []
            for idx in perm:
                batch = {"images": images[idx], "pids": pids[idx], "camids": camids[idx],
                         "trackids": trackids[idx]}
                state, metrics = step(state, batch, lr, gen)
                out.append(metrics)
            losses = torch.stack([o["loss"] for o in out])
            accs = torch.stack([o["acc"] for o in out])
        runs.append((losses, accs, state, m))
    (l0, a0, s0, m0), (l1, a1, s1, m1) = runs
    assert torch.equal(l0, l1) and torch.equal(a0, a1) and len(l0) == len(perm)
    for (name, t0), t1 in zip(m0.state_dict().items(), m1.state_dict().values()):
        assert torch.equal(t0, t1), name
    assert s0.opt_state.step == s1.opt_state.step == len(perm)
    for key in ("mu", "nu"):
        for name, t in getattr(s0.opt_state, key).items():
            assert torch.equal(t, getattr(s1.opt_state, key)[name]), name
    if centers is not None:
        assert torch.equal(s0.centers, s1.centers) and not torch.equal(s0.centers, centers)


# ---------------------------------------------------------------------------
# against the JAX package's make_train_epoch
# ---------------------------------------------------------------------------

def test_device_epoch_matches_jax_make_train_epoch(trees):
    """Three PK batches, augmentation off, from the same weights: each
    batch's loss and accuracy, and every parameter after the epoch (an
    element whose gradient is within rounding of zero may step the other
    way: one element in 10⁴ of a leaf, and one in any, up to 2·lr·mult per
    step). The BN running statistics, taken from those weights in the later
    steps, to 1e-4 relative (1e-5 absolute near zero)."""
    jcfg, tcfg = _cfgs(trees, **{"INPUT.PROB": 0.0, "INPUT.PADDING": 0, "INPUT.RE_PROB": 0.0})
    clip = tiny_clip_config()
    jmodel = JaxReIDModel(clip_config=clip, num_classes=NC, camera_num=14, view_num=1)
    variables = _seeded(init_variables(jmodel, jax.random.PRNGKey(0), jcfg, abstract=True), 2)
    tmodel = ReIDModel(CLIPConfig(**dataclasses.asdict(clip)), NC, camera_num=14, view_num=1)
    tmodel.load_state_dict(from_jax_variables(variables, tmodel.clip_config), strict=True)
    images, pids, camids, trackids = _data()
    perm = _perm()
    lr = 1e-3

    jloss_fn, _ = jax_make_loss(jcfg, NC)
    jopt = jax_make_optimizer(jcfg.SOLVER, variables["params"], stage="baseline")
    jepoch = jsteps.make_train_epoch(jmodel, jcfg, jloss_fn, jopt)
    jstate, (jlosses, jaccs) = jepoch(
        jax_initial_state(variables, jopt), *(jnp.asarray(a) for a in (images, pids, camids,
                                                                        trackids)),
        jnp.asarray(perm), lr, jax.random.PRNGKey(0))

    loss_fn, _ = make_loss(tcfg, NC)
    opt = make_optimizer(tcfg.SOLVER, tmodel, stage="baseline")
    epoch = make_train_epoch(tmodel, tcfg, loss_fn, opt)
    _, (losses, accs) = epoch(initial_state(tmodel, opt),
                              *(torch.from_numpy(a) for a in (images, pids, camids, trackids)),
                              perm, lr, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(_np(losses), _np(jlosses), rtol=1e-4, atol=0)
    np.testing.assert_array_equal(_np(accs), _np(jaccs))
    ref = ReIDModel(tmodel.clip_config, NC, camera_num=14, view_num=1)
    ref.load_state_dict(from_jax_variables({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats},
                                           tmodel.clip_config), strict=True)
    want = ref.state_dict()
    for name, param in tmodel.named_parameters():
        unit = lr * opt.lr_mult.get(name, 1.0)
        err = np.abs(_np(param) - _np(want[name]))
        assert (err > 0.25 * len(perm) * unit).sum() <= max(1, err.size // 10_000), name
        assert float(err.max()) <= 2 * len(perm) * unit, (name, float(err.max()))
    for name in ("bottleneck.running_mean", "bottleneck.running_var"):
        np.testing.assert_allclose(_np(tmodel.state_dict()[name]), _np(want[name]), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------

def _train(cfg, epochs):
    tl, _, _, nq, ncls, ncam, nview = make_dataloader(cfg)
    model = make_model(cfg, ncls, ncam, nview)
    loss_fn, _ = make_loss(cfg, ncls)
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    state, history = do_train(cfg, model, tl, None, opt, lambda e: 3e-3, loss_fn, nq,
                              max_epochs=epochs)
    return state, history, tl


def test_do_train_with_device_dataset_learns(trees, tmp_path, caplog):
    """Three epochs over the resident train set: each of epoch 0's batch
    count, the loss falls, checkpoints as in the step loop."""
    _, cfg = _cfgs(trees, **{"TPU.DEVICE_DATASET": True, "OUTPUT_DIR": str(tmp_path),
                             "SOLVER.CHECKPOINT_PERIOD": 2})
    with caplog.at_level(logging.INFO):
        state, history, tl = _train(cfg, 3)
    n0 = len(epoch_perm(tl, 0, cfg.SOLVER.SEED))
    assert [h["epoch"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert history[-1]["loss"] < history[0]["loss"]
    assert state.opt_state.step == 3 * n0
    assert os.path.exists(tmp_path / "ViT-B-16_2.pth")
    assert not os.path.exists(tmp_path / "ViT-B-16_3.pth")
    assert "Device-resident dataset: 48 images, " in caplog.text
    assert "Epoch 3 done. Loss: " in caplog.text


@pytest.mark.parametrize("device_dataset", [False, True])
def test_profile_dir_writes_a_trace_and_leaves_the_results_unchanged(trees, tmp_path,
                                                                     device_dataset, caplog):
    """Step loop: steps 1..PROFILE_STEPS of epoch 1; device epoch: the whole
    second epoch. The trace is a Chrome trace of CPU operators; the history
    and every weight equal the run without it."""
    runs = []
    for profile_dir in ("", str(tmp_path / "trace")):
        _, cfg = _cfgs(trees, **{"TPU.DEVICE_DATASET": device_dataset,
                                 "TPU.PROFILE_DIR": profile_dir, "TPU.PROFILE_STEPS": 2})
        with caplog.at_level(logging.INFO):
            state, history, _ = _train(cfg, 2 if device_dataset else 1)
        runs.append((history, {k: v.clone() for k, v in state.model.state_dict().items()}))
    (h0, s0), (h1, s1) = runs
    assert h0 == h1
    assert all(torch.equal(v, s1[k]) for k, v in s0.items())
    path = tmp_path / "trace" / TRACE_FILE
    assert f"Wrote profiler trace to {path}" in caplog.text
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    # the device epoch traces whole steps: every one of its batches' optimizer steps
    assert ("aten::index_select" in names) == device_dataset
    # the port's spans ride in the trace (utils/tracing.py)
    assert names >= ({"train.epoch", "steps.train_epoch", "compiled.epoch", "compiled.replay"}
                     if device_dataset else
                     {"compiled.step", "compiled.warmup", "compiled.capture", "compiled.replay"})


def test_stage2_ignores_profile_dir(trees, tmp_path, caplog):
    """The JAX package's stage 2 never reads TPU.PROFILE_DIR: the port's
    logs that it does nothing there, traces nothing, and trains (it raised)."""
    _, cfg = _cfgs(trees, "mmmp", **{"TPU.PROFILE_DIR": str(tmp_path / "trace")})
    tl2, _, _, nq, ncls, ncam, nview = make_dataloader(cfg)
    model = make_model_uniprompt(cfg, ncls, ncam, nview)
    loss_fn, _ = make_loss(cfg, ncls)
    opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    with caplog.at_level(logging.INFO):
        _, history = do_train_stage2(cfg, model, tl2, None, opt, lambda e: 1e-3, loss_fn, nq,
                                     ncls, max_epochs=1)
    assert np.isfinite(history[0]["loss"])
    assert "TPU.PROFILE_DIR does nothing in stage 2" in caplog.text
    assert not (tmp_path / "trace").exists()
