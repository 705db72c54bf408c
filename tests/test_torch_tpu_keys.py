"""The TPU keys in the port: no-ops on one device, acting over two ranks.

The JAX package acts on ``TPU.EVAL_SHARDED``, ``TPU.ZERO_OPT_STATE`` and
``TPU.TP_TOWERS`` only over a mesh of more than one device
(mpreid_tpu/engine/processor.py:69, :187; engine/uniprompt.py:192), so on
one device they are no-ops. The port treats them the same way in
``run_validation``, ``do_train`` and ``do_train_stage2``: each key on gives
the results of it off, and a log line says it does nothing.
``TPU.DEVICE_DATASET`` (the device-resident epoch) and ``TPU.PROFILE_DIR``
(a trace; stage 2 ignores it, as the JAX package's does) run, and in stage
2 each gives the results of it off, so ``configs/tpu/uniprompt_tuned.yml``
runs to its end, dense and with the MoE tower.

Over two gloo ranks on the CPU (one job for the module,
``parallel.launch.spawn``) the keys act as in the JAX package's mesh
branch: ``do_train`` trains data parallel (each rank its block of every
global batch) and ends where the single-process run ends (SGD; parameters
to 1e-4 relative, 1e-6 absolute); ``TPU.ZERO_OPT_STATE`` shards the moments
(1-D slices) and gives the replicated run's weights bit for bit, in
``do_train`` and ``do_train_stage2``; ``TPU.EVAL_SHARDED`` takes the
gallery-sharded metrics, equal to the dense ones; ``TPU.TP_TOWERS`` logs
that it does nothing with a model axis of 1; rank 0 alone logs and writes
the checkpoint, whose moments are whole.
"""

import logging
import os

import numpy as np
import pytest
import torch

from mpreid_tpu.data.synthetic import make_market1501, make_mmmp
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import make_dataloader
from mpreid_tpu_torch.engine import do_train, do_train_stage2, run_validation
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import make_model, make_model_uniprompt
from mpreid_tpu_torch.solver import make_optimizer

from mpreid_tpu_torch.parallel.launch import spawn
from tiny import tiny_cfg

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOOPS = ("EVAL_SHARDED", "ZERO_OPT_STATE", "TP_TOWERS")


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = tmp_path_factory.mktemp("m1501_keys")
    make_market1501(str(root), n_ids=6, imgs_per_id=8)
    return str(root)


@pytest.fixture(scope="module")
def mmmp(tmp_path_factory):
    root = tmp_path_factory.mktemp("mmmp_keys")
    make_mmmp(str(root))
    return str(root)


def _cfg(root, names="market1501", **tpu):
    cfg = get_default_cfg()
    cfg.merge_from_other_cfg(tiny_cfg())
    cfg.MODEL.DEVICE = "cpu"
    cfg.MODEL.DEBUG_TINY = True
    cfg.DATASETS.NAMES = names
    cfg.DATASETS.ROOT_DIR = root
    cfg.DATASETS.EXP_SETTING = "exp_cctv_ir_cctv_rgb"
    cfg.OUTPUT_DIR = ""
    cfg.SOLVER.EVAL_PERIOD = 100
    cfg.SOLVER.STAGE2.EVAL_PERIOD = 100
    for key, value in tpu.items():
        cfg.TPU[key] = value
    return cfg


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("key", [None, "EVAL_SHARDED"])
def test_run_validation_with_eval_sharded_equals_it_off(market, key, caplog):
    results = []
    for value in (False, True):
        cfg = _cfg(market, **({key: value} if key else {}))
        _, _, val, nq, ncls, ncam, nview = make_dataloader(cfg)
        model = make_model(cfg, ncls, ncam, nview)
        with caplog.at_level(logging.INFO):
            results.append(run_validation(cfg, model, val, nq, logging.getLogger("keys")))
    (cmc0, map0), (cmc1, map1) = results
    np.testing.assert_array_equal(cmc0, cmc1)
    assert map0 == map1
    assert ("TPU.EVAL_SHARDED does nothing on one device" in caplog.text) == bool(key)


@pytest.mark.parametrize("key", NOOPS)
def test_do_train_with_a_single_device_key_equals_it_off(market, key, caplog):
    """One epoch from the same seed: the same history and the same weights."""
    runs = []
    for value in (False, True):
        cfg = _cfg(market, **{key: value})
        tl, _, val, nq, ncls, ncam, nview = make_dataloader(cfg)
        model = make_model(cfg, ncls, ncam, nview)
        loss_fn, _ = make_loss(cfg, ncls)
        opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
        with caplog.at_level(logging.INFO):
            _, history = do_train(cfg, model, tl, None, opt, lambda e: 1e-3, loss_fn, nq,
                                  max_epochs=1)
        runs.append((history, _state(model)))
    (h0, s0), (h1, s1) = runs
    assert h0 == h1
    assert all(torch.equal(v, s1[k]) for k, v in s0.items())
    if key != "EVAL_SHARDED":
        assert f"TPU.{key} does nothing on one device" in caplog.text


@pytest.mark.parametrize("key", NOOPS)
def test_do_train_stage2_with_a_single_device_key_equals_it_off(mmmp, key):
    runs = []
    for value in (False, True):
        cfg = _cfg(mmmp, "mmmp", **{key: value})
        cfg.SOLVER.STAGE2.IMS_PER_BATCH = 8
        tl2, _, val, nq, ncls, ncam, nview = make_dataloader(cfg)
        model = make_model_uniprompt(cfg, ncls, ncam, nview)
        loss_fn, _ = make_loss(cfg, ncls)
        opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
        _, history = do_train_stage2(cfg, model, tl2, None, opt, lambda e: 1e-3, loss_fn, nq,
                                     ncls, max_epochs=1)
        runs.append((history, _state(model)))
    (h0, s0), (h1, s1) = runs
    assert h0 == h1
    assert all(torch.equal(v, s1[k]) for k, v in s0.items())


@pytest.mark.parametrize("key,value", [("DEVICE_DATASET", True), ("PROFILE_DIR", "trace")])
def test_the_unported_keys_still_raise(mmmp, key, value, tmp_path):
    """The two keys that raised until the device epoch was ported: one
    stage-2 epoch with each on gives the history and the weights of the run
    with it off (the sampler's epoch 1 has epoch 0's batch count, so the
    device epoch sees the step loop's batches); PROFILE_DIR writes nothing."""
    trace = str(tmp_path / "trace")
    on_off = (trace, "") if key == "PROFILE_DIR" else (value, False)
    runs = []
    for setting in reversed(on_off):
        cfg = _cfg(mmmp, "mmmp", **{key: setting})
        cfg.SOLVER.STAGE2.IMS_PER_BATCH = 8
        tl2, _, val, nq, ncls, ncam, nview = make_dataloader(cfg)
        model = make_model_uniprompt(cfg, ncls, ncam, nview)
        loss_fn, _ = make_loss(cfg, ncls)
        opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
        _, history = do_train_stage2(cfg, model, tl2, None, opt, lambda e: 1e-3, loss_fn, nq,
                                     ncls, max_epochs=1)
        runs.append((history, _state(model)))
    (h0, s0), (h1, s1) = runs
    assert h0 == h1
    assert all(torch.equal(v, s1[k]) for k, v in s0.items())
    assert not os.path.exists(trace)


TINY_ARGS = ["MODEL.DEVICE", "cpu", "MODEL.DEBUG_TINY", "True",
             "INPUT.SIZE_TRAIN", "[32,16]", "INPUT.SIZE_TEST", "[32,16]",
             "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", "2",
             "TEST.IMS_PER_BATCH", "16", "SOLVER.STAGE1A.MAX_EPOCHS", "1",
             "SOLVER.STAGE1B.MAX_EPOCHS", "1", "SOLVER.STAGE2.MAX_EPOCHS", "1",
             "SOLVER.STAGE1A.IMS_PER_BATCH", "16", "SOLVER.STAGE1B.IMS_PER_BATCH", "16",
             "SOLVER.STAGE2.IMS_PER_BATCH", "8"]


@pytest.mark.parametrize("device_dataset,moe", [pytest.param(True, False, id="True"),
                                                pytest.param(False, False, id="False"),
                                                pytest.param(True, True, id="True-moe")])
def test_the_tuned_tpu_config_fails_only_on_device_dataset(mmmp, device_dataset, moe):
    """configs/tpu/uniprompt_tuned.yml sets DEVICE_DATASET, EVAL_SHARDED and
    ZERO_OPT_STATE: it runs to its end on one device with DEVICE_DATASET on
    (which raised before it was ported) and off, and with the MoE tower of
    the JAX package's bench (4 experts, top-2, 2 MoE layers)."""
    from mpreid_tpu_torch import train_uniprompt

    args = ["--config_file", os.path.join(REPO, "configs", "tpu", "uniprompt_tuned.yml"),
            *TINY_ARGS, "DATASETS.NAMES", "mmmp", "DATASETS.ROOT_DIR", mmmp,
            "DATASETS.EXP_SETTING", "exp_cctv_ir_cctv_rgb", "OUTPUT_DIR", "",
            "TPU.DEVICE_DATASET", str(device_dataset)]
    if moe:
        args += ["MODEL.MOE.ENABLED", "True", "MODEL.MOE.NUM_EXPERTS", "4",
                 "MODEL.MOE.TOP_K", "2", "MODEL.MOE.MOE_LAYERS", "2"]
    rank1, rank5 = train_uniprompt.main(args)
    assert 0.0 <= rank1 <= rank5 <= 1.0


# ---------------------------------------------------------------------------
# two ranks: the keys act
# ---------------------------------------------------------------------------

WORLD2 = 2


def _record_logs():
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.levelno, record.getMessage()))

    root = logging.getLogger("mpreid_tpu_torch")
    root.setLevel(logging.INFO)
    root.addHandler(Keep())
    return records


def _train_run(cfg, epochs=2):
    tl, _, val, nq, ncls, ncam, nview = make_dataloader(cfg)
    model = make_model(cfg, ncls, ncam, nview)
    loss_fn, _ = make_loss(cfg, ncls)
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    state, history = do_train(cfg, model, tl, None, opt, lambda e: 1e-3, loss_fn, nq,
                              max_epochs=epochs)
    return history, _state(model), {k: tuple(v.shape) for k, v in state.opt_state.mu.items()}


def _stage2_run(cfg):
    tl2, _, val, nq, ncls, ncam, nview = make_dataloader(cfg)
    model = make_model_uniprompt(cfg, ncls, ncam, nview)
    loss_fn, _ = make_loss(cfg, ncls)
    opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    _, history = do_train_stage2(cfg, model, tl2, None, opt, lambda e: 1e-3, loss_fn, nq, ncls,
                                 max_epochs=1)
    return history, _state(model)


def _validation_run(cfg, sharded_calls):
    _, _, val, nq, ncls, ncam, nview = make_dataloader(cfg)
    model = make_model(cfg, ncls, ncam, nview)
    before = len(sharded_calls)
    cmc, mAP = run_validation(cfg, model, val, nq, logging.getLogger("mpreid_tpu_torch.keys"))
    return cmc, mAP, len(sharded_calls) > before


def _two_rank_job(cfgs):
    from mpreid_tpu_torch.engine import processor

    records = _record_logs()
    calls = []
    sharded = processor.sharded_gallery_metrics

    def spy(evaluator, mesh=None):
        calls.append(1)
        return sharded(evaluator, mesh)

    processor.sharded_gallery_metrics = spy
    out = {name: _train_run(cfg) for name, cfg in cfgs["train"].items()}
    out.update({name: _stage2_run(cfg) for name, cfg in cfgs["stage2"].items()})
    out.update({name: _validation_run(cfg, calls) for name, cfg in cfgs["eval"].items()})
    out["logs"] = records
    return out


@pytest.fixture(scope="module")
def two_ranks(market, mmmp, tmp_path_factory):
    def train(**tpu):
        cfg = _cfg(market, **tpu)
        cfg.SOLVER.OPTIMIZER_NAME = "SGD" if tpu.get("ZERO_OPT_STATE") is None else "Adam"
        return cfg

    ckpt = train(ZERO_OPT_STATE=True)
    ckpt.OUTPUT_DIR = str(tmp_path_factory.mktemp("ckpt"))
    ckpt.SOLVER.CHECKPOINT_PERIOD = 2

    def stage2(**tpu):
        cfg = _cfg(mmmp, "mmmp", **tpu)
        cfg.SOLVER.STAGE2.IMS_PER_BATCH = 8
        return cfg

    cfgs = {"train": {"dp": train(), "tp_towers": train(TP_TOWERS=True),
                      "zero_off": train(ZERO_OPT_STATE=False),
                      "zero_on": train(ZERO_OPT_STATE=True), "checkpoint": ckpt},
            "stage2": {"s2_zero_off": stage2(ZERO_OPT_STATE=False),
                       "s2_zero_on": stage2(ZERO_OPT_STATE=True)},
            "eval": {"dense": _cfg(market, EVAL_SHARDED=False),
                     "sharded": _cfg(market, EVAL_SHARDED=True)}}
    return cfgs, spawn(_two_rank_job, WORLD2, (cfgs,), timeout=300, threads=2)


def test_two_ranks_train_as_one_process(two_ranks):
    cfgs, ranks = two_ranks
    history, state, _ = _train_run(cfgs["train"]["dp"])
    for out in ranks:
        got_history, got_state, _ = out["dp"]
        for got, want in zip(got_history, history):
            assert got["epoch"] == want["epoch"]
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for k, v in state.items():
            np.testing.assert_allclose(got_state[k].float().numpy(), v.float().numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    assert all(torch.equal(v, ranks[1]["dp"][1][k]) for k, v in ranks[0]["dp"][1].items())


def test_zero_opt_state_acts_over_two_ranks(two_ranks):
    _, ranks = two_ranks
    for out in ranks:
        (h0, s0, shapes0), (h1, s1, shapes1) = out["zero_off"], out["zero_on"]
        assert h0 == h1
        assert all(torch.equal(v, s1[k]) for k, v in s0.items())
        sliced = [k for k, shape in shapes1.items() if shape != shapes0[k]]
        assert sliced and all(len(shapes1[k]) == 1 for k in sliced)
        (h0, s0), (h1, s1) = out["s2_zero_off"], out["s2_zero_on"]
        assert h0 == h1
        assert all(torch.equal(v, s1[k]) for k, v in s0.items())


def test_eval_sharded_acts_over_two_ranks(two_ranks):
    _, ranks = two_ranks
    for out in ranks:
        (cmc0, map0, took0), (cmc1, map1, took1) = out["dense"], out["sharded"]
        assert (took0, took1) == (False, True)
        np.testing.assert_array_equal(cmc0[:len(cmc1)], cmc1[:len(cmc0)])
        assert abs(map0 - map1) <= 1e-6


def test_tp_towers_does_nothing_with_a_model_axis_of_one(two_ranks):
    _, ranks = two_ranks
    for out in ranks:
        assert out["tp_towers"][0] == out["dp"][0]
        assert all(torch.equal(v, out["dp"][1][k]) for k, v in out["tp_towers"][1].items())
    messages = [m for _, m in ranks[0]["logs"]]
    assert "TPU.TP_TOWERS does nothing with a model axis of 1" in messages
    assert any(m.startswith("Training over mesh {'data': 2, 'model': 1}") for m in messages)
    assert "ZeRO-1: optimizer moments sharded over 'data'" in messages


def test_rank_zero_alone_logs_and_writes_whole_moments(two_ranks):
    from mpreid_tpu_torch.utils.checkpoint import load_checkpoint

    cfgs, ranks = two_ranks
    assert not [m for level, m in ranks[1]["logs"] if level < logging.WARNING]
    assert any("Epoch 2 done" in m for _, m in ranks[0]["logs"])
    out_dir = cfgs["train"]["checkpoint"].OUTPUT_DIR
    assert sorted(os.listdir(out_dir)) == ["ViT-B-16_2.pth"]
    payload = load_checkpoint(os.path.join(out_dir, "ViT-B-16_2.pth"))
    shapes = ranks[0]["checkpoint"][1]
    for k, m in payload["opt_state"]["mu"].items():
        assert tuple(m.shape) == tuple(shapes[k].shape), k
