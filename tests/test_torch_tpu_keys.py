"""Single-device TPU keys in the port (ROADMAP §C 1).

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

from tiny import tiny_cfg

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
