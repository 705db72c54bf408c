"""Package rules of the port (mpreid_tpu_torch): what it imports, where it
runs, what its config accepts, and how its kernel wrapper dispatches."""

import glob
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mpreid_tpu_torch
from mpreid_tpu.config import get_default_cfg as jax_default_cfg
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.ops import attention as tattn
from mpreid_tpu_torch.utils import device as tdevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(mpreid_tpu_torch.__path__, "mpreid_tpu_torch.")
)


def test_every_module_imports_without_jax_or_optional_packages():
    """Importing every module of the port pulls in no jax, flax or JAX-package
    module, and neither PyYAML, Pillow, regex nor ftfy (the card's machine
    may lack them)."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    banned = {m for m in loaded
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "mpreid_tpu", "yaml", "PIL",
                                     "regex", "ftfy")}
    assert not banned, sorted(banned)
    assert "mpreid_tpu_torch.test" in MODULES and "mpreid_tpu_torch.kernels.build" in MODULES
    assert {"mpreid_tpu_torch.train", "mpreid_tpu_torch.ops.adam", "mpreid_tpu_torch.losses.triplet",
            "mpreid_tpu_torch.ops.pairwise", "mpreid_tpu_torch.ops.reranking",
            "mpreid_tpu_torch.ops.reranking_sparse", "mpreid_tpu_torch.ops.matmul",
            "mpreid_tpu_torch.solver.optim", "mpreid_tpu_torch.solver.schedules",
            "mpreid_tpu_torch.utils.checkpoint", "mpreid_tpu_torch.engine.train_state",
            "mpreid_tpu_torch.train_uniprompt", "mpreid_tpu_torch.test_uniprompt",
            "mpreid_tpu_torch.models.tokenizer", "mpreid_tpu_torch.models.text",
            "mpreid_tpu_torch.models.uniprompt", "mpreid_tpu_torch.losses.supcon",
            "mpreid_tpu_torch.engine.uniprompt", "mpreid_tpu_torch.ops.batch_hard",
            "mpreid_tpu_torch.engine.ttpt", "mpreid_tpu_torch.losses.margin",
            "mpreid_tpu_torch.parallel", "mpreid_tpu_torch.parallel.dist",
            "mpreid_tpu_torch.parallel.collectives", "mpreid_tpu_torch.parallel.mesh",
            "mpreid_tpu_torch.parallel.zero", "mpreid_tpu_torch.parallel.sharded_eval",
            "mpreid_tpu_torch.parallel.launch"} <= set(MODULES)


def test_chip_smoke_imports_without_jax_and_builds_every_source():
    """chip_smoke.py pulls in no jax, flax or JAX-package module either, and
    the build list names every CUDA source of the port."""
    code = ("import json, sys\nimport chip_smoke\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert not {m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "flax", "mpreid_tpu")}
    from mpreid_tpu_torch.kernels import build

    sources = sorted(os.path.basename(p)[:-3] for p in glob.glob(str(build.CSRC / "*.cu")))
    assert sorted(build.SOURCES) == sources == ["adam", "attention_bwd", "attention_bwd_tc",
                                                 "attention_fwd", "attention_fwd_tc",
                                                 "batch_hard", "pairwise_cross"]


def test_chip_smoke_config_is_vit_base_yml():
    """The training slice of chip_smoke.py runs configs/person/vit_base.yml's
    settings (built in code so the script needs no yaml)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    want = get_default_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", "person", "vit_base.yml"))
    got = chip_smoke.vit_base_cfg()
    for section in ("MODEL", "INPUT", "DATALOADER", "SOLVER", "TEST"):
        g, w = dict(got[section]), dict(want[section])
        for key in ("DEVICE", "STAGE2"):  # the card on request; the baseline copies IMS_PER_BATCH
            g.pop(key, None)
            w.pop(key, None)
        assert g == w, section
    assert got.TPU.COMPUTE_DTYPE == "bfloat16" and got.SOLVER.STAGE2.IMS_PER_BATCH == 64


def test_chip_smoke_vehicle_config_is_veri_vit_base_yml():
    """The vehicle training phase of chip_smoke.py runs configs/veri/vit_base.yml's
    settings (built in code): ViT-B/16 at 256×256, so L 257."""
    sys.path.insert(0, REPO)
    import chip_smoke

    want = get_default_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", "veri", "vit_base.yml"))
    got = chip_smoke.vit_base_cfg(settings=chip_smoke.VERI)
    for section in ("MODEL", "INPUT", "DATALOADER", "SOLVER", "TEST", "DATASETS"):
        g, w = dict(got[section]), dict(want[section])
        for key in ("DEVICE", "STAGE2"):  # the card on request; the baseline copies IMS_PER_BATCH
            g.pop(key, None)
            w.pop(key, None)
        assert g == w, section
    h, w = got.INPUT.SIZE_TRAIN
    assert (h // 16) * (w // 16) + 1 == chip_smoke.VEHICLE["l"] == 257


def test_chip_smoke_uniprompt_config_is_cctv_ir_cctv_rgb_yml():
    """The Uni-Prompt slice of chip_smoke.py runs
    configs/ours/cctv_ir_cctv_rgb.yml's settings (built in code)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    want = get_default_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", "ours", "cctv_ir_cctv_rgb.yml"))
    got = chip_smoke.uniprompt_cfg()
    for section in ("MODEL", "INPUT", "DATALOADER", "SOLVER", "TEST", "DATASETS"):
        g, w = dict(got[section]), dict(want[section])
        g.pop("DEVICE", None)  # the card on request
        w.pop("DEVICE", None)
        assert g == w, section
    assert got.TPU.COMPUTE_DTYPE == "bfloat16" and not got.MODEL.MOE.ENABLED


def test_chip_smoke_tuned_config_is_uniprompt_tuned_yml():
    """The MoE phase of chip_smoke.py runs configs/ours/cctv_ir_cctv_rgb.yml
    under configs/tpu/uniprompt_tuned.yml (built in code), with bench.py's
    MoE: 4 experts, top-2, 2 MoE layers."""
    sys.path.insert(0, REPO)
    import chip_smoke

    want = get_default_cfg()
    for path in (("ours", "cctv_ir_cctv_rgb.yml"), ("tpu", "uniprompt_tuned.yml")):
        want.merge_from_file(os.path.join(REPO, "configs", *path))
    want.merge_from_list(["MODEL.MOE.ENABLED", "True", "MODEL.MOE.NUM_EXPERTS", "4",
                          "MODEL.MOE.TOP_K", "2", "MODEL.MOE.MOE_LAYERS", "2"])
    got = chip_smoke.tuned_cfg()
    for section in ("MODEL", "INPUT", "DATALOADER", "SOLVER", "TEST", "DATASETS", "TPU"):
        g, w = dict(got[section]), dict(want[section])
        g.pop("DEVICE", None)  # the card on request
        w.pop("DEVICE", None)
        assert g == w, section
    assert got.TPU.DEVICE_DATASET and got.SOLVER.STAGE2.MOMENT_DTYPE == "bfloat16"
    assert got.TEST.IMS_PER_BATCH == 128 and got.OUTPUT_DIR == ""


@pytest.mark.parametrize("attr,path,build", [
    ("CNN_BASE", ("person", "cnn_base.yml"), "vit_base_cfg"),
    ("CNN_CLIPREID", ("person", "cnn_clipreid.yml"), "uniprompt_cfg"),
    ("CNN_PROM", ("veri", "cnn_prom.yml"), "uniprompt_cfg"),
])
def test_chip_smoke_rn50_configs_are_their_files(attr, path, build):
    """The RN50 phases of chip_smoke.py run configs/person/cnn_base.yml,
    configs/person/cnn_clipreid.yml and configs/veri/cnn_prom.yml's settings
    (built in code), at the full RN50 width."""
    sys.path.insert(0, REPO)
    import chip_smoke

    want = get_default_cfg()
    want.merge_from_file(os.path.join(REPO, "configs", *path))
    got = getattr(chip_smoke, build)(settings=getattr(chip_smoke, attr))
    for section in ("MODEL", "INPUT", "DATALOADER", "SOLVER", "TEST", "DATASETS"):
        g, w = dict(got[section]), dict(want[section])
        for key in ("DEVICE", "STAGE2") if build == "vit_base_cfg" else ("DEVICE",):
            g.pop(key, None)
            w.pop(key, None)
        assert g == w, section
    assert got.MODEL.NAME == "RN50" and got.TPU.COMPUTE_DTYPE == "bfloat16"
    assert got.OUTPUT_DIR == "" and not got.MODEL.PRETRAIN_PATH


def test_chip_smoke_pairwise_bound_counts_instructions_not_flops():
    """B4's and B5's operations bound: two fp32 instructions an element pair
    at one a lane a clock (132 SMs × 128 lanes × 1.98 GHz ≈ 33.5 T/s), not at
    the FMA rate of 67 TFLOP/s: ≈ 61.7 ms at the Market-1501 dense shape and
    ≈ 47.0 ms at one MSMT17 block."""
    sys.path.insert(0, REPO)
    import chip_smoke

    n_market = chip_smoke.MARKET["q"] + chip_smoke.MARKET["g"]
    ms, by = chip_smoke.pairwise_bound_ms(chip_smoke.MARKET["q"], chip_smoke.MARKET["g"], n_market)
    assert by == "operations" and abs(ms - 61.7) < 0.1
    n_msmt = chip_smoke.MSMT["q"] + chip_smoke.MSMT["g"]
    ms, by = chip_smoke.pairwise_bound_ms(*chip_smoke.MSMT_BLOCK, n_msmt)
    assert by == "operations" and abs(ms - 47.0) < 0.1


@pytest.mark.parametrize("name", ["tpu", "gpu", "cuda", "TPU", "cuda:0"])
def test_card_devices_raise_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="MODEL.DEVICE cpu"):
        tdevice.resolve_device(name)


def test_cpu_device_is_explicit_and_unknown_raises():
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown device"):
        tdevice.resolve_device("npu")


def test_make_model_refuses_to_fall_back_to_cpu(monkeypatch):
    from mpreid_tpu_torch.models import make_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.MODEL.DEBUG_TINY = True
    assert cfg.MODEL.DEVICE == "tpu"
    with pytest.raises(RuntimeError, match="none is available"):
        make_model(cfg, 4, 2, 1)


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_cpu_tensor_takes_the_plain_path(layout):
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 9, 3 * 128)).astype(np.float32))
    before = tattn.fused_attention.launches
    got = tattn.fused_attention(qkv, 2, layout=layout)
    assert tattn.fused_attention.launches == before
    torch.testing.assert_close(got, tattn.attention_plain(qkv, 2, layout=layout),
                               atol=0, rtol=0)


def test_default_config_equals_jax_packages():
    assert dict(get_default_cfg()) == dict(jax_default_cfg())
    assert '"NAME": "resnet50"' in get_default_cfg().dump()


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yml"), recursive=True)),
    ids=lambda p: os.path.relpath(p, REPO),
)
def test_every_config_file_merges(path):
    cfg = get_default_cfg()
    cfg.merge_from_file(path)
    ref = jax_default_cfg()
    ref.merge_from_file(path)
    assert dict(cfg) == dict(ref)


def test_entry_point_refuses_an_orbax_directory(tmp_path):
    from mpreid_tpu_torch import test as entry

    with pytest.raises(ValueError, match="torch state_dicts only"):
        entry.main(["MODEL.DEVICE", "cpu", "TEST.WEIGHT", str(tmp_path / "ckpt_10")])
