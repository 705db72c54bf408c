"""OpenAI CLIP weights from a local file (A.1) in the port, against the JAX
package: ``resize_pos_embed``, ``config_from_state_dict``, ``load_torch_clip``
and the graft into a model (``load_pretrained`` / ``graft_clip_weights``
against ``load_torch_clip`` + ``graft_clip_variables``), and the training
entry points with ``MODEL.PRETRAIN_PATH``.

The real ``ViT-B-16.pt`` / ``RN50.pt`` are not in the repository and nothing
is downloaded: each test writes a seeded OpenAI-layout file of a tiny CLIP
(``data/synthetic.py::make_clip_file``), with ``torch.save`` and as a
``torch.jit`` archive. Features are held at atol 1e-4 in fp32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.data.synthetic import make_market1501
from mpreid_tpu.models import clip_model as jclip
from mpreid_tpu.models.factory import graft_clip_variables, init_variables
from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUniPromptReID
from mpreid_tpu.models.vit import resize_pos_embed as jax_resize_pos_embed
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data.synthetic import make_clip_file
from mpreid_tpu_torch.models import (
    RN50, VIT_B16, UniPromptReID, config_from_state_dict, factory, graft_clip_weights,
    load_pretrained, load_torch_clip,
)
from mpreid_tpu_torch.models.clip_model import read_clip_file
from mpreid_tpu_torch.models.vit import resize_pos_embed

from tiny import tiny_cfg

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 6
HW = (64, 32)  # (h, w) token grid (4, 2): the file's square grid is resized
TEXT = dict(embed_dim=32, transformer_width=64, transformer_heads=1, transformer_layers=2)
TINY = {
    "vit": dataclasses.replace(VIT_B16, vision_layers=2, vision_width=64, **TEXT),
    "rn50": dataclasses.replace(RN50, vision_layers=(1, 1, 1, 1), vision_width=8, **TEXT),
}
FILE_GRID = 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("old,new", [(14, (16, 8)), (14, (16, 16)), (7, (16, 8)), (7, (16, 16)),
                                     (3, (4, 2))])
def test_resize_pos_embed_matches_jax(old, new):
    """14×14+1 (ViT-B/16 at 224) and 7×7+1 (the RN50 pool) to the 256×128
    and 256×256 grids."""
    posemb = np.random.default_rng(old).standard_normal((old * old + 1, 16)).astype(np.float32)
    got = resize_pos_embed(torch.from_numpy(posemb), *new)
    want = jax_resize_pos_embed(jnp.asarray(posemb), *new)
    assert got.dtype == torch.float32 and tuple(got.shape) == (new[0] * new[1] + 1, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_np(got[0]), posemb[0])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(arch, jit): path} of seeded tiny OpenAI-layout CLIP files."""
    root = tmp_path_factory.mktemp("clip")
    return {(arch, jit): make_clip_file(str(root / f"{arch}_{int(jit)}.pt"), TINY[arch],
                                        FILE_GRID, seed=3, jit=jit)
            for arch in TINY for jit in (False, True)}


def _grid():
    return (HW[0] - 16) // 16 + 1, (HW[1] - 16) // 16 + 1


@pytest.mark.parametrize("arch", list(TINY))
def test_config_from_state_dict_matches_jax(files, arch):
    sd = read_clip_file(files[arch, False])
    got = config_from_state_dict(sd, *_grid(), 16)
    want = jclip.config_from_state_dict(sd, *_grid(), 16)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        dataclasses.replace(TINY[arch], h_resolution=_grid()[0], w_resolution=_grid()[1]))


@pytest.mark.parametrize("arch", list(TINY))
def test_the_archive_and_the_plain_file_hold_the_same_weights(files, arch):
    """``torch.jit.load`` takes the archive; the plain file falls back to
    ``torch.load``; both give the same fp32 tensors, the meta entries dropped."""
    _, plain = load_torch_clip(files[arch, False], *_grid(), 16)
    _, archive = load_torch_clip(files[arch, True], *_grid(), 16)
    assert plain.keys() == archive.keys()
    assert all(k.split(".")[0] in ("image_encoder", "text_encoder") for k in plain)
    for k, v in plain.items():
        assert torch.equal(v, archive[k]) and (v.dtype == torch.float32 or "num_batches" in k)


def test_an_fp16_archive_loads_as_fp32(tmp_path):
    """OpenAI's archives hold fp16: the loader casts every weight to fp32."""
    path = make_clip_file(str(tmp_path / "half.pt"), TINY["rn50"], FILE_GRID, seed=3, jit=True,
                          half=True)
    full = read_clip_file(make_clip_file(str(tmp_path / "full.pt"), TINY["rn50"], FILE_GRID,
                                         seed=3))
    got = read_clip_file(path)
    assert got.keys() == full.keys()
    for k, v in got.items():
        if v.is_floating_point():
            assert v.dtype == torch.float32 and torch.equal(v, full[k].half().float()), k


@pytest.fixture(scope="module")
def jax_models():
    """{arch: (JAX Uni-Prompt model, its initialised variables, config)}."""
    out = {}
    for arch, clip in TINY.items():
        jcfg = tiny_cfg(**{"INPUT.SIZE_TRAIN": list(HW), "INPUT.SIZE_TEST": list(HW),
                           "TEST.NECK_FEAT": "before",
                           "MODEL.NAME": "ViT-B-16" if arch == "vit" else "RN50"})
        jc = jclip.CLIPConfig(**dataclasses.asdict(
            dataclasses.replace(clip, h_resolution=_grid()[0], w_resolution=_grid()[1])))
        model = JaxUniPromptReID(clip_config=jc, num_classes=NC, camera_num=14, view_num=1,
                                 neck_feat="before")
        out[arch] = model, init_variables(model, jax.random.PRNGKey(0), jcfg), jcfg
    return out


def _port_model(arch, jcfg):
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    tcfg.MODEL.DEVICE = "cpu"
    clip = dataclasses.replace(TINY[arch], h_resolution=_grid()[0], w_resolution=_grid()[1])
    model = UniPromptReID(clip, NC, camera_num=14, view_num=1, neck_feat="before")
    model.init_(torch.Generator().manual_seed(5))
    return tcfg, model.eval()


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("arch", list(TINY))
def test_loaded_towers_match_jax(files, jax_models, arch, jit):
    """The file through ``load_pretrained`` in the port and through
    ``load_torch_clip`` + ``graft_clip_variables`` in JAX: eval features
    (``neck_feat='before'``: the towers alone), the projected tokens and the
    text tower's features agree; the heads the graft does not touch keep
    their values."""
    jmodel, variables, jcfg = jax_models[arch]
    _, clip_vars = jclip.load_torch_clip(files[arch, jit], *_grid(), 16)
    jvars = graft_clip_variables(variables, clip_vars)
    tcfg, model = _port_model(arch, jcfg)
    heads = {k: v.clone() for k, v in model.state_dict().items()
             if k.split(".")[0] not in ("image_encoder", "text_encoder")}
    before = model.forward_eval(torch.zeros(1, *HW, 3))
    tcfg.MODEL.PRETRAIN_PATH = files[arch, jit]
    load_pretrained(model, tcfg)
    for k, v in heads.items():
        assert torch.equal(model.state_dict()[k], v), k

    x = np.random.default_rng(1).standard_normal((3, *HW, 3)).astype(np.float32)
    got = model.forward_eval(torch.from_numpy(x))
    want = jmodel.apply(jvars, jnp.asarray(x), train=False)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    assert not torch.allclose(model.forward_eval(torch.zeros(1, *HW, 3)), before)
    for g, w in zip(model.get_more_image(torch.from_numpy(x)),
                    jmodel.apply(jvars, jnp.asarray(x), method=JaxUniPromptReID.get_more_image)):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=0)

    tokens = np.asarray([[49406, 320, 1125, 539, 320, 2533, 269, 49407] + [0] * 69,
                         [49406, 2533, 49407] + [0] * 74], np.int32)
    got = model.text_encoder.encode_tokens(torch.from_numpy(tokens).long())
    want = jmodel.apply(jvars, jnp.asarray(tokens),
                        method=lambda m, t: m.text_encoder.encode_tokens(t))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


def test_a_file_of_the_other_architecture_is_refused(files):
    """An RN50 file does not graft into a ViT model: the error names the tower."""
    _, model = _port_model("vit", tiny_cfg())
    _, clip_sd = load_torch_clip(files["rn50", False], *_grid(), 16)
    with pytest.raises(ValueError, match="image_encoder"):
        graft_clip_weights(model, clip_sd)


@pytest.mark.parametrize("path,error", [
    ("", "MODEL.PRETRAIN_PATH"),
    ("wide", r"'vision_width': \(16, 8\)"),
    ("deep", r"'vision_layers': \(\(1, 1, 2, 1\), \(1, 1, 1, 1\)\)"),
])
def test_load_pretrained_refuses_no_file_and_another_architecture(tmp_path, path, error):
    """No ``MODEL.PRETRAIN_PATH``, or a file whose RN50 is wider or deeper
    than the model's: ``load_pretrained`` raises, naming the key or the
    fields that differ (file, model), and leaves the model as it was."""
    _, model = _port_model("rn50", tiny_cfg())
    cfg = get_default_cfg()
    if path:
        other = dict(wide=dict(vision_width=16), deep=dict(vision_layers=(1, 1, 2, 1)))[path]
        cfg.MODEL.PRETRAIN_PATH = make_clip_file(
            str(tmp_path / "other.pt"), dataclasses.replace(TINY["rn50"], **other), FILE_GRID,
            seed=3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=error):
        load_pretrained(model, cfg)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_pretrain_auto_without_a_path_raises_and_names_the_path_key():
    cfg = get_default_cfg()
    cfg.MODEL.PRETRAIN_AUTO = True
    with pytest.raises(NotImplementedError, match="MODEL.PRETRAIN_PATH"):
        factory.pretrain_path(cfg)
    cfg.MODEL.PRETRAIN_PATH = "RN50.pt"
    assert factory.pretrain_path(cfg) == "RN50.pt"


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = tmp_path_factory.mktemp("market")
    make_market1501(str(root), n_ids=6, imgs_per_id=8, size=HW)
    return str(root)


@pytest.mark.parametrize("entry,config", [("train", "cnn_base.yml"),
                                          ("train_uniprompt", "cnn_clipreid.yml")])
def test_rn50_training_entries_load_a_clip_file_on_the_cpu(files, market, tmp_path,
                                                           monkeypatch, entry, config):
    """``python -m mpreid_tpu_torch.{train,train_uniprompt}`` with the RN50
    configs and ``MODEL.PRETRAIN_PATH``, one epoch of each stage on the CPU,
    with the RN50 base shrunk to the tiny tower of the file (the configs'
    widths are the full RN50's)."""
    import importlib

    monkeypatch.setitem(factory._BASE_CONFIGS, "RN50", TINY["rn50"])
    module = importlib.import_module(f"mpreid_tpu_torch.{entry}")
    grafted = []
    real = module.load_pretrained
    monkeypatch.setattr(module, "load_pretrained",
                        lambda model, cfg: grafted.append(cfg.MODEL.PRETRAIN_PATH)
                        or real(model, cfg))
    args = ["--config_file", os.path.join(REPO, "configs", "person", config),
            "MODEL.DEVICE", "cpu", "MODEL.PRETRAIN_PATH", files["rn50", True],
            "INPUT.SIZE_TRAIN", str(list(HW)), "INPUT.SIZE_TEST", str(list(HW)),
            "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", "2",
            "TEST.IMS_PER_BATCH", "16", "DATASETS.ROOT_DIR", market, "OUTPUT_DIR", str(tmp_path)]
    if entry == "train":
        args += ["SOLVER.IMS_PER_BATCH", "8", "SOLVER.MAX_EPOCHS", "1", "SOLVER.EVAL_PERIOD", "1",
                 "SOLVER.CHECKPOINT_PERIOD", "1"]
    else:
        args += ["SOLVER.STAGE1A.MAX_EPOCHS", "1", "SOLVER.STAGE1B.MAX_EPOCHS", "1",
                 "SOLVER.STAGE2.MAX_EPOCHS", "1", "SOLVER.STAGE1A.IMS_PER_BATCH", "16",
                 "SOLVER.STAGE1B.IMS_PER_BATCH", "16", "SOLVER.STAGE2.IMS_PER_BATCH", "8",
                 "SOLVER.STAGE2.CHECKPOINT_PERIOD", "1"]
    result = module.main(args)
    assert grafted == [files["rn50", True]]
    if entry == "train":
        _, history = result
        assert len(history) == 1 and np.isfinite(history[0]["loss"])
        assert os.path.exists(tmp_path / "RN50_1.pth")
    else:
        rank1, rank5 = result
        assert 0.0 <= rank1 <= rank5 <= 1.0
