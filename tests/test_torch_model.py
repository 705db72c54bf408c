"""The port's model (mpreid_tpu_torch/models) against the JAX package's.

Weights are the JAX package's own (its init, then perturbed from a numpy
seed so that biases, BN statistics and LoRA adapters are not trivial),
carried across with ``from_jax_variables``. The CLIP is tiny
(``tiny_clip_config(vision_width=128)``: 2 layers, 2 heads × 64) and runs
in fp32 on the CPU, held to atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.models.convert import export_reid_state_dict
from mpreid_tpu.models.factory import init_variables
from mpreid_tpu.models.reid import ReIDModel as JaxReIDModel
from mpreid_tpu_torch.models import CLIPConfig, ReIDModel, from_jax_variables

from tiny import tiny_clip_config

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

CAMS, VIEWS, CLASSES = 14, 1, 8
H, W = 64, 32  # 4 × 2 patches + the class token


def _perturb(variables, seed=0):
    rng = np.random.default_rng(seed)

    def params(x):
        x = np.asarray(x, np.float32)
        return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)

    def stats(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return 0.1 * rng.standard_normal(x.shape).astype(np.float32)

    out = {"params": jax.tree_util.tree_map(params, variables["params"])}
    out["batch_stats"] = jax.tree_util.tree_map_with_path(stats, variables["batch_stats"])
    return out


def _models(layout="", lora_rank=0, sie="none", neck_feat="after", stride=16):
    # token grid as in models/factory.py: (size - 16) // stride + 1
    jcfg = tiny_clip_config(vision_width=128, vision_stride_size=stride,
                            h_resolution=(H - 16) // stride + 1,
                            w_resolution=(W - 16) // stride + 1,
                            vision_layout=layout, lora_rank=lora_rank)
    kw = dict(num_classes=CLASSES, camera_num=CAMS, view_num=VIEWS,
              sie_camera=sie in ("camera", "camera+view"), sie_view=sie == "camera+view",
              neck_feat=neck_feat)
    jmodel = JaxReIDModel(clip_config=jcfg, **kw)

    class _Cfg:  # init_variables reads only the train size
        class INPUT:
            SIZE_TRAIN = (H, W)

    variables = _perturb(init_variables(jmodel, jax.random.PRNGKey(0), _Cfg))
    tcfg = CLIPConfig(**dataclasses.asdict(jcfg))
    # the port folds LoRA into in_proj; its model has no adapter of its own
    tmodel = ReIDModel(clip_config=dataclasses.replace(tcfg, lora_rank=0), **kw).eval()
    tmodel.load_state_dict(from_jax_variables(variables, tcfg), strict=True)
    return jmodel, variables, tmodel, tcfg


def _images(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal((n, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("layout", ["", "hm_native", "packed", "hm"])
@pytest.mark.parametrize("lora_rank", [0, 4])
def test_from_jax_variables_equals_export(layout, lora_rank):
    jmodel, variables, tmodel, tcfg = _models(layout, lora_rank, sie="camera")
    want = export_reid_state_dict(variables, jmodel)
    got = from_jax_variables(variables, tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
    # strict load of the reference export itself
    tmodel.load_state_dict(want, strict=True)
    assert sorted(tmodel.state_dict()) == sorted(want)


@pytest.mark.parametrize("layout,stride", [("hm_native", 16), ("packed", 16),
                                           ("hm_native", 12)])
def test_tower_matches_jax(layout, stride):
    """stride 16 patchifies by reshape + matmul; stride 12 overlaps (a conv)."""
    jmodel, variables, tmodel, _ = _models(layout, stride=stride)
    x = _images()
    want = jmodel.apply(variables, jnp.asarray(x),
                        method=lambda m, x: m.image_encoder(x, None))
    with torch.no_grad():
        got = tmodel.image_encoder(torch.from_numpy(x))
    for g, w in zip(got, want[:3]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("sie", ["none", "camera", "camera+view"])
@pytest.mark.parametrize("neck_feat", ["before", "after"])
def test_forward_eval_matches_jax(sie, neck_feat):
    jmodel, variables, tmodel, _ = _models(sie=sie, neck_feat=neck_feat)
    x = _images(4)
    rng = np.random.default_rng(2)
    cam = rng.integers(0, CAMS, 4).astype(np.int32) if sie != "none" else None
    view = np.zeros(4, np.int32) if sie == "camera+view" else None
    want = jmodel.apply(variables, jnp.asarray(x),
                        cam_label=None if cam is None else jnp.asarray(cam),
                        view_label=None if view is None else jnp.asarray(view), train=False)
    with torch.no_grad():
        got = tmodel.forward_eval(
            torch.from_numpy(x),
            None if cam is None else torch.from_numpy(cam),
            None if view is None else torch.from_numpy(view),
        )
    assert tuple(got.shape) == (4, 128 + 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_forward_eval_with_folded_lora_matches_jax():
    jmodel, variables, tmodel, _ = _models("hm_native", lora_rank=4)
    x = _images()
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tmodel.forward_eval(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_forward_eval_bf16_close_to_fp32():
    """bf16 compute (fp32 parameters) stays near the fp32 features."""
    _, variables, tmodel, tcfg = _models()
    t16 = ReIDModel(clip_config=tcfg, num_classes=CLASSES, camera_num=CAMS,
                    view_num=VIEWS, dtype=torch.bfloat16).eval()
    t16.load_state_dict(tmodel.state_dict(), strict=True)
    x = torch.from_numpy(_images())
    with torch.no_grad():
        f32 = tmodel.forward_eval(x)
        f16 = t16.forward_eval(x)
    assert f16.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(f16.float(), f32, dim=1)
    assert bool((cos > 0.99).all()), cos


def test_load_param_reads_reference_pth(tmp_path):
    """A reference .pth with DataParallel ``module.`` prefixes loads strictly."""
    from mpreid_tpu_torch.models import load_param

    jmodel, variables, tmodel, tcfg = _models(sie="camera")
    sd = {"module." + k: v for k, v in export_reid_state_dict(variables, jmodel).items()}
    path = tmp_path / "model.pth"
    torch.save(sd, path)
    fresh = ReIDModel(clip_config=tcfg, num_classes=CLASSES, camera_num=CAMS,
                      view_num=VIEWS, sie_camera=True).eval()
    load_param(str(path), fresh)
    for k, v in tmodel.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, atol=0, rtol=0)
