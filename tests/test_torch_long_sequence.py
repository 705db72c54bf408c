"""The port at L 442 (256×256 at ``MODEL.STRIDE_SIZE [12, 12]``: 21 × 21
patches + the class token) against the JAX package.

Past the rows the bf16 kernels stage whole (384 at dh 64 in the backward)
the card streams the sequence in chunks; on the CPU the wrappers run the
plain versions, which the card holds the kernels to. Here those plain
versions, forward and backward, are held to the JAX package's
``fused_attention`` / ``fused_attention_hm`` run as its own tests run them
(the Pallas kernels in interpret mode; JAX's VJP for the backward), B 1,
2 heads × 64, both layouts: fp32 to 1e-5 (backward: · max(1, max |ref|)),
bf16 to 2e-2 (backward: 3e-2 · max(1, max |ref|), as the card's kernels).
Then the tiny tower of ``tests/test_torch_model.py`` at 256×256 and stride
12 (L 442) against the JAX tower, fp32 to 1e-4, and ``python -m
mpreid_tpu_torch.train`` taking ``MODEL.STRIDE_SIZE`` on its command line
over configs/veri/vit_base.yml, as the JAX package's ``train.py`` does.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.models.factory import init_variables
from mpreid_tpu.models.reid import ReIDModel as JaxReIDModel
from mpreid_tpu.ops import attention as jattn
from mpreid_tpu_torch.data.synthetic import make_market1501
from mpreid_tpu_torch.models import CLIPConfig, ReIDModel, from_jax_variables
from mpreid_tpu_torch.ops import attention as tattn
from mpreid_tpu_torch.utils.checkpoint import load_checkpoint

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)
from test_torch_model import _perturb
from tiny import tiny_clip_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS, DH, L = 2, 64, 442
D = HEADS * DH
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JAX_FN = {"packed": jattn.fused_attention, "head_major": jattn.fused_attention_hm}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_at_l442_matches_pallas_interpret(layout, dtype):
    rng = np.random.default_rng(442)
    qkv = rng.standard_normal((1, L, 3 * D)).astype(np.float32)
    do = rng.standard_normal((1, L, D)).astype(np.float32)
    jq, jdo = (jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in (qkv, do))
    tq, tdo = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (qkv, do))

    want, vjp = jax.vjp(lambda q: JAX_FN[layout](q, HEADS, None, force="interpret"), jq)
    got = tattn.fused_attention(tq, HEADS, layout=layout)
    assert got.shape == (1, L, D) and got.dtype == tq.dtype
    assert float(np.abs(_np(got) - _np(want)).max()) <= TOL[dtype]

    dwant = _np(vjp(jdo)[0])
    dgot = _np(tattn.fused_attention_bwd(tq, tdo, HEADS, layout=layout))
    bound = BWD_TOL[dtype] * max(1.0, float(np.abs(dwant).max()))
    assert float(np.abs(dgot - dwant).max()) <= bound


def test_stride12_tower_at_256x256_matches_jax():
    """The tiny tower (2 layers, 2 heads × 64) at 256×256 with stride 12:
    (256 − 16) // 12 + 1 = 21 patches a side, L 442, a conv patchify."""
    h = w = 256
    grid = (h - 16) // 12 + 1
    jcfg = tiny_clip_config(vision_width=128, vision_stride_size=12, h_resolution=grid,
                            w_resolution=grid, vision_layout="hm_native")
    kw = dict(num_classes=8, camera_num=14, view_num=1, sie_camera=False, sie_view=False,
              neck_feat="after")
    jmodel = JaxReIDModel(clip_config=jcfg, **kw)

    class _Cfg:  # init_variables reads only the train size
        class INPUT:
            SIZE_TRAIN = (h, w)

    variables = _perturb(init_variables(jmodel, jax.random.PRNGKey(0), _Cfg))
    tcfg = CLIPConfig(**dataclasses.asdict(jcfg))
    tmodel = ReIDModel(clip_config=tcfg, **kw).eval()
    tmodel.load_state_dict(from_jax_variables(variables, tcfg), strict=True)
    assert tmodel.image_encoder.positional_embedding.shape[0] == L

    x = np.random.default_rng(3).standard_normal((2, h, w, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x),
                        method=lambda m, x: m.image_encoder(x, None))
    with torch.no_grad():
        got = tmodel.image_encoder(torch.from_numpy(x))
    for g, wv in zip(got, want[:3]):
        assert tuple(g.shape) == wv.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-4, rtol=0)


def test_train_cli_takes_the_stride_on_its_command_line(tmp_path):
    """configs/veri/vit_base.yml with ``MODEL.STRIDE_SIZE [12, 12]`` on the
    command line (DEBUG_TINY, 64×64, so (64 − 16) // 12 + 1 = 5 patches a
    side, L 26; a synthetic Market-1501 tree): one epoch on the CPU, and the
    checkpoint's positions are the stride-12 grid's."""
    root = tmp_path / "m1501"
    make_market1501(str(root), n_ids=6, imgs_per_id=8)
    cmd = [sys.executable, "-m", "mpreid_tpu_torch.train",
           "--config_file", os.path.join(REPO, "configs", "veri", "vit_base.yml"),
           "MODEL.STRIDE_SIZE", "[12, 12]", "MODEL.DEVICE", "cpu", "MODEL.DEBUG_TINY", "True",
           "INPUT.SIZE_TRAIN", "[64,64]", "INPUT.SIZE_TEST", "[64,64]",
           "DATASETS.NAMES", "market1501", "DATASETS.ROOT_DIR", str(root),
           "SOLVER.IMS_PER_BATCH", "8", "TEST.IMS_PER_BATCH", "16", "SOLVER.MAX_EPOCHS", "1",
           "SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.EVAL_PERIOD", "1",
           "DATALOADER.NUM_WORKERS", "2", "OUTPUT_DIR", str(tmp_path)]
    out = subprocess.run(cmd, cwd=str(tmp_path), capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "Epoch 1 done" in out.stdout
    model = load_checkpoint(str(tmp_path / "ViT-B-16_1.pth"))["model"]
    assert model["image_encoder.positional_embedding"].shape[0] == 5 * 5 + 1
