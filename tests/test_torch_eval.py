"""The port's eval path (distmat, CMC/mAP, evaluator, loader, the whole
``do_inference`` slice, with and without re-ranking) against the JAX
package's.

Features come from a numpy seed and are tie-free, so both stable sorts give
one ranking: CMC must be equal exactly and mAP to 1e-6. The whole slice runs
one synthetic Market-1501 tree through both packages with
``MODEL.DEBUG_TINY`` in fp32 on the CPU, the port carrying the JAX
package's weights across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.data import make_dataloader as jax_make_dataloader
from mpreid_tpu.data.synthetic import make_market1501
from mpreid_tpu.engine import R1mAPEvaluator as JaxEvaluator
from mpreid_tpu.engine import do_inference as jax_do_inference
from mpreid_tpu.engine import run_validation as jax_run_validation
from mpreid_tpu.models import init_variables, make_model as jax_make_model
from mpreid_tpu.ops import cmc_map as jax_cmc_map
from mpreid_tpu.ops import cosine_distmat as jax_cosine
from mpreid_tpu.ops import euclidean_squared_distmat as jax_euclid
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import make_dataloader
from mpreid_tpu_torch.engine import R1mAPEvaluator, do_inference, run_validation
from mpreid_tpu_torch.models import from_jax_variables, make_model
from mpreid_tpu_torch.ops import cmc_map, cosine_distmat, euclidean_squared_distmat

from tiny import tiny_cfg

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)


def _feats(nq=12, ng=30, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    qf = rng.standard_normal((nq, dim)).astype(np.float32)
    gf = rng.standard_normal((ng, dim)).astype(np.float32)
    q_pids = rng.integers(0, 5, nq).astype(np.int32)
    g_pids = rng.integers(0, 5, ng).astype(np.int32)
    q_cams = rng.integers(0, 3, nq).astype(np.int32)
    g_cams = rng.integers(0, 3, ng).astype(np.int32)
    return qf, gf, q_pids, g_pids, q_cams, g_cams


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_distmat_matches_jax(metric):
    qf, gf, *_ = _feats()
    jfn, tfn = ((jax_euclid, euclidean_squared_distmat) if metric == "euclidean"
                else (jax_cosine, cosine_distmat))
    want = np.asarray(jfn(jnp.asarray(qf), jnp.asarray(gf)))
    got = tfn(torch.from_numpy(qf), torch.from_numpy(gf)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("camera_filter", [False, True])
@pytest.mark.parametrize("max_rank", [5, 50])
@pytest.mark.parametrize("seed", [0, 1])
def test_cmc_map_matches_jax(camera_filter, max_rank, seed):
    qf, gf, qp, gp, qc, gc = _feats(seed=seed)
    dist = np.array(jax_euclid(jnp.asarray(qf), jnp.asarray(gf)))
    assert all(len(np.unique(r)) == len(r) for r in dist)  # tie-free rows
    jcmc, jmap = jax_cmc_map(jnp.asarray(dist), jnp.asarray(qp), jnp.asarray(gp),
                             jnp.asarray(qc), jnp.asarray(gc), max_rank=max_rank,
                             camera_filter=camera_filter)
    t = torch.from_numpy
    cmc, mAP = cmc_map(t(dist), t(qp), t(gp), t(qc), t(gc), max_rank=max_rank,
                       camera_filter=camera_filter)
    np.testing.assert_array_equal(cmc.numpy(), np.asarray(jcmc))
    assert abs(float(mAP) - float(jmap)) <= 1e-6


@pytest.mark.parametrize("feat_norm", [True, False])
@pytest.mark.parametrize("dist_metric", ["euclidean", "cosine"])
def test_evaluator_matches_jax(feat_norm, dist_metric):
    qf, gf, qp, gp, qc, gc = _feats(seed=3)
    feats = np.concatenate([qf, gf])
    pids, cams = np.concatenate([qp, gp]), np.concatenate([qc, gc])
    j = JaxEvaluator(len(qf), feat_norm=feat_norm, dist_metric=dist_metric)
    t = R1mAPEvaluator(len(qf), feat_norm=feat_norm, dist_metric=dist_metric)
    for lo in range(0, len(feats), 16):  # batch by batch, as the eval loop feeds it
        sl = slice(lo, lo + 16)
        j.update((feats[sl], pids[sl], cams[sl]))
        t.update((torch.from_numpy(feats[sl]), pids[sl], cams[sl]))
    jcmc, jmap, jdist, *_ = j.compute()
    tcmc, tmap, tdist, *_ = t.compute()
    np.testing.assert_allclose(tdist, jdist, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tcmc, jcmc)
    assert abs(tmap - jmap) <= 1e-6


def test_evaluator_refuses_reranking(monkeypatch):
    """Re-ranking runs where the features are: numpy features go to the card
    and, without one, raise rather than re-rank on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qf, gf, qp, gp, qc, gc = _feats()
    ev = R1mAPEvaluator(len(qf), reranking=True)
    with pytest.raises(RuntimeError, match="MODEL.DEVICE cpu"):
        ev.update((np.concatenate([qf, gf]), np.concatenate([qp, gp]), np.concatenate([qc, gc])))


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = tmp_path_factory.mktemp("m1501_torch")
    make_market1501(str(root), n_ids=6, imgs_per_id=8)
    return str(root)


def _cfgs(root):
    jcfg = tiny_cfg()
    jcfg.DATASETS.ROOT_DIR = root
    jcfg.MODEL.DEBUG_TINY = True
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)  # the same keys and values
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, tcfg


def test_loader_batches_match_jax(market):
    jcfg, tcfg = _cfgs(market)
    jval = jax_make_dataloader(jcfg)[2]
    tval = make_dataloader(tcfg)[2]
    jb = list(jval.iter_sequential())
    tb = list(tval.iter_sequential())
    assert len(jb) == len(tb) == 6
    for a, b in zip(jb, tb):
        for k in ("images", "pids", "camids", "trackids"):
            np.testing.assert_array_equal(b[k], a[k])
        assert a["count"] == b["count"] and a["paths"] == b["paths"]


@pytest.mark.parametrize("re_ranking", [False, True])
@pytest.mark.parametrize("neck_feat", ["before", "after"])
def test_do_inference_slice_matches_jax(market, neck_feat, re_ranking):
    """The whole slice on one tree: features → distmat (or k-reciprocal
    re-ranking, k1 50 clamped to the corpus of ~48 rows) → CMC/mAP."""
    jcfg, tcfg = _cfgs(market)
    jcfg.TEST.NECK_FEAT = tcfg.TEST.NECK_FEAT = neck_feat
    jcfg.TEST.RE_RANKING = tcfg.TEST.RE_RANKING = re_ranking
    _, _, jval, nq, ncls, ncam, nview = jax_make_dataloader(jcfg)
    jmodel = jax_make_model(jcfg, ncls, ncam, nview)
    variables = init_variables(jmodel, jax.random.PRNGKey(0), jcfg)
    _, _, tval, tnq, *_ = make_dataloader(tcfg)
    tmodel = make_model(tcfg, ncls, ncam, nview)
    tmodel.load_state_dict(from_jax_variables(variables, tmodel.clip_config), strict=True)

    jcmc, jmap = jax_run_validation(jcfg, jmodel, variables["params"],
                                    variables["batch_stats"], jval, nq)
    tcmc, tmap = run_validation(tcfg, tmodel, tval, tnq)
    np.testing.assert_array_equal(tcmc, jcmc)
    assert abs(tmap - jmap) <= 1e-6
    assert tuple(map(float, do_inference(tcfg, tmodel, tval, tnq))) == \
        tuple(map(float, jax_do_inference(jcfg, jmodel, variables, jval, nq)))
