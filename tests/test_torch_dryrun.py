"""The port's multi-rank dry run, and the gallery-sharded sparse re-ranking.

``parallel/dryrun.py::dryrun_multichip(4)`` runs the JAX package's three
phases (``__graft_entry__.py::dryrun_multichip``) over four gloo ranks on
the CPU: one DP + TP(towers) + EP + ZeRO-1 Uni-Prompt stage-2 step on a
2 × 2 mesh, gallery-sharded evaluation and re-ranking against the dense
results, and a 2-stage GPipe against sequential blocks; every rank ends
with the same loss and rank 0 prints the three OK lines.

``ops/reranking_sparse.py::re_ranking_sparse_sharded`` over two gloo ranks
(one job for the module) equals the port's ``re_ranking_sparse`` and the
JAX package's, to 1e-5, exact and quantized min-sum, with a gallery that
does not split evenly and one smaller than a gallery chunk.

This module imports nothing of JAX at its top: the spawned ranks import it
to find their function.
"""

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.ops.reranking_sparse import re_ranking_sparse, re_ranking_sparse_sharded
from mpreid_tpu_torch.parallel import make_mesh
from mpreid_tpu_torch.parallel.dryrun import dryrun_multichip
from mpreid_tpu_torch.parallel.launch import spawn

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = 1e-5
# name: (queries, gallery, dims, ids, keyword arguments)
SPARSE = {
    "odd_gallery": (20, 67, 16, 8, dict(k1=10, k2=4, block=16, g_chunk=16)),
    "quantized": (24, 64, 16, 8, dict(k1=10, k2=4, block=16, g_chunk=16, minsum="quantized")),
    "query_blocks": (30, 41, 8, 6, dict(k1=6, k2=3, block=8, g_chunk=64, q_block=8)),
    "dryrun_widths": (16, 64, 32, 8, dict(k1=20, k2=6, block=32, g_chunk=16, width=256,
                                          width2=1024)),
}


def _feats(q, g, dims, ids, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ids, dims)).astype(np.float32)
    labels = rng.integers(0, ids, q + g)
    feats = centers[labels] + 0.5 * rng.standard_normal((q + g, dims)).astype(np.float32)
    return feats[:q].astype(np.float32), feats[q:].astype(np.float32)


def _sharded_job(cases):
    mesh = make_mesh(data=2)
    out = {}
    for name, (q, g, dims, ids, kw) in cases.items():
        qf, gf = _feats(q, g, dims, ids)
        out[name] = re_ranking_sparse_sharded(torch.from_numpy(qf), torch.from_numpy(gf), mesh,
                                              **kw)
    return out


@pytest.fixture(scope="module")
def sharded():
    return spawn(_sharded_job, 2, (SPARSE,), timeout=120, threads=2)


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_sharded_sparse_re_ranking_equals_the_one_rank_result(sharded, name):
    q, g, dims, ids, kw = SPARSE[name]
    qf, gf = _feats(q, g, dims, ids)
    want = re_ranking_sparse(torch.from_numpy(qf), torch.from_numpy(gf), **kw).numpy()
    for out in sharded:
        assert out[name].shape == (q, g)
        np.testing.assert_allclose(out[name].numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_sharded_sparse_re_ranking_equals_jax(sharded, name):
    from mpreid_tpu.ops.reranking_sparse import re_ranking_sparse as jax_re_ranking_sparse

    q, g, dims, ids, kw = SPARSE[name]
    qf, gf = _feats(q, g, dims, ids)
    want = np.asarray(jax_re_ranking_sparse(qf, gf, **kw))
    np.testing.assert_allclose(sharded[0][name].numpy(), want, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(4, device="cpu", timeout=240, threads=1)


PHASES = {
    "step": "dryrun_multichip OK: mesh=(2x2) dp+tp(towers)+ep+zero1 step loss=",
    "eval": "dryrun_multichip eval OK: sharded CMC/mAP == dense (rank1=",
    "pipeline": "dryrun_multichip PP OK: 2-stage GPipe over the text blocks == sequential",
}


@pytest.mark.parametrize("phase", list(PHASES))
def test_dryrun_multichip_passes_each_phase_on_four_ranks(dryrun, phase):
    lines = dryrun[0]["lines"]
    assert len(lines) == 3
    assert lines[list(PHASES).index(phase)].startswith(PHASES[phase])


def test_dryrun_multichip_ranks_share_one_loss_on_a_2x2_mesh(dryrun):
    losses = {r["loss"] for r in dryrun}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    assert sorted((r["rank"], r["model_rank"]) for r in dryrun) == [(0, 0), (0, 1), (1, 0),
                                                                     (1, 1)]
    assert all(not r["lines"] for r in dryrun[1:])  # rank 0 alone prints
