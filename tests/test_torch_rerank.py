"""The port's k-reciprocal re-ranking (dense and sparse-V) and its two
kernels' plain versions, against the JAX package's.

Inputs come from numpy seeds and go through the JAX function and its
counterpart in the port, in fp32 on the CPU. Tolerances:

* the L1 / min-sum plain versions against the Pallas kernels in interpret
  mode: rtol 1e-5, atol 1e-5 × max(1, max|want|) (K sums in another order);
* exact re-ranking (dense L1 route, sparse exact min-sum): 1e-5 max abs;
* quantized min-sum routes: 1e-4 max abs on the dense route and in the
  evaluator; on the sparse route at most 0.5% of the entries may differ by
  more than 1e-4, none by more than 1e-2. The thresholds are the same bits,
  but V differs from the JAX package's in its last bit (the distance
  products round differently), and a V value that sits exactly on a
  threshold (V repeats values, and quantiles of repeated values are those
  values) then crosses one level;
* against the NumPy oracle: the JAX tests' rtol 1e-3, atol 1e-4.

Clustered features are tie-free, so neighbour sets agree; duplicated
features are held to the JAX package's tie order (lower index first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.engine import R1mAPEvaluator as JaxEvaluator
from mpreid_tpu.ops.pallas_kernels import l1_cross_pallas, minsum_cross_pallas
from mpreid_tpu.ops.reranking import re_ranking as jax_re_ranking
from mpreid_tpu.ops.reranking_numpy import re_ranking_numpy
from mpreid_tpu.ops.reranking_sparse import _quantile_thresholds as jax_thresholds
from mpreid_tpu.ops.reranking_sparse import re_ranking_sparse as jax_sparse
from mpreid_tpu.ops.reranking_sparse import re_ranking_sparse_rows as jax_sparse_rows
from mpreid_tpu_torch.engine import R1mAPEvaluator
from mpreid_tpu_torch.ops import (
    l1_cross, l1_cross_plain, minsum_cross, minsum_cross_plain, re_ranking, re_ranking_sparse,
    re_ranking_sparse_rows,
)
from mpreid_tpu_torch.ops import reranking as treranking

EXACT_TOL, QUANT_TOL = 1e-5, 1e-4


def _clustered(seed, n_ids, dim, n_q, n_g, noise=0.5):
    """The JAX package's tests' clustered features (tests/test_reranking_sparse.py)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_ids, dim) * 3
    qf = np.stack([centers[i % n_ids] + rng.randn(dim) * noise
                   for i in range(n_q)]).astype(np.float32)
    gf = np.stack([centers[i % n_ids] + rng.randn(dim) * noise
                   for i in range(n_g)]).astype(np.float32)
    return qf, gf


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _max_abs(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _assert_levels_close(got, want):
    """The quantized sparse route: few entries one level apart, the rest 1e-4."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert float(np.mean(diff > QUANT_TOL)) <= 5e-3 and float(diff.max()) <= 1e-2


# --- the kernels' plain versions ----------------------------------------------

@pytest.mark.parametrize("q,g,n", [(16, 24, 40), (9, 17, 300), (130, 70, 600)])
@pytest.mark.parametrize("op", ["l1", "minsum"])
def test_plain_versions_match_the_pallas_kernels(q, g, n, op):
    rng = np.random.RandomState(q + g + n)
    a = np.abs(rng.randn(q, n)).astype(np.float32)
    b = np.abs(rng.randn(g, n)).astype(np.float32)
    pallas, plain = ((l1_cross_pallas, l1_cross_plain) if op == "l1"
                     else (minsum_cross_pallas, minsum_cross_plain))
    tiles = dict(tile_q=64, tile_g=64, chunk_k=128) if q > 64 else \
        dict(tile_q=8, tile_g=8, chunk_k=128)
    want = np.asarray(pallas(*_j(a, b), interpret=True, **tiles))
    got = plain(*_t(a, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("wrapper,plain", [(l1_cross, l1_cross_plain),
                                           (minsum_cross, minsum_cross_plain)])
def test_cpu_tensors_take_the_plain_versions(wrapper, plain):
    rng = np.random.default_rng(0)
    a, b = _t(rng.random((5, 33), np.float32), rng.random((7, 33), np.float32))
    before = wrapper.launches
    got = wrapper(a, b)
    assert wrapper.launches == before
    torch.testing.assert_close(got, plain(a, b), atol=0, rtol=0)
    # a view whose rows are contiguous but strided (as densified rows are)
    wide = torch.cat([b, torch.zeros(7, 1)], dim=1)[:, :33]
    torch.testing.assert_close(wrapper(a, wide), got, atol=0, rtol=0)


@pytest.mark.parametrize("wrapper", [l1_cross, minsum_cross])
def test_wrappers_refuse_what_the_kernels_do_not_take(wrapper):
    a = torch.rand(4, 8)
    with pytest.raises(TypeError, match="fp32"):
        wrapper(a.double(), a.double())
    with pytest.raises(ValueError, match="2-D"):
        wrapper(a[None], a)
    with pytest.raises(ValueError, match="one N"):
        wrapper(a, torch.rand(4, 9))


# --- dense re_ranking -----------------------------------------------------------

@pytest.mark.parametrize("k1,k2", [(6, 3), (20, 6), (50, 15), (10, 1), (200, 300)])
@pytest.mark.parametrize("fast", [False, True])
def test_dense_matches_jax(k1, k2, fast):
    """k1 ≥ N and k2 > N clamp (N = 70 here); k2 = 1 skips query expansion."""
    qf, gf = _clustered(3, 8, 16, 22, 48, noise=0.7)
    want = np.asarray(jax_re_ranking(*_j(qf, gf), k1=k1, k2=k2, fast_minsum=fast))
    got = re_ranking(*_t(qf, gf), k1=k1, k2=k2, fast_minsum=fast).numpy()
    assert got.shape == want.shape == (22, 48)
    assert _max_abs(got, want) <= (QUANT_TOL if fast else EXACT_TOL)


@pytest.mark.parametrize("fast", [False, True])
def test_dense_matches_jax_at_the_reference_protocol(fast):
    """k1 50, k2 15 on 300 rows: no clamping, W-wide V rows, 32 levels."""
    qf, gf = _clustered(11, 16, 24, 40, 260, noise=0.9)
    want = np.asarray(jax_re_ranking(*_j(qf, gf), fast_minsum=fast))
    got = re_ranking(*_t(qf, gf), fast_minsum=fast).numpy()
    assert _max_abs(got, want) <= (QUANT_TOL if fast else EXACT_TOL)


@pytest.mark.parametrize("k1,k2", [(6, 3), (20, 6), (50, 15)])
def test_dense_matches_numpy_oracle(k1, k2):
    qf, gf = _clustered(11, 16, 24, 40, 260, noise=0.9)
    want = re_ranking_numpy(qf, gf, k1=k1, k2=k2, lambda_value=0.3)
    got = re_ranking(*_t(qf, gf), k1=k1, k2=k2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_duplicated_features_follow_jax_tie_order():
    """Equal distances break by the lower index, as jax.lax.top_k does."""
    qf, gf = _clustered(5, 6, 12, 10, 30, noise=0.6)
    gf = np.concatenate([gf, gf[:12], qf[:4]])  # exact duplicates
    want = np.asarray(jax_re_ranking(*_j(qf, gf), k1=8, k2=4))
    got = re_ranking(*_t(qf, gf), k1=8, k2=4).numpy()
    assert _max_abs(got, want) <= EXACT_TOL


@pytest.mark.parametrize("k", [1, 5, 17])
def test_smallest_k_is_jax_top_k_order(k):
    rng = np.random.default_rng(k)
    d = rng.integers(0, 6, (40, 50)).astype(np.float32)  # many ties
    _, want = jax.lax.top_k(-jnp.asarray(d), k)
    got = treranking.smallest_k(torch.from_numpy(d), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [500, (1 << 24) + 3])
def test_quantile_thresholds_equal_jax(n):
    """The same mids and widths as the JAX package, with no size limit
    (torch.nanquantile refuses inputs above 2**24 elements)."""
    rng = np.random.default_rng(n % 97)
    x = rng.random(n, dtype=np.float32) * 1e-2
    x[rng.random(n) < 0.6] = 0.0  # the zeros of sparse rows
    want = jax_thresholds(jnp.asarray(x), 32)
    got = treranking.quantile_thresholds(torch.from_numpy(x), 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bf16_thresholds_compare_as_fp32():
    """bf16 rows against fp32 thresholds compare as JAX promotes them."""
    t = torch.tensor([1.0001, 0.3, 2.0 ** -20 * 1.3])
    r = treranking._ceil_bf16(t)
    x = torch.tensor([1.0, 1.0078125, 0.30078125, 0.2988281], dtype=torch.bfloat16)
    for ti, ri in zip(t, r):
        assert torch.equal(x.float() >= ti, x >= ri)
        assert ri.float() >= ti


# --- sparse-V re_ranking --------------------------------------------------------

SPARSE_CASES = {
    "oracle_params": dict(data=(11, 16, 24, 40, 260, 0.9), k1=50, k2=15, block=64,
                          g_chunk=128),
    "ragged": dict(data=(17, 7, 12, 13, 61, 0.5), k1=8, k2=3, block=9, g_chunk=7),
    "small_k": dict(data=(3, 8, 16, 24, 56, 0.5), k1=10, k2=4, block=16, g_chunk=32),
    "overflow": dict(data=(9, 6, 16, 16, 80, 1.5), k1=20, k2=6, width=8, width2=12,
                     block=32, g_chunk=32),
}


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
@pytest.mark.parametrize("minsum", ["exact", "quantized"])
def test_sparse_matches_jax(case, minsum):
    kw = dict(SPARSE_CASES[case])
    qf, gf = _clustered(*kw.pop("data"))
    want, winfo = jax_sparse(*_j(qf, gf), minsum=minsum, return_info=True, **kw)
    got, info = re_ranking_sparse(*_t(qf, gf), minsum=minsum, return_info=True, **kw)
    assert got.shape == want.shape
    if minsum == "exact":
        assert _max_abs(got.numpy(), want) <= EXACT_TOL
    else:
        _assert_levels_close(got.numpy(), want)
    assert info == {k: int(v) for k, v in winfo.items()}
    if case == "overflow":
        assert info["overflow_v"] > 0 or info["overflow_qe"] > 0


@pytest.mark.parametrize("case", ["oracle_params", "ragged"])
def test_sparse_matches_numpy_oracle(case):
    kw = dict(SPARSE_CASES[case])
    qf, gf = _clustered(*kw.pop("data"))
    want = re_ranking_numpy(qf, gf, k1=kw["k1"], k2=kw["k2"], lambda_value=0.3)
    got = re_ranking_sparse(*_t(qf, gf), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("minsum", ["exact", "quantized"])
def test_sparse_q_blocks_equal_unblocked(minsum):
    """Ragged, overlapping query blocks give the unblocked values bit for bit."""
    qf, gf = _clustered(29, 8, 16, 23, 70)
    kw = dict(k1=10, k2=4, block=16, g_chunk=32, minsum=minsum)
    whole = re_ranking_sparse(*_t(qf, gf), **kw).numpy()
    for qb in (7, 23, 64):
        np.testing.assert_array_equal(re_ranking_sparse(*_t(qf, gf), q_block=qb, **kw).numpy(),
                                      whole)


def test_sparse_matches_dense():
    qf, gf = _clustered(5, 12, 24, 32, 150)
    dense = re_ranking(*_t(qf, gf), k1=20, k2=6).numpy()
    sparse = re_ranking_sparse(*_t(qf, gf), k1=20, k2=6, block=64, g_chunk=64).numpy()
    np.testing.assert_allclose(sparse, dense, rtol=1e-3, atol=1e-4)


def test_sparse_rows_oracle_matches_jax():
    qf, gf = _clustered(19, 9, 16, 20, 90)
    rows = np.asarray([0, 3, 17, 19], np.int32)
    kw = dict(k1=12, k2=5, block=32, g_chunk=64)
    want = np.asarray(jax_sparse_rows(*_j(qf, gf), jnp.asarray(rows), **kw))
    got = re_ranking_sparse_rows(*_t(qf, gf), torch.from_numpy(rows), **kw).numpy()
    assert _max_abs(got, want) <= EXACT_TOL
    full = re_ranking_sparse(*_t(qf, gf), **kw).numpy()
    assert _max_abs(got, full[rows]) <= EXACT_TOL


# --- the evaluator ----------------------------------------------------------------

def _eval_inputs(seed=21, n_ids=8, n_q=16, n_g=80):
    qf, gf = _clustered(seed, n_ids, 16, n_q, n_g, noise=0.6)
    feats = np.concatenate([qf, gf])
    pids = np.concatenate([np.arange(n_q) % n_ids, np.arange(n_g) % n_ids])
    camids = np.concatenate([np.zeros(n_q, np.int64), np.ones(n_g, np.int64)])
    return n_q, feats, pids, camids


@pytest.mark.parametrize("sparse_n,fast", [(10 ** 9, False), (10 ** 9, True), (8, False)])
def test_evaluator_reranking_matches_jax(sparse_n, fast):
    """Dense exact, dense quantized, and forced-sparse (quantized) routes."""
    n_q, feats, pids, camids = _eval_inputs()
    kw = dict(max_rank=10, reranking=True, rerank_k1=12, rerank_k2=4, rerank_fast=fast,
              rerank_sparse_n=sparse_n)
    j = JaxEvaluator(n_q, **kw)
    t = R1mAPEvaluator(n_q, device="cpu", **kw)
    for lo in range(0, len(feats), 16):
        sl = slice(lo, lo + 16)
        j.update((feats[sl], pids[sl], camids[sl]))
        t.update((feats[sl], pids[sl], camids[sl]))  # numpy, to the CPU on request
    jcmc, jmap, jdist, *_ = j.compute()
    tcmc, tmap, tdist, *_ = t.compute()
    quantized = fast or sparse_n == 8
    assert _max_abs(tdist, jdist) <= (QUANT_TOL if quantized else EXACT_TOL)
    np.testing.assert_array_equal(tcmc, jcmc)
    assert abs(tmap - jmap) <= (0.01 if quantized else 1e-6)


def test_evaluator_numpy_features_on_the_cpu_match_jax():
    n_q, feats, pids, camids = _eval_inputs(seed=4)
    j = JaxEvaluator(n_q)
    t = R1mAPEvaluator(n_q, device="cpu")
    j.update((feats, pids, camids))
    t.update((feats, pids, camids))
    jcmc, jmap, jdist, *_ = j.compute()
    tcmc, tmap, tdist, *_ = t.compute()
    np.testing.assert_allclose(tdist, jdist, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tcmc, jcmc)
    assert abs(tmap - jmap) <= 1e-6


def test_evaluator_numpy_features_go_to_the_card(monkeypatch):
    """Without a card, numpy features raise unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n_q, feats, pids, camids = _eval_inputs(seed=4)
    ev = R1mAPEvaluator(n_q)
    with pytest.raises(RuntimeError, match="none is available"):
        ev.update((feats, pids, camids))
    assert ev.feats == []
    ev.update((torch.from_numpy(feats), pids, camids))  # tensors stay where they are
    assert ev.feats[0].device.type == "cpu"


# --- the entry point ------------------------------------------------------------

def test_test_cli_reranks_on_the_cpu(tmp_path):
    from mpreid_tpu.data.synthetic import make_market1501
    from mpreid_tpu_torch import test as entry

    make_market1501(str(tmp_path), n_ids=6, imgs_per_id=8)
    r1, r5 = entry.main([
        "MODEL.DEVICE", "cpu", "MODEL.NAME", "ViT-B-16", "MODEL.DEBUG_TINY", "True",
        "INPUT.SIZE_TRAIN", "[32,16]", "INPUT.SIZE_TEST", "[32,16]",
        "TPU.COMPUTE_DTYPE", "float32", "DATASETS.ROOT_DIR", str(tmp_path),
        "TEST.IMS_PER_BATCH", "16", "TEST.RE_RANKING", "True", "OUTPUT_DIR", "",
    ])
    assert 0.0 <= float(r1) <= float(r5) <= 1.0
