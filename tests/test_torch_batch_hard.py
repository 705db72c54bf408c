"""The port's fused batch-hard mining (mpreid_tpu_torch/ops/batch_hard.py)
against the JAX package's (mpreid_tpu/ops/pallas_kernels.py).

On the CPU the port computes ``batch_hard_plain``; it is held against the
Pallas kernel in interpret mode and against ``_batch_hard_xla``, and the
gradient of ``batch_hard_triplet_loss`` against the JAX custom VJP
(``use_pallas=False``) and against autograd through the port's
``losses/triplet.py::triplet_loss``.

Tolerances, fp32: distances 1e-5 relative (the two frameworks sum the dot
products in other orders), indices equal. Ties and degenerate rows use
features on a grid of 1/4 (every square, product and sum is exact in fp32
in any order), where everything is held bit for bit: a singleton identity
gets ap = sqrt(1e-12) at p = self, a single-identity batch an = +inf at
n = 0, and tied candidates the first index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.ops import pallas_kernels as pk
from mpreid_tpu_torch.losses import triplet as ttriplet
from mpreid_tpu_torch.ops import batch_hard as bh

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _random(b, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, d)).astype(np.float32)


def _grid(b, d, seed=0):
    """Features on a grid of 1/4 in [-1, 1]: exact distances in fp32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, (b, d)) / 4).astype(np.float32)


def _pk(b, k=4):
    return np.repeat(np.arange(-(-b // k)), k)[:b].astype(np.int32)


def _jax_both(f, labels):
    jf, jl = jnp.asarray(f), jnp.asarray(labels)
    return (pk._batch_hard_forward(jf, jl, interpret=True), pk._batch_hard_xla(jf, jl))


@pytest.mark.parametrize("b,d", [(16, 32), (12, 40)])
def test_plain_matches_pallas_interpret_and_xla(b, d):
    """Random features, PK labels (B 16 × D 32, and a ragged B 12 × D 40
    whose padding the Pallas kernel masks)."""
    f, labels = _random(b, d, seed=b), _pk(b)
    got = bh.batch_hard_plain(torch.from_numpy(f), torch.from_numpy(labels))
    for want in _jax_both(f, labels):
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=0)
        for g, w in zip(got[2:], want[2:]):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(_np(g), _np(w))


DEGENERATE = {
    # identity 3 is a singleton: ap = sqrt(1e-12) at p = self
    "singleton": np.array([0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3], np.int32),
    # one identity: no negative anywhere, an = +inf at n = 0
    "single_identity": np.zeros(12, np.int32),
    # every row its own identity: no positive but itself
    "all_singletons": np.arange(12, dtype=np.int32),
}


@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_degenerate_rows_match_jax_exactly(case):
    labels = DEGENERATE[case]
    f = _grid(len(labels), 24, seed=3)
    got = bh.batch_hard_plain(torch.from_numpy(f), torch.from_numpy(labels))
    for want in _jax_both(f, labels):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))
    ap, an, p, n = (_np(t) for t in got)
    solo = np.array([np.sum(labels == l) == 1 for l in labels])
    assert np.all(ap[solo] == np.sqrt(np.float32(1e-12))) and np.all(p[solo] == np.flatnonzero(solo))
    if case == "single_identity":
        assert np.all(np.isinf(an)) and np.all(n == 0)


def test_ties_take_the_first_index_like_jax():
    """Duplicated rows tie every candidate: the first index wins."""
    base = _grid(4, 16, seed=5)
    f = np.concatenate([base, base, base])  # rows i, i+4, i+8 identical
    labels = np.array([0, 1, 0, 1, 2, 2, 2, 2, 0, 1, 3, 3], np.int32)
    got = bh.batch_hard_plain(torch.from_numpy(f), torch.from_numpy(labels))
    for want in _jax_both(f, labels):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))


def test_cpu_tensor_takes_the_plain_path():
    f, labels = torch.from_numpy(_random(8, 16)), torch.from_numpy(_pk(8))
    before = bh.fused_batch_hard.launches
    ap, an = bh.fused_batch_hard(f, labels)
    assert bh.fused_batch_hard.launches == before
    want = bh.batch_hard_plain(f, labels)
    torch.testing.assert_close(ap, want[0], atol=0, rtol=0)
    torch.testing.assert_close(an, want[1], atol=0, rtol=0)
    with pytest.raises(ValueError, match="features"):
        bh.fused_batch_hard(f, labels[:4])


@pytest.mark.parametrize("margin", [0.3, None])
@pytest.mark.parametrize("b", [16, 12])
def test_loss_and_gradient_match_jax_and_triplet_loss(margin, b):
    """batch_hard_triplet_loss's value and gradient against the JAX custom VJP
    (use_pallas=False) and against autograd through losses/triplet.py."""
    f, labels = _random(b, 32, seed=7 + b) * 0.5, _pk(b)
    x = torch.from_numpy(f).requires_grad_(True)
    loss, ap, an = bh.batch_hard_triplet_loss(x, torch.from_numpy(labels), margin=margin)
    loss.backward()

    def jfn(a):
        return pk.batch_hard_triplet_loss(a, jnp.asarray(labels), margin=margin,
                                          use_pallas=False)[0]

    jloss, jgrad = jax.value_and_grad(jfn)(jnp.asarray(f))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    np.testing.assert_allclose(_np(x.grad), np.asarray(jgrad), rtol=1e-5, atol=1e-7)

    y = torch.from_numpy(f).requires_grad_(True)
    tloss, tap, tan = ttriplet.triplet_loss(y, torch.from_numpy(labels).long(), margin=margin)
    tloss.backward()
    assert abs(float(loss.detach()) - float(tloss.detach())) <= 1e-5 * abs(float(tloss.detach()))
    np.testing.assert_allclose(_np(ap), _np(tap), rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(an), _np(tan), rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(x.grad), _np(y.grad), rtol=1e-5, atol=1e-7)


def test_gradient_keeps_the_input_dtype_and_ignores_a_missing_negative():
    """bf16 features get a bf16 gradient; a single-identity batch (an = +inf)
    gives the negative term no gradient, as the JAX VJP does."""
    f = _grid(8, 16, seed=9)
    labels = np.zeros(8, np.int32)
    x = torch.from_numpy(f).bfloat16().requires_grad_(True)
    loss, _, an = bh.batch_hard_triplet_loss(x, torch.from_numpy(labels), margin=0.3)
    loss.backward()
    assert x.grad.dtype == torch.bfloat16 and bool(torch.isinf(an).all())
    jgrad = jax.grad(lambda a: pk.batch_hard_triplet_loss(
        a, jnp.asarray(labels), margin=0.3, use_pallas=False)[0])(
        jnp.asarray(f).astype(jnp.bfloat16))
    np.testing.assert_array_equal(x.grad.float().numpy(), np.asarray(jgrad, np.float32))
