"""Every program at ``MODEL.DEBUG_TINY`` on the CPU through a short window:
the result's keys, and the port agreeing with the reference in fp32."""

import pytest

from portbench.harness import runner

from .conftest import CELLS, TINY, cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("name", CELLS)
def test_a_short_window_agrees_with_the_reference(name):
    cell_ = cell(name)
    result = runner.execute(cell_, 2 ** 31 + 77, 0.5, False, "cpu", TINY)
    assert list(result) == KEYS
    assert set(result["metrics"]) == {m["name"] for m in cell_.end_to_end}
    assert result["metrics"][cell_.workload["rate_metric"]]["value"] > 0
    assert result["attempted"] > 0 and result["failed"] == 0
    # fp32 on both sides: round-off alone, which four Adam steps amplify most
    # in the tiny RN50 (a 4 x 2 layer4 map, batch statistics over 16 images)
    worst = 0.05 if name.startswith("rn50") else 1e-3
    for n in result["check"].values():
        assert n["value"] < worst, result["check"]


def test_the_same_seed_gives_the_same_inputs():
    from portbench.data import images, seeds, weights
    import torch
    a, b = seeds.streams(2 ** 31 + 5), seeds.streams(2 ** 31 + 5)
    assert a == b and len(set(a.values())) == len(a)
    w1 = weights.make({"x.weight": (4, 3), "x.bias": (4,)}, a["weights"], "cpu")
    w2 = weights.make({"x.weight": (4, 3), "x.bias": (4,)}, a["weights"], "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    s1 = images.train_set(32, 4, (8, 4), a["images"], "cpu")
    s2 = images.train_set(32, 4, (8, 4), seeds.streams(7)["images"], "cpu")
    assert s1[0].shape == s2[0].shape and torch.equal(s1[1], s2[1])  # sizes never move
