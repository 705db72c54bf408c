"""The port's data-axis layer (mpreid_tpu_torch.parallel) against the JAX package's.

Without torchrun's environment ``init_distributed`` is rank 0 of a world of
1; the mesh refuses sizes that do not cover the ranks and places rank r at
(r // model, r % model);
``param_spec`` places every parameter as the JAX package's places its leaf
(the leaves carried across by the converter); ``ShardedLoader`` feeds each
rank ``shard_for_host``'s block of every global PK batch; and, on two gloo
ranks on the CPU (one job for the module, ``parallel.launch.spawn``), the
collectives (the differentiable gather's backward is this rank's slice; the
gather written through ``all_reduce`` for CUDA tensors under gloo equals the
native one) and the gallery-sharded metrics: ``sharded_cmc_map`` equals the
JAX package's over its 8-device CPU mesh and the dense ``cmc_map`` on
``tests/test_parallel.py``'s cases, ties across the shard boundary
included: CMC equal, mAP within 1e-6.

This module imports nothing of JAX at its top: the spawned ranks import it
to find their function.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.data import ShardedLoader, make_dataloader, shard_for_host
from mpreid_tpu_torch.parallel import dist as tdist
from mpreid_tpu_torch.parallel import make_mesh, param_spec
from mpreid_tpu_torch.parallel.launch import spawn

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

WORLD = 2
MAX_RANK = 20


def eval_data(seed=0, q=24, g=64, dim=16, n_ids=10, n_cams=4):
    """tests/test_parallel.py's query / gallery data."""
    rng = np.random.RandomState(seed)
    qf = rng.randn(q, dim).astype(np.float32)
    gf = rng.randn(g, dim).astype(np.float32)
    return (qf, gf, rng.randint(0, n_ids, q), rng.randint(0, n_ids, g),
            rng.randint(0, n_cams, q), rng.randint(0, n_cams, g))


def _tie_cases():
    """test_parallel.py's cases, and a duplicate pair astride the two-rank
    boundary (rows 31 and 32)."""
    cases = {"random": eval_data(seed=3)}
    qf, gf, qp, gp, qc, gc = eval_data(seed=7, q=16, g=64)
    for a, b in [(3, 11), (20, 44), (5, 61), (31, 32)]:
        gf[b], gp[b] = gf[a], gp[a]
    cases["ties_across_shards"] = (qf, gf, qp, gp, qc, gc)
    qf, gf, qp, gp, qc, gc = eval_data(seed=9, q=16, g=64)
    gf[37], gp[37] = gf[2], gp[2] + 1
    gf[53], gp[53] = gf[9], gp[9]
    gp[9] = gp[53] + 1
    gf[32], gp[32] = gf[31], gp[31] + 1
    cases["relevant_vs_irrelevant_ties"] = (qf, gf, qp, gp, qc, gc)
    rng = np.random.RandomState(0)
    for trial in range(2):
        base = rng.randn(10, 8).astype(np.float32)
        qf = rng.randn(12, 8).astype(np.float32)
        gf = base[rng.randint(0, 10, 64)]
        cases[f"heavy_duplication_{trial}"] = (
            qf, gf, rng.randint(0, 6, 12).astype(np.int32), rng.randint(0, 6, 64).astype(np.int32),
            rng.randint(0, 3, 12).astype(np.int32), rng.randint(0, 3, 64).astype(np.int32))
    return {f"{name}-{cf}": (*data, cf) for name, data in cases.items() for cf in (False, True)}


CASES = _tie_cases()


def _ranks_job(cases):
    """Every two-rank case of the module, on one rank → its results."""
    import torch.distributed as dist

    from mpreid_tpu_torch.parallel import collectives as C
    from mpreid_tpu_torch.parallel import sharded_cmc_map, sharded_topk

    mesh = make_mesh()
    r = mesh.rank
    out = {"rank": r, "world": tdist.world_size(), "backend": dist.get_backend()}
    # the differentiable gather: forward concatenates, backward is the slice
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2).add(10 * r).requires_grad_(True)
    weights = torch.arange(12, dtype=torch.float32).reshape(6, 2) + 1
    y = C.all_gather_cat(x)
    (y * weights).sum().backward()
    out["gathered"], out["grad"] = y.detach(), x.grad
    # the gather through all_reduce, for each dtype it is used with
    samples = {"float32": torch.randn(5, 3, generator=torch.Generator().manual_seed(r)),
               "bfloat16": torch.randn(4, 2).to(torch.bfloat16) + r,
               "int64": torch.arange(7) * (r + 3), "bool": torch.arange(4) % (r + 2) == 0}
    out["gather_by_all_reduce"] = {k: (C.gather_by_all_reduce(v), C.all_gather(v))
                                   for k, v in samples.items()}
    # the differentiable sum of partial sums: its backward passes through
    part = torch.full((3,), float(r + 1), requires_grad=True)
    total = C.sum_over_ranks(part)
    out["sum_over_ranks"] = (total.detach(), torch.autograd.grad((total ** 2).sum(), [part])[0])
    metrics = {}
    for name, (qf, gf, qp, gp, qc, gc, cf) in cases.items():
        per = len(gp) // mesh.data
        block = slice(r * per, (r + 1) * per)
        t = torch.from_numpy
        cmc, mAP = sharded_cmc_map(t(qf), t(gf[block]), t(qp), t(gp[block]), t(qc), t(gc[block]),
                                   mesh, max_rank=MAX_RANK, camera_filter=cf)
        metrics[name] = (cmc.numpy(), float(mAP))
    out["metrics"] = metrics
    qf, gf, *_ = eval_data(seed=2, g=128)
    out["topk"] = [v.numpy() for v in sharded_topk(torch.from_numpy(qf),
                                                   torch.from_numpy(gf[r * 64:(r + 1) * 64]),
                                                   10, mesh)]
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(_ranks_job, WORLD, (CASES,), timeout=120, threads=2)


# ---------------------------------------------------------------------------
# the process group and the mesh
# ---------------------------------------------------------------------------

def test_init_distributed_without_torchrun_is_world_one(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert tdist.init_distributed() == 0
    assert (tdist.world_size(), tdist.rank(), tdist.is_main()) == (1, 0, True)
    assert not torch.distributed.is_initialized()
    assert tdist.rank_device("cuda") == torch.device("cuda")  # no LOCAL_RANK without torchrun


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert tdist.rank_device("cuda") == torch.device("cuda", 1)
    assert tdist.rank_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="nccl needs a CUDA device"):
        tdist.init_distributed(backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("data,model,world,message", [
    (3, 1, 2, "mesh 3x1 != 2"), (1, 1, 2, "mesh 1x1 != 2"), (-1, 3, 4, "mesh 1x3 != 4")])
def test_mesh_that_does_not_cover_the_ranks_raises(data, model, world, message):
    with pytest.raises(ValueError, match=message):
        make_mesh(data, model, world=world)


def test_mesh_sizes_and_the_model_axis():
    assert make_mesh(-1, 1, world=4).shape == {"data": 4, "model": 1}
    assert make_mesh(world=1).shape == {"data": 1, "model": 1}
    # the model axis: rank r at (r // model, r % model); without a process
    # group no axis groups are made
    mesh = make_mesh(-1, 2, world=4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert (mesh.rank, mesh.model_rank, mesh.group, mesh.model_group) == (0, 0, None, None)


def _spec_pairs(kind, tp_towers):
    """(port name, port spec, the JAX specs of the leaves it was built from)
    for every parameter of a tiny model: each JAX leaf filled with its own
    constant, carried across by ``from_jax_variables``, so a port
    parameter's values name its JAX leaves."""
    import jax
    from jax.sharding import PartitionSpec as P

    from mpreid_tpu.models.factory import init_variables
    from mpreid_tpu.models.reid import ReIDModel as JaxReID
    from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUni
    from mpreid_tpu.parallel import param_spec as jax_param_spec
    from mpreid_tpu.solver.optim import path_strings
    from mpreid_tpu_torch.models import CLIPConfig, ReIDModel, UniPromptReID, from_jax_variables
    from tiny import tiny_cfg, tiny_clip_config

    clip = tiny_clip_config(**({"num_experts": 4, "top_k": 2, "moe_layers": 2}
                               if kind == "moe" else {}))
    jcls, tcls = (JaxReID, ReIDModel) if kind == "baseline" else (JaxUni, UniPromptReID)
    jmodel = jcls(clip_config=clip, num_classes=8, camera_num=14, view_num=1)
    variables = init_variables(jmodel, jax.random.PRNGKey(0), tiny_cfg(), abstract=True)
    names = path_strings(variables["params"])
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    flat_names = jax.tree_util.tree_leaves(names)
    filled = [np.full(np.shape(x), i + 1, np.float32) for i, x in enumerate(leaves)]
    stats = jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32),
                                   variables["batch_stats"])
    tclip = CLIPConfig(**dataclasses.asdict(clip))
    tmodel = tcls(tclip, 8, camera_num=14, view_num=1)
    tmodel.load_state_dict(from_jax_variables(
        {"params": jax.tree_util.tree_unflatten(treedef, filled), "batch_stats": stats}, tclip),
        strict=False)
    pairs = []
    for name, p in tmodel.named_parameters():
        ids = {int(v) for v in torch.unique(p.detach()).tolist() if v >= 1 and float(v).is_integer()}
        specs = {jax_param_spec(flat_names[i - 1], tp_towers) != P() for i in ids}
        pairs.append((name, param_spec(name, tp_towers), specs))
    return pairs


@pytest.mark.parametrize("tp_towers", [False, True])
@pytest.mark.parametrize("kind", ["baseline", "moe"])
def test_param_spec_places_every_leaf_as_the_jax_package(kind, tp_towers):
    pairs = _spec_pairs(kind, tp_towers)
    carried = [(n, s, j) for n, s, j in pairs if j]
    assert len(carried) >= len(pairs) - 8  # the template buffers the port derives
    split = 0
    for name, spec, jax_specs in carried:
        assert jax_specs == {bool(any(spec))}, (name, spec, jax_specs)
        split += bool(any(spec))
    assert split >= (2 if kind == "baseline" else 4)
    if tp_towers:
        assert param_spec("image_encoder.transformer.resblocks.0.attn.in_proj_weight", True) \
            == ("model", None)


def test_shard_for_host_blocks_make_the_global_batches(tmp_path):
    """Each rank's ShardedLoader block of every batch, concatenated in rank
    order, is the unsharded loader's global batch; the blocks are the JAX
    package's shard_for_host blocks."""
    from mpreid_tpu.data.sampler import shard_for_host as jax_shard_for_host
    from mpreid_tpu_torch.config import get_default_cfg
    from mpreid_tpu_torch.data.synthetic import make_market1501

    make_market1501(str(tmp_path), n_ids=6, imgs_per_id=8)
    cfg = get_default_cfg()
    cfg.DATASETS.NAMES, cfg.DATASETS.ROOT_DIR = "market1501", str(tmp_path)
    cfg.INPUT.SIZE_TRAIN = [32, 16]
    cfg.SOLVER.STAGE2.IMS_PER_BATCH = 8
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.DATALOADER.SAMPLER, cfg.DATALOADER.NUM_INSTANCE = "softmax_triplet", 4
    loader = make_dataloader(cfg)[0]
    order = np.asarray(loader.sampler.epoch_indices(1))
    for r in range(WORLD):
        np.testing.assert_array_equal(shard_for_host(order, 8, WORLD, r),
                                      jax_shard_for_host(order, 8, WORLD, r))
    whole = list(loader.epoch(1))
    blocks = [list(ShardedLoader(loader, WORLD, r).epoch(1)) for r in range(WORLD)]
    assert len(blocks[0]) == len(blocks[1]) == len(whole) == len(loader) > 0
    for i, batch in enumerate(whole):
        for key in ("images", "pids", "camids"):
            np.testing.assert_array_equal(
                np.concatenate([blocks[r][i][key] for r in range(WORLD)]), batch[key])
    with pytest.raises(ValueError, match="does not split"):
        ShardedLoader(loader, 3, 0)


# ---------------------------------------------------------------------------
# two gloo ranks on the CPU
# ---------------------------------------------------------------------------

def test_two_ranks_form_one_gloo_group(ranks):
    assert [(o["rank"], o["world"], o["backend"]) for o in ranks] == [(0, 2, "gloo"),
                                                                       (1, 2, "gloo")]


def test_all_gather_cat_forward_concatenates_and_backward_is_the_slice(ranks):
    full = torch.cat([torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
                      for r in range(WORLD)])
    weights = torch.arange(12, dtype=torch.float32).reshape(6, 2) + 1
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["gathered"], full, atol=0, rtol=0)
        torch.testing.assert_close(out["grad"], weights[3 * r:3 * r + 3], atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64", "bool"])
def test_gather_through_all_reduce_equals_the_native_gather(ranks, dtype):
    """gloo's form for CUDA tensors, run on the CPU: bit for bit the gather."""
    for out in ranks:
        through, native = out["gather_by_all_reduce"][dtype]
        assert through.dtype == native.dtype and torch.equal(through, native)
    assert torch.equal(ranks[0]["gather_by_all_reduce"][dtype][1],
                       ranks[1]["gather_by_all_reduce"][dtype][1])


def test_sum_over_ranks_sums_and_passes_the_cotangent_through(ranks):
    for out in ranks:
        total, grad = out["sum_over_ranks"]
        torch.testing.assert_close(total, torch.full((3,), 3.0), atol=0, rtol=0)
        torch.testing.assert_close(grad, torch.full((3,), 6.0), atol=0, rtol=0)


def _dense(qf, gf, qp, gp, qc, gc, cf):
    from mpreid_tpu_torch.ops import cmc_map, euclidean_squared_distmat

    t = torch.from_numpy
    cmc, mAP = cmc_map(euclidean_squared_distmat(t(qf), t(gf)), t(qp), t(gp), t(qc), t(gc),
                       max_rank=MAX_RANK, camera_filter=cf)
    return cmc.numpy(), float(mAP)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_cmc_map_equals_jax_and_dense(ranks, case):
    import jax.numpy as jnp

    from mpreid_tpu.parallel import make_mesh as jax_make_mesh
    from mpreid_tpu.parallel.sharded_eval import sharded_cmc_map as jax_sharded_cmc_map

    qf, gf, qp, gp, qc, gc, cf = CASES[case]
    jcmc, jmap = jax_sharded_cmc_map(jnp.asarray(qf), jnp.asarray(gf), qp, gp, qc, gc,
                                     jax_make_mesh(data=8, model=1), max_rank=MAX_RANK,
                                     camera_filter=cf)
    dcmc, dmap = _dense(*CASES[case])
    for out in ranks:
        cmc, mAP = out["metrics"][case]
        np.testing.assert_array_equal(cmc, np.asarray(jcmc))
        np.testing.assert_array_equal(cmc, dcmc)
        assert abs(mAP - float(jmap)) <= 1e-6 and abs(mAP - dmap) <= 1e-6


def test_sharded_topk_equals_the_full_sort(ranks):
    from mpreid_tpu_torch.ops import euclidean_squared_distmat

    qf, gf, *_ = eval_data(seed=2, g=128)
    full = euclidean_squared_distmat(torch.from_numpy(qf), torch.from_numpy(gf)).numpy()
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    for out in ranks:
        dists, idx = out["topk"]
        np.testing.assert_array_equal(np.sort(idx, axis=1), np.sort(want, axis=1))
        np.testing.assert_allclose(np.sort(dists, axis=1),
                                   np.sort(np.take_along_axis(full, want, 1), axis=1),
                                   rtol=1e-5, atol=1e-5)


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="failed on rank 1"):
        spawn(_fails_on_rank_one, WORLD, timeout=60)


def _fails_on_rank_one():
    if tdist.rank() == 1:
        raise ValueError("rank one fails")
    return os.getpid()
