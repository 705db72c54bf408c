"""The parallel modes of the port over ``torch.distributed``.

ref mpreid_tpu/parallel/__init__.py. The process group
(``dist.init_distributed``, the counterpart of ``mesh.init_distributed``),
the ``('data', 'model')`` mesh, its placement rules and the slicing of a
model over the model axis (``mesh``: tensor parallelism of the classifiers,
``ctx_generic`` and, under ``TPU.TP_TOWERS``, the towers; expert
parallelism), the collectives GSPMD would insert (``collectives``), ZeRO-1
(``zero``), gallery-sharded evaluation (``sharded_eval``), the GPipe
schedule (``pipeline``) and the multi-rank dry run (``dryrun``);
``launch.spawn`` runs a function on a fresh group of several ranks.
"""

from .dist import init_distributed, is_main, rank, rank_device, world_size
from .mesh import (
    Mesh, ModelAxis, Split, batch_mesh, full_state_dict, gather_whole, global_batch,
    load_full_state_dict, make_mesh, mesh_from_cfg, model_specs, param_spec, replicated,
    shard_batch, shard_module, sharded_params,
)
from .sharded_eval import sharded_cmc_map, sharded_distmat, sharded_topk
from .zero import ZeroOptimizer, zero_sharded

__all__ = [
    "Mesh", "ModelAxis", "Split", "ZeroOptimizer", "batch_mesh", "full_state_dict",
    "gather_whole", "global_batch", "init_distributed", "is_main", "load_full_state_dict",
    "make_mesh", "mesh_from_cfg", "model_specs", "param_spec", "rank", "rank_device", "replicated",
    "shard_batch", "shard_module", "sharded_cmc_map", "sharded_distmat", "sharded_params",
    "sharded_topk", "world_size", "zero_sharded",
]
