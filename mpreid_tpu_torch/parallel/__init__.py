"""The parallel modes of the port over ``torch.distributed``: the data axis.

ref mpreid_tpu/parallel/__init__.py. Ported: the process group
(``dist.init_distributed``, the counterpart of ``mesh.init_distributed``),
the mesh and its placement rules (``mesh``), the collectives GSPMD would
insert (``collectives``), ZeRO-1 (``zero``) and gallery-sharded evaluation
(``sharded_eval``); ``launch.spawn`` runs a function on a fresh group of
several ranks. Not yet ported (the model-axis slice, ROADMAP A.11b): tensor
and expert parallelism over ``MESH_MODEL``, ``TPU.TP_TOWERS`` and the GPipe
schedule (``pipeline.py``).
"""

from .dist import init_distributed, is_main, rank, rank_device, world_size
from .mesh import (
    Mesh, batch_mesh, global_batch, make_mesh, mesh_from_cfg, param_spec, replicated,
    shard_batch,
)
from .sharded_eval import sharded_cmc_map, sharded_distmat, sharded_topk
from .zero import ZeroOptimizer, zero_sharded

__all__ = [
    "Mesh", "ZeroOptimizer", "batch_mesh", "global_batch", "init_distributed", "is_main",
    "make_mesh", "mesh_from_cfg", "param_spec", "rank", "rank_device", "replicated",
    "shard_batch", "sharded_cmc_map", "sharded_distmat", "sharded_topk", "world_size",
    "zero_sharded",
]
