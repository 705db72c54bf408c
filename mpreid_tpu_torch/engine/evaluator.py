"""R1/mAP evaluator — feature accumulation + metrics on the device.

ref mpreid_tpu/engine/evaluator.py::R1mAPEvaluator. Accumulate (features,
pids, camids) per batch, L2-normalise (``TEST.FEAT_NORM``), split query =
first ``num_query`` rows, distmat, CMC/mAP. ``compute`` returns the
reference's 7-tuple (cmc, mAP, distmat, pids, camids, qf, gf) as numpy.
Re-ranking belongs to a later slice.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from mpreid_tpu_torch.ops import cmc_map, cosine_distmat, euclidean_squared_distmat


class R1mAPEvaluator:
    def __init__(self, num_query: int, max_rank: int = 50, feat_norm: bool = True,
                 reranking: bool = False, camera_filter: bool = False,
                 dist_metric: str = "euclidean"):
        if reranking:
            raise NotImplementedError(
                "TEST.RE_RANKING is not ported yet (ROADMAP.md, A10 re-ranking)"
            )
        if dist_metric not in ("euclidean", "cosine"):
            raise ValueError(
                f"Unknown dist_metric {dist_metric!r}; expected 'euclidean' or 'cosine'"
            )
        self.num_query = num_query
        self.max_rank = max_rank
        self.feat_norm = feat_norm
        self.camera_filter = camera_filter
        self.dist_metric = dist_metric
        self.reset()

    def reset(self):
        self.feats: List[torch.Tensor] = []
        self.pids: List[np.ndarray] = []
        self.camids: List[np.ndarray] = []

    def update(self, output):
        feat, pid, camid = output
        # device tensors stay on the device until the distmat
        self.feats.append(torch.as_tensor(feat).float())
        self.pids.append(np.asarray(pid))
        self.camids.append(np.asarray(camid))

    def compute(self):
        feats = torch.cat(self.feats, dim=0)
        pids = np.concatenate(self.pids)
        camids = np.concatenate(self.camids)
        if self.feat_norm:
            feats = feats / torch.linalg.norm(feats, dim=1, keepdim=True)
        qf = feats[: self.num_query]
        gf = feats[self.num_query:]
        q_pids, g_pids = pids[: self.num_query], pids[self.num_query:]
        if not np.isin(q_pids, g_pids).any():
            raise AssertionError("Error: all query identities do not appear in gallery")
        q_camids, g_camids = camids[: self.num_query], camids[self.num_query:]

        if self.dist_metric == "cosine":
            distmat = cosine_distmat(qf, gf)
        else:
            distmat = euclidean_squared_distmat(qf, gf)

        def dev(a):
            return torch.as_tensor(a, device=distmat.device)

        cmc, mAP = cmc_map(distmat, dev(q_pids), dev(g_pids), dev(q_camids),
                           dev(g_camids), max_rank=self.max_rank,
                           camera_filter=self.camera_filter)
        return (
            cmc.cpu().numpy(),
            float(mAP),
            distmat.cpu().numpy(),
            pids,
            camids,
            qf.cpu().numpy(),
            gf.cpu().numpy(),
        )
