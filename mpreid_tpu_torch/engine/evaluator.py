"""R1/mAP evaluator — feature accumulation + metrics on the device.

ref mpreid_tpu/engine/evaluator.py::R1mAPEvaluator. Accumulate (features,
pids, camids) per batch, L2-normalise (``TEST.FEAT_NORM``), split query =
first ``num_query`` rows, distmat (or k-reciprocal re-ranking), CMC/mAP.
``compute`` returns the reference's 7-tuple (cmc, mAP, distmat, pids,
camids, qf, gf) as numpy.

Feature tensors stay on their device; numpy features go to ``device``, the
card unless the caller asks for the CPU (``utils/device.py::resolve_device``
raises without a card rather than compute on the CPU unasked). With
``reranking``, corpora of at most ``rerank_sparse_n`` rows take the dense
re-ranking (``rerank_fast``: the quantized min-sum), larger ones the
sparse-V re-ranking with the quantized min-sum.

Spans (``utils/tracing.py``, recorded under a profiler): ``evaluator.update``
a batch's features kept; ``evaluator.compute``, and inside it
``evaluator.distances`` (the distances or the re-ranking),
``evaluator.cmc_map`` (the labels' upload, CMC and mAP) and
``evaluator.fetch`` (the results copied to the host).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from mpreid_tpu_torch.ops import (
    cmc_map, cosine_distmat, euclidean_squared_distmat, re_ranking, re_ranking_sparse,
)
from mpreid_tpu_torch.utils.device import resolve_device
from mpreid_tpu_torch.utils.tracing import span


class R1mAPEvaluator:
    def __init__(self, num_query: int, max_rank: int = 50, feat_norm: bool = True,
                 reranking: bool = False, camera_filter: bool = False, rerank_k1: int = 50,
                 rerank_k2: int = 15, rerank_lambda: float = 0.3, rerank_fast: bool = False,
                 rerank_sparse_n: int = 25000, dist_metric: str = "euclidean",
                 device="cuda"):
        if dist_metric not in ("euclidean", "cosine"):
            raise ValueError(
                f"Unknown dist_metric {dist_metric!r}; expected 'euclidean' or 'cosine'"
            )
        self.num_query = num_query
        self.max_rank = max_rank
        self.feat_norm = feat_norm
        self.reranking = reranking
        self.camera_filter = camera_filter
        self.rerank_params = (rerank_k1, rerank_k2, rerank_lambda)
        self.rerank_fast = rerank_fast
        self.rerank_sparse_n = rerank_sparse_n
        self.dist_metric = dist_metric
        self.device = device
        self.reset()

    def reset(self):
        self.feats: List[torch.Tensor] = []
        self.pids: List[np.ndarray] = []
        self.camids: List[np.ndarray] = []

    def update(self, output):
        with span("evaluator.update"):
            feat, pid, camid = output
            if not isinstance(feat, torch.Tensor):
                feat = torch.as_tensor(np.asarray(feat), device=resolve_device(self.device))
            self.feats.append(feat.float())
            self.pids.append(np.asarray(pid))
            self.camids.append(np.asarray(camid))

    def compute(self):
        with span("evaluator.compute"):
            return self._compute()

    def _compute(self):
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

        with span("evaluator.distances"):
            if self.reranking:
                k1, k2, lam = self.rerank_params
                if feats.shape[0] > self.rerank_sparse_n:
                    # corpora whose N×N matrices do not fit (MSMT17, N ≈ 94k)
                    distmat = re_ranking_sparse(qf, gf, k1=k1, k2=k2, lambda_value=lam,
                                                minsum="quantized")
                else:
                    distmat = re_ranking(qf, gf, k1=k1, k2=k2, lambda_value=lam,
                                         fast_minsum=self.rerank_fast)
            elif self.dist_metric == "cosine":
                distmat = cosine_distmat(qf, gf)
            else:
                distmat = euclidean_squared_distmat(qf, gf)

        def dev(a):
            return torch.as_tensor(a, device=distmat.device)

        with span("evaluator.cmc_map"):
            cmc, mAP = cmc_map(distmat, dev(q_pids), dev(g_pids), dev(q_camids),
                               dev(g_camids), max_rank=self.max_rank,
                               camera_filter=self.camera_filter)
        with span("evaluator.fetch"):
            return (
                cmc.cpu().numpy(),
                float(mAP),
                distmat.cpu().numpy(),
                pids,
                camids,
                qf.cpu().numpy(),
                gf.cpu().numpy(),
            )
