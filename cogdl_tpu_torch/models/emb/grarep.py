"""GraRep — the port of ``cogdl_tpu/models/emb/grarep.py``: the k-step
transition matrices ``(D⁻¹A)^k`` formed densely in float64 on the device,
each ``max(log P^k − log(1/N), 0)`` embedded by ``top_svd``."""

from __future__ import annotations

import math

import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, dense_on, graph_to_scipy, top_svd


class GraRep(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, step: int = 4, seed: int = 0,
                 **kw):
        super().__init__(hidden_size, seed)
        self.step = step

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        A = graph_to_scipy(graph)
        N = A.shape[0]
        per = max(self.hidden_size // self.step, 8)
        embs = []
        with self.stage("factorize", device):
            Ad = dense_on(A, device)
            P = Ad / Ad.sum(1, keepdim=True).clamp_min(1e-12)
            del Ad
            Pk = None
            for _ in range(self.step):
                Pk = P.clone() if Pk is None else Pk @ P
                # zero entries (off the sparse support) give log 1e-12 +
                # log N < 0, clipped to 0 as the sparse form leaves them
                M = (torch.log(Pk.clamp_min(1e-12))
                     - math.log(1.0 / max(N, 1))).clamp_min_(0.0)
                embs.append(top_svd(M, per, self.seed))
                del M
            return torch.cat(embs, 1).float()
