"""Deep Graph Kernel — the port of ``cogdl_tpu/models/emb/dgk.py``: the
Weisfeiler-Lehman bucket counts of graph2vec (host hashes, counts on the
device), a substructure similarity from their co-occurrence, the positive
PMI ``M = log max(C·Σ / (p pᵀ), 1)`` with ``C = countsᵀ·counts``, and the
kernel features ``counts·M`` through a truncated SVD. The products run in
float64 on the device; the features go to ``top_svd`` in float32, the
JAX model's dtype."""

from __future__ import annotations

from typing import List

import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, top_svd
from .graph2vec import bucket_counts


class DeepGraphKernel(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, wl_iterations: int = 2,
                 dim_buckets: int = 1024, seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.wl_iterations = wl_iterations
        self.dim_buckets = dim_buckets

    def train_graph_embeddings(self, graphs: List[Graph],
                               device=None) -> torch.Tensor:
        """``float32 [G, min(hidden_size, min(G, buckets) − 1)]`` (at
        least 2)."""
        device = resolve_device(device)
        self.stats = {}
        with self.stage("wl", device):
            counts = bucket_counts(graphs, self.wl_iterations,
                                   self.dim_buckets, device).double()
        with self.stage("factorize", device):
            C = counts.T @ counts
            tot = C.sum().clamp_min(1.0)
            p = C.sum(1).clamp_min(1.0)
            M = torch.log((C * tot / torch.outer(p, p)).clamp_min(1.0))
            K = (counts @ M).float()
            k = min(self.hidden_size, min(K.shape) - 1)
            return top_svd(K, max(k, 2), self.seed)
