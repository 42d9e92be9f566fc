"""Spectral embedding — the port of ``cogdl_tpu/models/emb/spectral.py``:
the eigenvectors of the normalised Laplacian ``I − D^-½AD^-½`` nearest 0,
by a dense float64 ``eigh`` on the device (the JAX package's
``eigsh(L, k, sigma=0)`` asks for the same pairs; the Laplacian is
positive semi-definite, so they are the k smallest, in ascending order)."""

from __future__ import annotations

import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, dense_on, graph_to_scipy


class Spectral(EmbeddingModel):
    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        A = graph_to_scipy(graph)
        N = A.shape[0]
        with self.stage("factorize", device):
            Ad = dense_on(A, device)
            dn = 1.0 / torch.sqrt(Ad.sum(1).clamp_min(1e-12))
            L = -(dn[:, None] * Ad * dn[None, :])
            del Ad
            L.diagonal().add_(1.0)
            vals, vecs = torch.linalg.eigh(L)
            k = min(self.hidden_size, N - 2)
            self.eigenvalues = vals[:k]
            return vecs[:, :k].float()
