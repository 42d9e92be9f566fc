"""HOPE — the port of ``cogdl_tpu/models/emb/hope.py``: the Katz
proximity ``Σ_{t=1..9} (βA)^t`` formed densely in float64 on the device,
its top ``dim/2`` singular triplets by ARPACK (``svds``) over a linear
operator whose products run on the device, source and target halves
``U·√Σ`` and ``V·√Σ`` in ``svds``' ascending order."""

from __future__ import annotations

import numpy as np
import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, graph_to_scipy, sparse_on


def device_operator(K: torch.Tensor):
    """A float64 scipy ``LinearOperator`` of the dense ``K`` whose
    products (and adjoint products) run on ``K``'s device."""
    from scipy.sparse.linalg import LinearOperator

    def prod(M):
        def f(v):
            v = np.asarray(v)
            t = torch.from_numpy(np.ascontiguousarray(v)).to(K.device,
                                                             torch.float64)
            return (M @ t).cpu().numpy()
        return f

    return LinearOperator(K.shape, matvec=prod(K), rmatvec=prod(K.T),
                          matmat=prod(K), rmatmat=prod(K.T),
                          dtype=np.float64)


class HOPE(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, beta: float = 0.01,
                 seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.beta = beta

    def katz(self, graph: Graph, device) -> torch.Tensor:
        """``Σ_{t=1..9} (βA)^t`` over the directed adjacency, dense."""
        A = sparse_on(graph_to_scipy(graph, directed=True), device)
        term = (self.beta * A).to_dense()
        katz = term.clone()
        for _ in range(8):
            term = self.beta * torch.sparse.mm(A, term)
            katz += term
        return katz

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        from scipy.sparse.linalg import svds

        device = resolve_device(device)
        self.stats = {}
        N = graph.num_nodes
        with self.stage("factorize", device):
            K = self.katz(graph, device)
            k = min(self.hidden_size // 2, N - 2)
            u, s, vt = svds(device_operator(K), k=k)
            sq = torch.from_numpy(np.sqrt(np.maximum(s, 0))).to(device)
            src = torch.from_numpy(np.ascontiguousarray(u)).to(device)
            dst = torch.from_numpy(np.ascontiguousarray(vt.T)).to(device)
            src, dst = src * sq[None, :], dst * sq[None, :]
            return torch.cat([src, dst], 1).float()
