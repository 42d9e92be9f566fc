"""NetMF — the port of ``cogdl_tpu/models/emb/netmf.py``: the closed-form
DeepWalk matrix ``M = vol/(b·T) Σ_t (D⁻¹A)^t D⁻¹``, embedded by
``top_svd(log⁺ M)``. The small path (N ≤ 20,000) forms the power sum
densely in float64 on the device; the large one takes ``eigsh`` on the
host, as the JAX package calls it, and the rest on the device."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, dense_on, graph_to_scipy, top_svd

# the largest graph the dense power sum takes
DENSE_NODES = 20000


class NetMF(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, window_size: int = 5,
                 negative: int = 1, is_large: bool = False, rank: int = 256,
                 seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.window_size = window_size
        self.negative = negative
        self.is_large = is_large
        self.rank = rank

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        A = graph_to_scipy(graph)
        with self.stage("factorize", device):
            if self.is_large or A.shape[0] > DENSE_NODES:
                return self._large(A, device)
            Ad = dense_on(A, device)
            vol = Ad.sum()
            d_inv = 1.0 / Ad.sum(1).clamp_min(1e-12)
            P = d_inv[:, None] * Ad            # D⁻¹A
            del Ad
            S, Pt = P.clone(), P
            for _ in range(self.window_size - 1):
                Pt = Pt @ P
                S += Pt
            del P, Pt
            S *= (vol / (self.negative * self.window_size)) * d_inv[None, :]
            logM = torch.log(S.clamp_min_(1.0))
            return top_svd(logM, self.hidden_size, self.seed)

    def _large(self, A: sp.csr_matrix, device) -> torch.Tensor:
        """The eigen-approximation: the ``rank`` eigenpairs of
        ``D^-½ A D^-½`` of largest magnitude (ARPACK on the host), their
        values filtered by ``(1/T) Σ_t λ^t``."""
        from scipy.sparse.linalg import eigsh

        N = A.shape[0]
        vol = float(A.sum())
        d_inv = 1.0 / np.maximum(np.asarray(A.sum(1)).ravel(), 1e-12)
        Dn = sp.diags(np.sqrt(d_inv))
        vals, vecs = eigsh(Dn @ A @ Dn, k=min(self.rank, N - 2))
        vals = torch.from_numpy(np.clip(vals, -1.0, 1.0)).to(device,
                                                              torch.float64)
        filt, acc = vals.clone(), vals.clone()
        for _ in range(self.window_size - 1):
            acc = acc * vals
            filt += acc
        filt = (filt / self.window_size).clamp_min(0.0)
        U = (torch.from_numpy(np.sqrt(d_inv)).to(device, torch.float64)[:, None]
             * torch.from_numpy(vecs).to(device, torch.float64)
             * filt.sqrt()[None, :])
        M = (vol / self.negative) * (U @ U.T)
        logM = torch.log(M.clamp_min_(1.0))
        return top_svd(logM, self.hidden_size, self.seed)
