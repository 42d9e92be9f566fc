"""NetSMF — the port of ``cogdl_tpu/models/emb/netsmf.py``: random-walk
path samples, drawn on the device, give a sparse log-PMI matrix, which
``top_svd`` embeds with sparse products."""

from __future__ import annotations

import numpy as np
import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, top_svd
from .walks import build_csr


class NetSMF(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, window_size: int = 5,
                 num_rounds: int = 100, negative: int = 1, seed: int = 0,
                 **kw):
        super().__init__(hidden_size, seed)
        self.window_size = window_size
        self.num_rounds = num_rounds
        self.negative = negative

    def sample_paths(self, graph: Graph, device):
        """Each round, one path from each of N uniform start nodes, of a
        uniform length in ``[1, window]``: ``(starts, ends)`` on
        ``device``, and the CSR's true degrees."""
        indptr, indices = build_csr(graph)
        N = graph.num_nodes
        E = indices.shape[0]
        ptr = torch.from_numpy(indptr).to(device)
        idx = torch.from_numpy(indices).to(device)
        true_deg = ptr[1:] - ptr[:-1]
        deg = true_deg.clamp_min(1)
        draws = self.make_draws("paths", self.seed, device)
        rows, cols = [], []
        for _ in range(self.num_rounds):
            u = draws.integers(0, N, (N,))
            r = draws.integers(1, self.window_size + 1, (N,))
            cur = u.clone()
            for step in range(self.window_size):
                d = deg[cur]
                off = (draws.random((N,)) * d).long()
                pos = (ptr[cur] + torch.minimum(off, d - 1)).clamp_max(
                    max(E - 1, 0))
                nxt = idx[pos] if E else cur
                cur = torch.where((step < r) & (true_deg[cur] > 0), nxt, cur)
            rows.append(u)
            cols.append(cur)
        return torch.cat(rows), torch.cat(cols), deg, E

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        N = graph.num_nodes
        with self.stage("walks", device):
            r_idx, c_idx, deg, E = self.sample_paths(graph, device)
        with self.stage("factorize", device):
            # M + Mᵀ of the path counts, then the log-PMI scaling
            idx = torch.stack([torch.cat([r_idx, c_idx]),
                               torch.cat([c_idx, r_idx])])
            M = torch.sparse_coo_tensor(
                idx, torch.ones(idx.shape[1], device=device), (N, N),
                check_invariants=False).coalesce()
            row, col = M.indices()
            # counts · vol in float32, over an int64 denominator
            scaled = (M.values() * np.float32(E)).double()
            vals = scaled / (self.num_rounds * 2 * self.negative
                             * deg[row] * deg[col]).double()
            Ms = torch.sparse_coo_tensor(
                M.indices(), torch.log(vals.clamp_min(1.0)), (N, N),
                check_invariants=False)
            return top_svd(Ms, self.hidden_size, self.seed)
