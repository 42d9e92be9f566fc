"""ProNE — the port of ``cogdl_tpu/models/emb/prone.py``: a sparse
factorisation (``top_svd`` of the shifted log transition matrix) and the
Chebyshev–Gaussian spectral propagation, whose eleven products run
through ``spmm`` (K1 on the card): ten over D⁻¹A, one over A, counted in
``stats["spmm_da"]`` and ``stats["spmm_a"]``. K1 computes
in float32 where the JAX package takes float64; the sums of the
Chebyshev terms stay float64."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ...data.graph import Graph, from_coo
from ...ops.cuda import prepare_spmm
from ...ops.spmm import spmm
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, graph_to_scipy, sparse_on, top_svd


def propagation_graphs(A: sp.csr_matrix, device) -> Tuple[Graph, Graph]:
    """``(D⁻¹A, A)`` as graphs on ``device`` over one K1 structure,
    prepared once with the weights of D⁻¹A; A's graph takes its own
    weights through :meth:`Graph.with_edge_weight`."""
    A = A.tocoo()
    g = from_coo(np.stack([A.row, A.col]), num_nodes=A.shape[0],
                 edge_weight=A.data).to(device)
    E = g.num_edges
    w = g.edge_weight[:E]
    d_inv = 1.0 / g.in_degrees(weighted=True)[: g.num_nodes].clamp_min(1e-12)
    w_da = torch.zeros_like(g.edge_weight)
    w_da[:E] = w * d_inv[g.row[:E].long()]
    da = prepare_spmm(g.with_edge_weight(w_da))
    return da, da.with_edge_weight(g.edge_weight)


class ProNE(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, step: int = 10,
                 mu: float = 0.2, theta: float = 0.5, seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.step = step
        self.mu = mu
        self.theta = theta

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        A = graph_to_scipy(graph)
        with self.stage("factorize", device):
            emb = self._factorize(A, device)
        with self.stage("propagate", device):
            return self._chebyshev(propagation_graphs(A, device), emb)

    def _factorize(self, A: sp.csr_matrix, device) -> torch.Tensor:
        """``top_svd`` of the sparse ``max(log P − log(d_col / vol), 0)``
        over the support of P = D⁻¹A."""
        deg = np.asarray(A.sum(1)).ravel()
        P = (sp.diags(1.0 / np.maximum(deg, 1e-12)) @ A).tocoo()
        vol = float(A.sum())
        col_deg = np.maximum(deg[P.col], 1e-12)
        vals = np.log(np.maximum(P.data, 1e-12)) - np.log(1.0 * col_deg / vol)
        M = sp.coo_matrix((np.maximum(vals, 0), (P.row, P.col)),
                          shape=A.shape)
        return top_svd(sparse_on(M, device), self.hidden_size, self.seed)

    def _chebyshev(self, graphs: Tuple[Graph, Graph],
                   emb: torch.Tensor) -> torch.Tensor:
        """g(λ) = e^{-½[(λ-μ)²-1]θ} in Chebyshev polynomials of
        ``M = (1 − μ)I − D⁻¹A`` with modified-Bessel coefficients
        I_k(θ), then ``A·(emb − conv)`` and the SVD renormalisation
        ``U·√Σ·Vᵀ`` in float64."""
        from scipy.special import iv

        da, a = graphs
        N = emb.shape[0]
        x = emb.new_zeros(da.n_pad, emb.shape[1], dtype=torch.float32)
        x[:N] = emb

        def M(v):
            self.stats["spmm_da"] = self.stats.get("spmm_da", 0) + 1
            return (1.0 - self.mu) * v - spmm(da, v)

        with torch.no_grad():
            Lx0, Lx1 = x, M(x)
            conv = (float(iv(0, self.theta)) * Lx0.double()
                    - 2 * float(iv(1, self.theta)) * Lx1.double())
            for k in range(2, self.step + 1):
                Lx2 = 2 * M(Lx1) - Lx0
                conv += ((-1) ** k) * 2 * float(iv(k, self.theta)) * \
                    Lx2.double()
                Lx0, Lx1 = Lx1, Lx2
            prop = spmm(a, (x.double() - conv).float())[:N].double()
        self.stats["spmm_a"] = self.stats.get("spmm_a", 0) + 1
        u, s, vt = torch.linalg.svd(prop, full_matrices=False)
        return (u * s.clamp_min(1e-12).sqrt()) @ vt
