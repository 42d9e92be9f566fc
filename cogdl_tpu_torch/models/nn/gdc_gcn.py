"""GDC-GCN — the port of ``cogdl_tpu/models/nn/gdc_gcn.py``: ``GDCGCN`` is
the GCN with ``adj_norm = "none"`` (K1 on the card over the weights the
graph carries), and ``gdc_diffuse`` the host-side diffusion of the
adjacency (a dense N×N inverse: small graphs only).

``experiment()`` does not call ``gdc_diffuse``, in the JAX package as here:
the model then runs as an unnormalised GCN over the wrapper's self-loop
graph."""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ...data.graph import Graph, from_coo
from ..emb.base import graph_to_scipy
from .gcn import GCN


def gdc_diffuse(graph: Graph, alpha: float = 0.05, eps: float = 1e-4,
                method: str = "ppr") -> Graph:
    """Exact PPR diffusion ``S = α (I − (1 − α) T)⁻¹`` with ``T = A D⁻¹``
    (``method="ppr"``), or the heat kernel's series truncated at 10 terms,
    ``t = 5``; entries below ``eps`` dropped, the rest the new graph's
    weights, with ``graph``'s node data (on the CPU)."""
    A = graph_to_scipy(graph)
    N = A.shape[0]
    deg = np.asarray(A.sum(1)).ravel()
    T = A @ sp.diags(1.0 / np.maximum(deg, 1e-12))
    if method == "ppr":
        S = alpha * np.linalg.inv(np.eye(N) - (1 - alpha) * T.toarray())
    else:
        t = 5.0
        Td = T.toarray()
        S = np.zeros_like(Td)
        term = np.eye(N) * np.exp(-t)
        for k in range(10):
            S += term
            term = term @ Td * (t / (k + 1))
    S[S < eps] = 0.0
    r, c = np.nonzero(S)
    g = from_coo(np.stack([r, c]), num_nodes=N,
                 edge_weight=S[r, c].astype(np.float32),
                 meta=dict(graph.meta))

    def cut(a: torch.Tensor) -> torch.Tensor:
        return a.cpu()[: g.n_pad]

    return g.replace(x=cut(graph.x), y=cut(graph.y),
                     train_mask=cut(graph.train_mask),
                     val_mask=cut(graph.val_mask),
                     test_mask=cut(graph.test_mask))


class GDCGCN(GCN):
    """GCN over the weights the graph carries (``adj_norm = "none"``)."""

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.5, activation: str = "relu",
                 norm: Optional[str] = None, residual: bool = False,
                 adj_norm: str = "none", use_prop_cache: bool = True):
        super().__init__(in_features, out_features, hidden_size, num_layers,
                         dropout, activation, norm, residual, adj_norm,
                         use_prop_cache)
