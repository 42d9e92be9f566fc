"""PPRGo — the port of ``cogdl_tpu/models/nn/pprgo.py``: the MLP ``mlp`` over
the node features, its logits then aggregated over the graph's weighted
adjacency (K1 on the card at the class width).

``topk_ppr_graph`` builds the top-k personalised-PageRank graph on the
host (a push loop a source node, for small graphs). ``experiment()`` does
not call it, in the JAX package as here: the model then aggregates over
the wrapper's self-loop graph with its raw weights (no ``adj_norm``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...data.graph import Graph, from_coo
from ...layers import MLP
from ...layers.utils import reset_parameters
from ...ops import spmm
from ..emb.base import graph_to_scipy


def topk_ppr_graph(graph: Graph, alpha: float = 0.25, eps: float = 1e-4,
                   topk: int = 32) -> Graph:
    """Push-flow PPR (Andersen et al.) from every node on the host, each
    node's ``topk`` largest scores kept as a graph whose edge weights are
    the scores, with ``graph``'s node data (on the CPU)."""
    A = graph_to_scipy(graph)
    N = A.shape[0]
    deg = np.asarray(A.sum(1)).ravel()
    indptr, indices = A.indptr, A.indices
    rows, cols, vals = [], [], []
    for s in range(N):
        p = {}
        r = {s: 1.0}
        frontier = [s]
        while frontier:
            u = frontier.pop()
            ru = r.get(u, 0.0)
            if ru < eps * max(deg[u], 1.0):
                continue
            p[u] = p.get(u, 0.0) + alpha * ru
            push = (1 - alpha) * ru / max(deg[u], 1.0)
            r[u] = 0.0
            for v in indices[indptr[u]: indptr[u + 1]]:
                r[v] = r.get(v, 0.0) + push
                if r[v] >= eps * max(deg[v], 1.0):
                    frontier.append(v)
        top = sorted(p.items(), key=lambda kv: -kv[1])[:topk]
        for v, val in top:
            rows.append(s)
            cols.append(v)
            vals.append(val)
    g = from_coo(np.stack([np.asarray(rows), np.asarray(cols)]),
                 num_nodes=N, edge_weight=np.asarray(vals, np.float32),
                 meta=dict(graph.meta))
    x = graph.x.cpu()
    return g.replace(x=x[: g.n_pad] if x.shape[0] >= g.n_pad else x,
                     y=graph.y.cpu(), train_mask=graph.train_mask.cpu(),
                     val_mask=graph.val_mask.cpu(),
                     test_mask=graph.test_mask.cpu())


class PPRGo(nn.Module):
    calls_spmm = True

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.1, alpha: float = 0.25):
        super().__init__()
        self.alpha = alpha
        self.mlp = MLP(in_features, out_features, hidden_features=hidden_size,
                       num_layers=num_layers, dropout=dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        return spmm(graph, self.mlp(x, training, generator))
