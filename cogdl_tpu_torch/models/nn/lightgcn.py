"""LightGCN — the port of ``cogdl_tpu/models/nn/lightgcn.py``: one learned
embedding a node, propagated ``num_layers`` times over the symmetrically
normalised user-item graph with no transform, and the mean of the
``num_layers + 1`` embeddings. The BPR training is the recommendation
wrapper's.

``adj_norm = "sym"`` and ``calls_spmm``: the JAX model normalises inside
its forward; here the wrapper normalises before it builds the kernels'
structure, so K1 reads the normalised weights and the forward's own
``sym_norm`` is free. Each propagation is one K1 call on the card, its
backward one K1 call over the transpose.

The embedding table is ``[n_pad, hidden_size]``, sized by the graph the
model is first initialised for (:meth:`reset_parameters` with ``graph``),
as the flax parameter takes its shape from the graph at ``init``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...ops import spmm


class LightGCN(nn.Module):
    adj_norm = "sym"
    calls_spmm = True

    def __init__(self, in_features: int = 0, out_features: int = 0,
                 num_nodes: int = 0, hidden_size: int = 64,
                 num_layers: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.emb = nn.Parameter(torch.empty(num_nodes, hidden_size))

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         graph: Optional[Graph] = None):
        """``emb`` from normal(0, 0.1), resized first to ``graph.n_pad``
        rows when ``graph`` is given."""
        if graph is not None and self.emb.shape[0] != graph.n_pad:
            self.emb = nn.Parameter(torch.empty(
                graph.n_pad, self.hidden_size, device=self.emb.device))
        with torch.no_grad():
            self.emb.normal_(0.0, 0.1, generator=generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.emb.shape[0] != graph.n_pad:
            raise ValueError(
                f"LightGCN's table has {self.emb.shape[0]} rows and the "
                f"graph {graph.n_pad}: initialise it for this graph "
                "(reset_parameters(generator, graph))")
        g = sym_norm(graph)
        acc = h = self.emb
        for _ in range(self.num_layers):
            h = spmm(g, h)
            acc = acc + h
        return acc / (self.num_layers + 1)
