"""HAN — heterogeneous graph attention network over metapath graphs — the
port of ``cogdl_tpu/models/nn/han.py`` (reference cogdl/models/nn/han.py).

``num_layers`` HAN layers (K3 over each metapath graph on the card), then
the ``out`` projection. The metapath graphs come from the graph's
``extras["metapath_graphs"]``, or as a sequence in place of the graph."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph
from ...layers import HANLayer
from ...layers.utils import CDense, reset_parameters


def _metapath_graphs(graphs, key: str):
    """The per-metapath graphs: ``graphs.extras[key]`` of a Graph, else the
    sequence itself; and the features ``x`` defaults to."""
    if isinstance(graphs, Graph):
        return list(graphs.extras[key]), graphs.x
    gs = list(graphs)
    return gs, gs[0].x


class HAN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 8, nhead: int = 8, num_metapaths: int = 2,
                 num_layers: int = 1, dropout: float = 0.5):
        super().__init__()
        self.in_features = in_features
        self.hidden_size = hidden_size
        self.nhead = nhead
        self.num_layers = num_layers
        self.dropout = dropout
        self._build_layers(num_metapaths)
        self.out = CDense(hidden_size * nhead, out_features)

    def _build_layers(self, num_metapaths: int):
        self.num_metapaths = num_metapaths
        width = self.in_features
        for i in range(self.num_layers):
            self.add_module(f"han{i}", HANLayer(
                width, self.hidden_size, nhead=self.nhead,
                num_metapaths=num_metapaths, dropout=self.dropout))
            width = self.hidden_size * self.nhead

    def fit_graph(self, graph: Graph) -> None:
        """Rebuild the layers for the graph's count of metapaths (flax
        sizes them at the first call); the wrapper calls it before
        initialising the parameters."""
        m = len(graph.extras["metapath_graphs"])
        if m != self.num_metapaths:
            self._build_layers(m)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graphs, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gs, x0 = _metapath_graphs(graphs, "metapath_graphs")
        if x is None:
            x = x0
        for i in range(self.num_layers):
            x = getattr(self, f"han{i}")(gs, x, training, generator)
        return self.out(x)
