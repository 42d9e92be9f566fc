"""DropEdge-GCN — the port of ``cogdl_tpu/models/nn/dropedge_gcn.py``: a GCN
stack ``layer{i}`` whose training forward drops edges and normalises the
dropped weights again every step (``sym_norm(drop_edge(graph))``), and
whose evaluation normalises the graph as it is.

It declares no ``adj_norm``: the wrapper leaves the self-loop graph's raw
weights, which the training branch drops before it normalises. Both
branches change a prepared graph's weights, and the kernels' structure
takes the new ones (``Graph.with_edge_weight``): K1 reads the dropped,
normalised weights of the step, its topology built once."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import reset_parameters
from ...utils import transforms


class DropEdgeGCN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 4,
                 dropout: float = 0.5, dropedge_rate: float = 0.2,
                 norm: Optional[str] = None):
        super().__init__()
        self.num_layers = num_layers
        self.dropedge_rate = dropedge_rate
        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"layer{i}", GCNLayer(
                width, hidden_size, dropout=dropout, activation="relu",
                norm=norm))
            width = hidden_size
        self.add_module(f"layer{num_layers - 1}",
                        GCNLayer(width, out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        if training and self.dropedge_rate > 0:
            g = sym_norm(transforms.drop_edge(graph, self.dropedge_rate,
                                              generator))
        else:
            g = sym_norm(graph)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(g, x, training,
                                           generator=generator)
        return x
