"""R-GCN for entity classification — the port of
``cogdl_tpu/models/nn/rgcn.py`` (reference cogdl/models/nn/rgcn.py):
``layer{i}`` RGCN layers over the typed union graph, relu between them, no
dropout after the last. No kernel of ours runs here."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph
from ...layers import RGCNLayer
from ...layers.utils import reset_parameters


class RGCN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 num_relations: int = 4, hidden_size: int = 64,
                 num_layers: int = 2, num_bases: int = 4,
                 dropout: float = 0.0, self_loop: bool = True):
        super().__init__()
        self.num_layers = num_layers
        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"layer{i}", RGCNLayer(
                width, hidden_size, num_relations, num_bases=num_bases,
                self_loop=self_loop, dropout=dropout))
            width = hidden_size
        self.add_module(f"layer{num_layers - 1}", RGCNLayer(
            width, out_features, num_relations, num_bases=num_bases,
            self_loop=self_loop))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"layer{i}")(graph, x, training,
                                                      generator))
        return getattr(self, f"layer{self.num_layers - 1}")(graph, x,
                                                            training)
