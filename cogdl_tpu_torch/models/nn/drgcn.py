"""DrGCN / DrGAT — dimensional reweighting — the port of
``cogdl_tpu/models/nn/drgcn.py``: an ``SELayer`` recalibrates the feature
channels before each GCN (``se{i}``, ``gcn{i}``; K1 on the card) or GAT
layer (``se1``, ``gat1``, ``se2``, ``gat2``; K3 on the card).

DrGCN carries ``adj_norm = "sym"`` as a class attribute, as in
``models/nn/sgc.py``. DrGAT reads the graph as it comes, as the JAX model
does, and has no ``adj_norm``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GATLayer, GCNLayer, SELayer
from ...layers.utils import reset_parameters


class DrGCN(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.5):
        super().__init__()
        self.num_layers = num_layers
        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"se{i}", SELayer(width))
            self.add_module(f"gcn{i}", GCNLayer(
                width, hidden_size, dropout=dropout, activation="relu"))
            width = hidden_size
        self.add_module(f"se{num_layers - 1}", SELayer(width))
        self.add_module(f"gcn{num_layers - 1}",
                        GCNLayer(width, out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph = sym_norm(graph)
        for i in range(self.num_layers):
            x = getattr(self, f"se{i}")(x, training)
            x = getattr(self, f"gcn{i}")(graph, x, training,
                                         generator=generator)
        return x


class DrGAT(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 8, nhead: int = 8, dropout: float = 0.6):
        super().__init__()
        self.se1 = SELayer(in_features)
        self.gat1 = GATLayer(in_features, hidden_size, nhead=nhead,
                             attn_drop=dropout, activation="elu", concat=True)
        self.se2 = SELayer(hidden_size * nhead)
        self.gat2 = GATLayer(hidden_size * nhead, out_features, nhead=1,
                             attn_drop=dropout, concat=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        x = self.gat1(graph, self.se1(x, training), training, generator)
        return self.gat2(graph, self.se2(x, training), training, generator)
