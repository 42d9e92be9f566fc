"""GNNGuard-GCN — the port of ``cogdl_tpu/models/nn/gnnguard.py``: before
each GCN layer ``layer{i}`` (K1 on the card) the adjacency is reweighted
from the current features (``utils.grb.gnnguard_reweight``), whose weights
carry the features' gradient. The layer's ``spmm`` reads those weights
through the one structure the wrapper built, and K1's ``dw`` reaches
them.

No ``adj_norm``: the wrapper leaves the self-loop graph's unit weights,
which the reweight replaces."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph
from ...layers import GCNLayer
from ...layers.utils import reset_parameters
from ...utils.grb import gnnguard_reweight


class GNNGuardGCN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.5, threshold: float = 0.1,
                 attention: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.threshold = threshold
        self.attention = attention
        width = in_features
        for i in range(num_layers):
            last = i == num_layers - 1
            out = out_features if last else hidden_size
            self.add_module(f"layer{i}", GCNLayer(
                width, out, dropout=0.0 if last else dropout,
                activation=None if last else "relu"))
            width = out

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        for i in range(self.num_layers):
            g = (gnnguard_reweight(graph, x, self.threshold)
                 if self.attention else graph)
            x = getattr(self, f"layer{i}")(g, x, training,
                                           generator=generator)
        return x
