"""GCNII — the port of ``cogdl_tpu/models/nn/gcnii.py``: ``fc_in``, then
``num_layers`` GCNII layers ``layer{i}`` (K1 on the card) with
``β_i = log(λ / (i + 1) + 1)``, each followed by ReLU, then ``fc_out``;
dropout before every dense or graph layer. ``adj_norm = "sym"`` is a class
attribute, as in ``models/nn/sgc.py``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNIILayer
from ...layers.utils import CDense, dropout, reset_parameters


class GCNII(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 16,
                 dropout: float = 0.5, alpha: float = 0.1, lmbda: float = 0.5):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.fc_in = CDense(in_features, hidden_size)
        for i in range(num_layers):
            self.add_module(f"layer{i}", GCNIILayer(
                hidden_size, alpha=alpha, beta=math.log(lmbda / (i + 1) + 1)))
        self.fc_out = CDense(hidden_size, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph = sym_norm(graph)
        drop = self.dropout if training else 0.0
        h = torch.relu(self.fc_in(dropout(x, drop, generator)))
        h0 = h
        for i in range(self.num_layers):
            h = dropout(h, drop, generator)
            h = torch.relu(getattr(self, f"layer{i}")(graph, h, h0, training))
        return self.fc_out(dropout(h, drop, generator))
