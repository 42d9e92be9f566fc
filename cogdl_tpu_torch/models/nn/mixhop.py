"""MixHop — the port of ``cogdl_tpu/models/nn/mixhop.py``: ``num_layers``
MixHop layers ``layer{i}`` (K1 on the card, ``hidden_size`` per power),
each after dropout and before tanh, then ``fc_out``. ``adj_norm = "sym"``
is a class attribute, as in ``models/nn/sgc.py``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import MixHopLayer
from ...layers.utils import CDense, dropout, reset_parameters


class MixHop(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.7, powers: Sequence[int] = (0, 1, 2)):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        width = in_features
        for i in range(num_layers):
            self.add_module(f"layer{i}",
                            MixHopLayer(width, hidden_size, powers=powers))
            width = hidden_size * len(powers)
        self.fc_out = CDense(width, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph = sym_norm(graph)
        drop = self.dropout if training else 0.0
        for i in range(self.num_layers):
            x = torch.tanh(getattr(self, f"layer{i}")(
                graph, dropout(x, drop, generator), training))
        return self.fc_out(x)
