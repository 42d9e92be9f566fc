"""Graph-agnostic MLP baseline — the port of ``cogdl_tpu/models/nn/mlp.py``:
the ``MLP`` block ``mlp`` over the node features; the graph is not read."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...layers import MLP
from ...layers.utils import reset_parameters


class MLPModel(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.5, norm: Optional[str] = None):
        super().__init__()
        self.mlp = MLP(in_features, out_features, hidden_features=hidden_size,
                       num_layers=num_layers, dropout=dropout, norm=norm)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        return self.mlp(x, training, generator)
