"""APPNP / PPNP — the port of ``cogdl_tpu/models/nn/appnp.py``: the MLP
``predictor`` over the (dropped-out) features, then ``propagation_steps``
steps of personalised-PageRank propagation (``APPNPProp``, K1 on the card).
``adj_norm = "sym"`` is a class attribute, as in ``models/nn/sgc.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import MLP, APPNPProp
from ...layers.utils import dropout, reset_parameters


class APPNP(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.5, propagation_steps: int = 10,
                 alpha: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.predictor = MLP(in_features, out_features,
                             hidden_features=hidden_size,
                             num_layers=num_layers, dropout=dropout)
        self.prop = APPNPProp(k=propagation_steps, alpha=alpha)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph = sym_norm(graph)
        if self.dropout > 0 and training:
            x = dropout(x, self.dropout, generator)
        h = self.predictor(x, training, generator)
        return self.prop(graph, h, training)
