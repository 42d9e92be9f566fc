"""GRAND — the port of ``cogdl_tpu/models/nn/grand.py``: the mean of
``order + 1`` propagation steps of the symmetric-normalised adjacency (K1
on the card, forward only: the input takes no gradient), after DropNode in
training, then input dropout and the two-layer MLP ``mlp``.

Only what the JAX model computes is ported: the ``sample``, ``tem`` and
``lam`` of its best configuration have no reader there (no consistency
loss), and none here. ``adj_norm = "sym"`` is a class attribute, as in
``models/nn/sgc.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import MLP
from ...layers.utils import dropout, reset_parameters
from ...ops import spmm
from ...utils.transforms import drop_node


class Grand(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 32, order: int = 8,
                 input_dropout: float = 0.5, hidden_dropout: float = 0.5,
                 dropnode_rate: float = 0.5):
        super().__init__()
        self.order = order
        self.calls_spmm = order > 0
        self.input_dropout = input_dropout
        self.dropnode_rate = dropnode_rate
        self.mlp = MLP(in_features, out_features, hidden_features=hidden_size,
                       num_layers=2, dropout=hidden_dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def propagate(self, graph: Graph, h: torch.Tensor) -> torch.Tensor:
        """The mean of ``h`` and its ``order`` propagations."""
        acc = h
        for _ in range(self.order):
            h = spmm(graph, h)
            acc = acc + h
        return acc / (self.order + 1)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph = sym_norm(graph)
        if training:
            x = drop_node(x, self.dropnode_rate, generator)
        x = self.propagate(graph, x)
        if self.input_dropout > 0 and training:
            x = dropout(x, self.input_dropout, generator)
        return self.mlp(x, training, generator)
