"""SIGN — the port of ``cogdl_tpu/models/nn/sign.py``: ``num_hops`` steps of
the symmetric-normalised adjacency over the input features (K1 on the card,
forward only: the input takes no gradient), one encoder ``hop{i}`` a hop
with ReLU and dropout, their concatenation, and the classifier ``out``.

``adj_norm = "sym"`` is a class attribute, as in ``models/nn/sgc.py``: the
wrapper normalises before it builds the kernels' structure, and the
model's own ``sym_norm`` is then a no-op by the graph's tag."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers.utils import CDense, dropout, reset_parameters
from ...ops import spmm


class SIGN(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_hops: int = 3,
                 dropout: float = 0.5):
        super().__init__()
        self.num_hops = num_hops
        self.calls_spmm = num_hops > 0
        self.dropout = dropout
        for i in range(num_hops + 1):
            self.add_module(f"hop{i}", CDense(in_features, hidden_size))
        self.out = CDense(hidden_size * (num_hops + 1), out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph = sym_norm(graph)
        hops = [x]
        for _ in range(self.num_hops):
            hops.append(spmm(graph, hops[-1]))
        encoded = []
        for i, h in enumerate(hops):
            e = torch.relu(getattr(self, f"hop{i}")(h))
            if self.dropout > 0 and training:
                e = dropout(e, self.dropout, generator)
            encoded.append(e)
        return self.out(torch.cat(encoded, -1))
