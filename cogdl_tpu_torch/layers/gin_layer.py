"""GIN layer: ``(1 + eps)·x + Σ_neighbours x``, then ``fc1``, batch norm
over the real nodes, ReLU and ``fc2`` — the port of
``cogdl_tpu/layers/gin_layer.py``. The neighbour sum is ``ops.aggregate``'s
``"sum"``, which is ``spmm`` (K1 on the card)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.graph import Graph
from ..ops import aggregate
from .utils import CDense, MaskedBatchNorm


class GINLayer(nn.Module):
    # the neighbour sum is spmm: a graph batch needs K1's structure
    calls_spmm = True

    def __init__(self, in_features: int, out_features: int,
                 hidden_features: int = 0, eps: float = 0.0,
                 train_eps: bool = True, batchnorm: bool = True):
        super().__init__()
        self.eps_init = eps
        self.train_eps = train_eps
        self.batchnorm = batchnorm
        hidden = hidden_features or out_features
        if train_eps:
            self.eps = nn.Parameter(torch.tensor(float(eps)))
        self.fc1 = CDense(in_features, hidden)
        if batchnorm:
            self.bn = MaskedBatchNorm(hidden)
        self.fc2 = CDense(hidden, out_features)

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        if self.train_eps:
            with torch.no_grad():
                self.eps.fill_(self.eps_init)

    def forward(self, graph: Graph, x: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        eps = self.eps if self.train_eps else self.eps_init
        h = self.fc1((1.0 + eps) * x + aggregate(graph, x, "sum"))
        if self.batchnorm:
            h = self.bn(h, graph.node_mask(), use_running_average=not training)
        return self.fc2(F.relu(h))
