"""GraphSAGE layer with mean/sum/max/gcn aggregators — the port of
``cogdl_tpu/layers/sage_layer.py``.

The neighbourhood reduction is ``ops.aggregate``: ``"sum"`` and ``"gcn"`` go
through ``spmm`` (the CUDA CSR kernel on the card), ``"mean"`` and ``"max"``
through torch index ops on any device. The parameters carry the flax names
(``W_self``, ``W_nbr``, or ``W`` for ``"gcn"``), so
``models.load_jax_params`` maps one tree onto the other.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.graph import Graph
from ..ops import aggregate
from .utils import CDense, dropout, get_activation

AGGREGATORS = ("mean", "sum", "max", "gcn")


class SAGELayer(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 aggr: str = "mean", normalize: bool = False,
                 dropout: float = 0.0, activation: Optional[str] = None):
        super().__init__()
        if aggr not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {aggr!r}: one of "
                             f"{AGGREGATORS}")
        self.aggr = aggr
        self.normalize = normalize
        self.dropout = dropout
        self.activation = activation
        if aggr == "gcn":
            self.W = CDense(in_features, out_features)
        else:
            self.W_self = CDense(in_features, out_features)
            self.W_nbr = CDense(in_features, out_features)

    def forward(self, graph: Graph, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.aggr == "gcn":
            out = self.W(aggregate(graph, x, "sum") + x)
        else:
            out = self.W_self(x) + self.W_nbr(aggregate(graph, x, self.aggr))
        if self.normalize:
            out = out * torch.rsqrt((out ** 2).sum(-1, keepdim=True) + 1e-12)
        if self.activation is not None:
            out = get_activation(self.activation)(out)
        if self.dropout > 0 and training:
            out = dropout(out, self.dropout, generator)
        return out
