"""SAINT high-order aggregator layer — the port of
``cogdl_tpu/layers/saint_layer.py`` (``SAINTLayer``).

One layer computes the propagations ``[x, A·x, …, A^order·x]`` (each
``A·h`` through ``ops.spmm``, the CUDA CSR kernel on the card), gives each
order its own dense transform ``order{o}`` and the activation, then, with
``bias="norm"``, a LayerNorm ``norm{o}`` (eps 1e-6, the flax default), and
combines the orders by concatenation or mean. The submodule names are the
flax ones, so ``models.load_jax_params`` maps one tree onto the other.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.graph import Graph
from ..ops import spmm
from .utils import CDense, dropout, get_activation

AGGREGATIONS = ("concat", "mean")


class SAINTLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int, order: int = 1,
                 aggr: str = "concat", act: str = "relu", bias: str = "norm",
                 dropout: float = 0.1):
        super().__init__()
        if aggr not in AGGREGATIONS:
            raise ValueError(f"unknown aggr {aggr!r}: one of {AGGREGATIONS}")
        self.order = order
        self.aggr = aggr
        self.act = act
        self.bias = bias
        self.dropout = dropout
        for o in range(order + 1):
            self.add_module(f"order{o}", CDense(in_features, out_features))
            if bias == "norm":
                self.add_module(f"norm{o}",
                                nn.LayerNorm(out_features, eps=1e-6))

    @property
    def out_width(self) -> int:
        """The layer's output width: the orders side by side under
        ``concat``."""
        width = getattr(self, "order0").out_features
        return width * (self.order + 1) if self.aggr == "concat" else width

    def forward(self, graph: Graph, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = [x]
        h = x
        for _ in range(self.order):
            h = spmm(graph, h)
            feats.append(h)
        act = get_activation(self.act)
        outs = []
        for o, f in enumerate(feats):
            if self.dropout > 0 and training:
                f = dropout(f, self.dropout, generator)
            z = act(getattr(self, f"order{o}")(f))
            if self.bias == "norm":
                z = getattr(self, f"norm{o}")(z)
            outs.append(z)
        if self.aggr == "concat":
            return torch.cat(outs, dim=-1)
        return sum(outs) / len(outs)
