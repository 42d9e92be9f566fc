"""GCNII layer: initial residual and identity mapping — the port of
``cogdl_tpu/layers/gcnii_layer.py``:
``support = (1 − α)·Â x + α·h0``, ``out = (1 − β)·support + β·W support``
(``W`` without bias), plus ``x`` under ``residual``. ``Â x`` is
``ops.spmm`` (K1 on the card)."""

from __future__ import annotations

import torch
from torch import nn

from ..data.graph import Graph
from ..ops import spmm
from .utils import CDense


class GCNIILayer(nn.Module):
    calls_spmm = True

    def __init__(self, features: int, alpha: float = 0.1, beta: float = 1.0,
                 residual: bool = False):
        super().__init__()
        self.alpha = alpha
        self.beta = beta
        self.residual = residual
        self.W = CDense(features, features, bias=False)

    def forward(self, graph: Graph, x: torch.Tensor, h0: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        support = (1 - self.alpha) * spmm(graph, x) + self.alpha * h0
        out = (1 - self.beta) * support + self.beta * self.W(support)
        if self.residual:
            out = out + x
        return out
