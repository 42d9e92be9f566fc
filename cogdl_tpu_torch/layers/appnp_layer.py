"""APPNP propagation: personalised-PageRank smoothing of predictions,
``h_{k+1} = (1 − α)·Â h_k + α·h_0`` for ``k`` steps — the port of
``cogdl_tpu/layers/appnp_layer.py``, a Python loop of ``ops.spmm`` calls
(K1 on the card) in place of ``lax.scan``. No parameters."""

from __future__ import annotations

import torch
from torch import nn

from ..data.graph import Graph
from ..ops import spmm


class APPNPProp(nn.Module):
    def __init__(self, k: int = 10, alpha: float = 0.1):
        super().__init__()
        self.k = k
        self.alpha = alpha
        self.calls_spmm = k > 0

    def forward(self, graph: Graph, h: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        h0 = h
        for _ in range(self.k):
            h = (1 - self.alpha) * spmm(graph, h) + self.alpha * h0
        return h
