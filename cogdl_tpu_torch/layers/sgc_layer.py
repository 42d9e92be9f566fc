"""SGC layer: ``order`` propagation steps, then one linear map — the port
of ``cogdl_tpu/layers/sgc_layer.py``. Each step is ``ops.spmm`` (K1 on the
card)."""

from __future__ import annotations

import torch
from torch import nn

from ..data.graph import Graph
from ..ops import spmm
from .utils import CDense


class SGCLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int, order: int = 2):
        super().__init__()
        self.order = order
        self.calls_spmm = order > 0
        self.W = CDense(in_features, out_features)

    def forward(self, graph: Graph, x: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        for _ in range(self.order):
            x = spmm(graph, x)
        return self.W(x)
