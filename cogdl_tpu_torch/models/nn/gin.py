"""GIN for graph classification — the port of
``cogdl_tpu/models/nn/gin.py``.

Reads a union batch (``data.batch``) and pools each layer's output, the
input features included, per graph with a segment sum (or mean) over
``extras["graph_id"]``; one ``readout{i}`` dense layer a pooled output, the
scores summed. Without ``graph_id`` the logits are per node. Each GIN
layer's neighbour sum is ``spmm`` (K1 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...layers import GINLayer
from ...layers.utils import CDense, dropout, reset_parameters
from ...ops import segment as seg


def graph_pool(graph: Graph, h: torch.Tensor, how: str = "sum"):
    """``h`` pooled per graph of a union batch (``[num_graphs, F]``), or
    ``h`` itself for a graph without ``graph_id``."""
    graph_id = graph.extras.get("graph_id") if graph.extras else None
    if graph_id is None:
        return h
    num_graphs = graph.meta_get("num_graphs", 1)
    if how == "mean":
        return seg.segment_mean(h, graph_id, num_graphs)
    return seg.segment_sum(h, graph_id, num_graphs)


class GIN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 32, num_layers: int = 3,
                 num_mlp_layers: int = 2, eps: float = 0.0,
                 train_eps: bool = True, dropout: float = 0.5,
                 pooling: str = "sum"):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.pooling = pooling
        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"gin{i}", GINLayer(width, hidden_size, eps=eps,
                                                train_eps=train_eps))
            width = hidden_size
        for i in range(num_layers):
            self.add_module(f"readout{i}", CDense(
                in_features if i == 0 else hidden_size, out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        outputs, h = [x], x
        for i in range(self.num_layers - 1):
            h = F.relu(getattr(self, f"gin{i}")(graph, h, training))
            outputs.append(h)
        score = 0.0
        for i, h_i in enumerate(outputs):
            out = getattr(self, f"readout{i}")(
                graph_pool(graph, h_i, self.pooling))
            if self.dropout > 0 and training:
                out = dropout(out, self.dropout, generator)
            score = score + out
        return score
