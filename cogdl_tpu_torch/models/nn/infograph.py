"""InfoGraph — the port of ``cogdl_tpu/models/nn/infograph.py``:
unsupervised whole-graph embeddings from the mutual information between
node and graph summaries. GIN layers (``gin{i}``, ReLU after each) over a
union batch, every layer's output concatenated per node and summed per
graph; ``local_d`` and ``global_d`` score each (node, graph) pair. Each
GIN layer's neighbour sum is K1 on the card over the batch's structure.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...layers import GINLayer
from ...layers.utils import CDense, reset_parameters
from ...ops import segment as seg


class InfoGraph(nn.Module):
    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 32, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        width = in_features
        for i in range(num_layers):
            self.add_module(f"gin{i}", GINLayer(width, hidden_size))
            width = hidden_size
        self.local_d = CDense(hidden_size * num_layers, hidden_size)
        self.global_d = CDense(hidden_size * num_layers, hidden_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def encode(self, graph: Graph, x: torch.Tensor, training: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Node embeddings ``[n_pad, L·H]`` and their per-graph sums
        ``[num_graphs, L·H]``."""
        hs, h = [], x
        for i in range(self.num_layers):
            h = F.relu(getattr(self, f"gin{i}")(graph, h, training))
            hs.append(h)
        node_h = torch.cat(hs, -1)
        graph_h = seg.segment_sum(node_h, graph.extras["graph_id"],
                                  graph.meta_get("num_graphs", 1))
        return node_h, graph_h

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encode(graph, graph.x if x is None else x, training)[1]

    def mi_scores(self, graph: Graph, x: torch.Tensor,
                  training: bool = True) -> torch.Tensor:
        """The ``[n_pad, num_graphs]`` discriminator grid."""
        node_h, graph_h = self.encode(graph, x, training)
        return self.local_d(node_h) @ self.global_d(graph_h).T
