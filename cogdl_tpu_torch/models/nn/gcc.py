"""GCC — the port of ``cogdl_tpu/models/nn/gcc.py`` (reference
cogdl/models/nn/gcc_model.py): graph contrastive coding's encoder, five
``GINLayer``s with a ReLU after each (each layer's neighbour sum is
``spmm``: K1 on the card), then per graph of a union batch a Set2Set
readout (6 steps, 3 LSTM layers) and ``readout_lin`` with a ReLU, or a
segment sum (``readout="sum"``); ``proj`` and the row norm ``z ·
rsqrt(Σz² + 1e-12)``. Without ``graph_id`` the rows are per node."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...layers import GINLayer, Set2Set
from ...layers.utils import CDense, reset_parameters
from ...ops import segment as seg


class GCC(nn.Module):
    def __init__(self, in_features: int, out_features: int = 64,
                 hidden_size: int = 64, num_layers: int = 5,
                 readout: str = "set2set", set2set_steps: int = 6,
                 set2set_layers: int = 3):
        super().__init__()
        if readout not in ("set2set", "sum"):
            raise ValueError(f"GCC readout must be 'set2set' or 'sum', got "
                             f"{readout!r}")
        self.in_features = in_features
        self.out_features = out_features
        self.num_layers = num_layers
        self.readout = readout
        for i in range(num_layers):
            self.add_module(f"gin{i}", GINLayer(
                in_features if i == 0 else hidden_size, hidden_size))
        if readout == "set2set":
            self.set2set = Set2Set(hidden_size, set2set_steps, set2set_layers)
            self.readout_lin = CDense(2 * hidden_size, hidden_size)
        self.proj = CDense(hidden_size, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph_id = graph.extras.get("graph_id") if graph.extras else None
        h = x
        for i in range(self.num_layers):
            h = F.relu(getattr(self, f"gin{i}")(graph, h, training))
        if graph_id is not None:
            num_graphs = graph.meta_get("num_graphs", 1)
            if self.readout == "set2set":
                h = F.relu(self.readout_lin(
                    self.set2set(h, graph_id, num_graphs)))
            else:
                h = seg.segment_sum(h, graph_id, num_graphs)
        z = self.proj(h)
        return z * torch.rsqrt((z * z).sum(-1, keepdim=True) + 1e-12)
