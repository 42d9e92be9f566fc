"""ActGCN — the port of ``cogdl_tpu/models/nn/actgcn.py``: a GCN whose dense
transforms keep an int8 copy of their input for the backward
(``ops.actnn.act_dense``) and whose ReLUs keep a bool mask
(``act_relu``); the aggregation is K1 on the card, which keeps no
activation at all. Input dropout, then per layer ``w{i}`` ``[in, out]``
and ``b{i}`` (raw parameters, not dense layers), the SpMM, and ReLU and
dropout between layers. Its weight gradients are quantised, as in the JAX
package.

``adj_norm = "sym"`` is a class attribute, as in ``models/nn/sgc.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers.utils import dropout, glorot_uniform_, reset_parameters
from ...ops import spmm
from ...ops.actnn import act_dense, act_relu


class ActGCN(nn.Module):
    adj_norm = "sym"
    calls_spmm = True

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.5, activation: str = "relu",
                 norm: Optional[str] = None, residual: bool = False):
        super().__init__()
        self.dropout = dropout
        dims = [hidden_size] * (num_layers - 1) + [out_features]
        self.num_layers = num_layers
        width = in_features
        for i, d in enumerate(dims):
            self.register_parameter(f"w{i}", nn.Parameter(torch.empty(width,
                                                                      d)))
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(d)))
            width = d
        self.reset_own_parameters()

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """Each ``w{i}`` flax Glorot uniform, each ``b{i}`` zero."""
        for i in range(self.num_layers):
            glorot_uniform_(getattr(self, f"w{i}"), generator)
            with torch.no_grad():
                getattr(self, f"b{i}").zero_()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph = sym_norm(graph)
        drop = self.dropout if training else 0.0
        x = dropout(x, drop, generator)
        for i in range(self.num_layers):
            x = spmm(graph, act_dense(x, getattr(self, f"w{i}"),
                                      getattr(self, f"b{i}")))
            if i < self.num_layers - 1:
                x = dropout(act_relu(x), drop, generator)
        return x
