"""DeeperGCN — the port of ``cogdl_tpu/models/nn/deepergcn.py``: ``fc_in``,
``num_layers`` pre-activation residual GENConv blocks ``block{i}``, ReLU,
dropout and ``fc_out``. No kernel of ``ops/cuda`` runs: GENConv is torch
index ops on every device, as the JAX package computes it outside any
Pallas kernel.

``remat=True`` is the JAX model's ``nn.remat``: each block runs under
``torch.utils.checkpoint`` and keeps none of its activations for the
backward, which recomputes them; the blocks then take LayerNorm, as in the
JAX model (whose batch statistics cannot change under remat). A block's
dropout mask is drawn from the generator before the checkpointed call and
passed in, so the recompute drops the same elements and the generator
advances exactly as without remat."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...data.graph import Graph
from ...layers import ResGNNLayer
from ...layers.utils import CDense, dropout, dropout_keep, reset_parameters


class DeeperGCN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 14,
                 aggr: str = "softmax_sg", dropout: float = 0.2,
                 remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.remat = remat
        self.fc_in = CDense(in_features, hidden_size)
        norm = "layernorm" if remat else "batchnorm"
        for i in range(num_layers):
            self.add_module(f"block{i}", ResGNNLayer(
                hidden_size, hidden_size, aggr=aggr, dropout=dropout,
                norm=norm))
        self.fc_out = CDense(hidden_size, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        h = self.fc_in(x)
        drop = self.dropout if training else 0.0
        for i in range(self.num_layers):
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                keep = (dropout_keep(h.shape, drop, h.device, generator)
                        if drop > 0 else None)
                h = checkpoint(block, graph, h, training, None, keep,
                               use_reentrant=False)
            else:
                h = block(graph, h, training, generator)
        return self.fc_out(dropout(torch.relu(h), drop, generator))
