"""GCN layer: linear → SpMM → norm → residual → activation → dropout.

The port of ``cogdl_tpu/layers/gcn_layer.py``. The dense transform is a
plain ``F.linear``; the aggregation goes through ``ops.spmm`` (the CUDA CSR
kernel on the card, the plain tier on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..data.graph import Graph
from ..ops import spmm
from .utils import CDense, MaskedBatchNorm, dropout, get_activation


class GCNLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 dropout: float = 0.0, activation: Optional[str] = None,
                 residual: bool = False, norm: Optional[str] = None,
                 bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dropout = dropout
        self.activation = activation
        self.residual = residual
        self.norm_type = norm
        self.linear = CDense(in_features, out_features, bias=bias)
        if norm == "batchnorm":
            self.norm = MaskedBatchNorm(out_features)
        elif norm == "layernorm":
            self.norm = nn.LayerNorm(out_features, eps=1e-6)  # flax default
        elif norm is not None:
            raise ValueError(f"unknown norm {norm!r}: batchnorm | layernorm")
        if residual and in_features != out_features:
            self.res_proj = CDense(in_features, out_features, bias=False)

    def forward(self, graph: Graph, x: torch.Tensor, training: bool = False,
                prop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: the dropout mask, drawn ahead by ``dropout_keep`` (a
        checkpointed caller draws it outside the recomputed call)."""
        if prop is not None:
            # cached propagation (ops.spmm.cache_propagation): the layer input
            # is the static graph.x, so Â(XW + 1bᵀ) = (ÂX)W + (Â1)bᵀ
            p, s = prop
            out = torch.nn.functional.linear(p.to(x.dtype), self.linear.weight)
            if self.linear.bias is not None:
                out = out + s.to(x.dtype) * self.linear.bias
        else:
            # aggregate after the dense transform: the SpMM runs at the
            # (usually narrower) output width
            out = spmm(graph, self.linear(x))
        if self.norm_type == "batchnorm":
            out = self.norm(out, graph.node_mask(),
                            use_running_average=not training)
        elif self.norm_type == "layernorm":
            out = self.norm(out)
        if self.residual:
            out = out + (self.res_proj(x) if hasattr(self, "res_proj") else x)
        if self.activation is not None:
            out = get_activation(self.activation)(out)
        if self.dropout > 0 and training:
            out = dropout(out, self.dropout, generator, keep=keep)
        return out
