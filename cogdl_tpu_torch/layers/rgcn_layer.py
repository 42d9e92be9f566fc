"""Relational GCN layer with basis-decomposed relation weights — the port
of ``cogdl_tpu/layers/rgcn_layer.py`` (reference ``RGCNLayer``,
cogdl/layers/rgcn_layer.py).

The sources are transformed once a basis (``[N, B, F_out]``), each edge
mixes the bases by its relation's coefficients, and one segment sum over the
typed union graph aggregates; no kernel of ours runs here, as in the JAX
package. Every gather is an ``index_select``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.graph import Graph
from ..ops import segment as seg
from .utils import CDense, dropout, glorot_uniform_


class RGCNLayer(nn.Module):
    """``basis`` ``[B, F_in, F_out]`` with ``B = min(num_bases,
    num_relations)``, ``coeff`` ``[num_relations, B]``, the mean over each
    destination's weighted in-degree (clamped at 1), ``W_self`` and
    ``bias``."""

    def __init__(self, in_features: int, out_features: int,
                 num_relations: int, num_bases: int = 4,
                 self_loop: bool = True, dropout: float = 0.0):
        super().__init__()
        B = min(num_bases, num_relations)
        self.dropout = dropout
        self.basis = nn.Parameter(torch.empty(B, in_features, out_features))
        self.coeff = nn.Parameter(torch.empty(num_relations, B))
        if self_loop:
            self.W_self = CDense(in_features, out_features, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        glorot_uniform_(self.basis, generator)
        glorot_uniform_(self.coeff, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, graph: Graph, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if graph.edge_type is None:
            raise ValueError("RGCNLayer needs graph.edge_type (relation ids)")
        hb = torch.einsum("nf,bfo->nbo", x, self.basis)      # [N, B, F_out]
        c_e = self.coeff.index_select(0, graph.edge_type)    # [E, B]
        src = seg.gather(hb, graph.col)                      # [E, B, F_out]
        msg = torch.einsum("eb,ebo->eo", c_e, src)
        out = seg.segment_sum(msg * graph.edge_weight[:, None], graph.row,
                              graph.n_pad)                   # pad edges: 0
        # mean over the in-degree (rgcn uses 1/c_{i,r}; this is 1/c_i)
        out = out / graph.in_degrees(weighted=True)[:, None].clamp_min(1.0)
        if hasattr(self, "W_self"):
            out = out + self.W_self(x)
        out = out + self.bias
        if self.dropout > 0 and training:
            out = dropout(out, self.dropout, generator)
        return out
