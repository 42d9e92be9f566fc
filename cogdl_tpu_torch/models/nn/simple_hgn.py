"""Simple-HGN — GAT with edge-type attention terms and attention residuals —
the port of ``cogdl_tpu/models/nn/simple_hgn.py`` (reference
examples/simple_hgn/conv.py myGATConv and run.py SimpleHGN; "Are we really
making much progress? Revisiting heterogeneous GNNs").

Each layer scores an edge by three halves, ``a_l·h[dst] + a_r·h[src] +
a_e·emb[edge_type]``, takes the softmax over each destination's edges (pad
edges masked), mixes the attention with the previous layer's
(``(1 − alpha)·att + alpha·res_attn``), aggregates each head and adds a
linear residual. The logits are L2-normalised. The typed graph stays one
padded edge list; scores, softmax and aggregation are torch index ops, no
kernel of ours, as in the JAX package."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...layers.utils import CDense, dropout, glorot_uniform_, reset_parameters
from ...ops import segment as seg


class SimpleHGNConv(nn.Module):
    """One Simple-HGN layer (reference examples/simple_hgn/conv.py:11):
    ``W``, the ``num_etypes`` edge-type embeddings ``edge_emb`` and their
    per-head projection ``W_e``, ``a_l``/``a_r`` ``[1, H, D]``, ``a_e``
    ``[1, H, edge_dim]``, and ``res`` (with bias) where ``residual``."""

    def __init__(self, in_features: int, out_features: int, num_etypes: int,
                 nhead: int = 8, edge_dim: int = 64, feat_drop: float = 0.5,
                 attn_drop: float = 0.5, negative_slope: float = 0.05,
                 residual: bool = False, activation: bool = True,
                 alpha: float = 0.05):
        super().__init__()
        H, D = nhead, out_features
        self.nhead, self.out_features = H, D
        self.edge_dim = edge_dim
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.activation = activation
        self.alpha = alpha
        self.W = CDense(in_features, H * D, bias=False)
        self.set_edge_types(num_etypes)
        self.a_l = nn.Parameter(torch.empty(1, H, D))
        self.a_r = nn.Parameter(torch.empty(1, H, D))
        self.a_e = nn.Parameter(torch.empty(1, H, edge_dim))
        if residual:
            self.res = CDense(in_features, H * D)

    def set_edge_types(self, num_etypes: int) -> None:
        """(Re)build ``edge_emb`` and ``W_e`` for ``num_etypes`` types."""
        self.num_etypes = num_etypes
        self.edge_emb = nn.Parameter(torch.empty(num_etypes, self.edge_dim))
        self.W_e = CDense(self.edge_dim, self.nhead * self.edge_dim,
                          bias=False)

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        for p in (self.edge_emb, self.a_l, self.a_r, self.a_e):
            glorot_uniform_(p, generator)

    def forward(self, graph: Graph, x: torch.Tensor,
                res_attn: Optional[torch.Tensor], training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(out [n_pad, H·D], att [e_pad, H])``, the attention detached
        for the next layer's residual mix."""
        H, D, T = self.nhead, self.out_features, self.num_etypes
        if self.feat_drop > 0 and training:
            x = dropout(x, self.feat_drop, generator)
        h = self.W(x).view(-1, H, D)
        e = self.W_e(self.edge_emb).view(T, H, self.edge_dim)
        sd = (self.a_l * h).sum(-1)                         # [N, H]
        ss = (self.a_r * h).sum(-1)
        se = (self.a_e * e).sum(-1)                         # [T, H]
        row, col = graph.row, graph.col
        etype = (graph.edge_type if graph.edge_type is not None
                 else torch.zeros_like(row))
        scores = (sd.index_select(0, row) + ss.index_select(0, col)
                  + se.index_select(0, etype.clamp(0, T - 1)))
        scores = F.leaky_relu(scores, self.negative_slope)
        att = seg.segment_softmax(scores, row, graph.n_pad,
                                  mask=graph.edge_mask(), sorted=False)
        if self.attn_drop > 0 and training:
            att = dropout(att, self.attn_drop, generator)
        if res_attn is not None:
            att = att * (1.0 - self.alpha) + res_attn * self.alpha
        msg = (h.reshape(-1, H * D).index_select(0, col).view(-1, H, D)
               * att[:, :, None])
        out = seg.segment_sum(msg, row, graph.n_pad).reshape(-1, H * D)
        if hasattr(self, "res"):
            out = out + self.res(x)
        if self.activation:
            out = F.elu(out)
        return out, att.detach()


class SimpleHGN(nn.Module):
    """Reference examples/simple_hgn/run.py:15 SimpleHGN: ``num_layers``
    hidden layers (residual from the second on), then a one-head ``out``
    layer with a residual and no activation, and L2-normalised logits.

    The edge-type count is ``max(num_etypes, meta["num_relations"])`` of
    the graph, as flax decides it at the first call: the wrapper sizes
    ``edge_emb`` and ``W_e`` to it (:meth:`fit_graph`)."""

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2, nhead: int = 8,
                 edge_dim: int = 64, num_etypes: int = 5,
                 dropout: float = 0.5, attn_drop: float = 0.5,
                 negative_slope: float = 0.05, residual: bool = True,
                 alpha: float = 0.05):
        super().__init__()
        self.num_layers = num_layers
        self.num_etypes = num_etypes
        kw = dict(num_etypes=num_etypes, edge_dim=edge_dim,
                  feat_drop=dropout, attn_drop=attn_drop,
                  negative_slope=negative_slope, alpha=alpha)
        width = in_features
        for i in range(num_layers):
            self.add_module(f"layer{i}", SimpleHGNConv(
                width, hidden_size, nhead=nhead,
                residual=(i > 0) and residual, activation=True, **kw))
            width = hidden_size * nhead
        self.out = SimpleHGNConv(width, out_features, nhead=1,
                                 residual=residual, activation=False, **kw)

    def fit_graph(self, graph: Graph) -> None:
        """Size every layer's edge-type embeddings to ``max(num_etypes,
        meta["num_relations"])`` of ``graph``; the wrapper calls it before
        initialising the parameters."""
        t = max(self.num_etypes,
                int(graph.meta_get("num_relations", 1) or 1))
        for m in self.modules():
            if isinstance(m, SimpleHGNConv) and m.num_etypes != t:
                m.set_edge_types(t)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if isinstance(graph, (list, tuple)):
            graph = graph[0]
        if x is None:
            x = graph.x
        res_attn = None
        h = x
        for i in range(self.num_layers):
            h, res_attn = getattr(self, f"layer{i}")(graph, h, res_attn,
                                                     training, generator)
        logits, _ = self.out(graph, h, None, training, generator)
        # rsqrt(max(Σx², eps)) keeps the gradient finite on zero (pad) rows
        sq = (logits * logits).sum(1, keepdim=True)
        return logits * torch.rsqrt(sq.clamp_min(1e-24))
