"""DiffPool — the port of ``cogdl_tpu/models/nn/diffpool.py``: one
hierarchical pooling step over a union batch. Two GCN layers give the
embedding ``Z`` (ReLU, ``hidden_size``) and the soft assignment ``S`` to
``num_clusters`` clusters; ``SᵀZ`` and ``SᵀAS`` are taken per graph by
segment sums over ``graph_id``, ``AS`` by ``spmm`` (K1 at F = clusters on
the card), then two dense layers run on the pooled graphs and their mean
feeds the classifier.

The pooled graphs are computed in float64: the two pooling sums (the
products of two float32 values are exact there) and the two dense layers
over them, whose mean rounds to float32 once before the classifier. The
unnormalised ``SᵀAS`` drives the logits to 1e7 and more; in float32 the
rounding of these few ``[G, C, H]`` values showed in the logits, and on
the card so did the order in which ``index_add``'s threads arrive, from
one run to the next. The GCN layers stay float32 (K1 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...layers import GCNLayer
from ...layers.utils import CDense, dropout, reset_parameters
from ...ops import segment as seg
from ...ops import spmm


class DiffPool(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_clusters: int = 8,
                 dropout: float = 0.2):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_clusters = num_clusters
        self.dropout = dropout
        self.embed = GCNLayer(in_features, hidden_size, activation="relu")
        self.assign = GCNLayer(in_features, num_clusters)
        for i in range(2):
            self.add_module(f"dense{i}", CDense(hidden_size, hidden_size))
        self.out = CDense(hidden_size, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph_id = graph.extras["graph_id"]
        G = graph.meta_get("num_graphs", 1)
        C, H = self.num_clusters, self.hidden_size
        z = self.embed(graph, x, training)                      # [N, H]
        s = torch.softmax(self.assign(graph, x, training), dim=-1)
        s = s * graph.node_mask().to(z.dtype)[:, None]          # [N, C]
        s64 = s.double()
        # X' = SᵀZ per graph, (graph, cluster) flattened into one axis
        h = seg.segment_sum((s64[:, :, None] * z.double()[:, None, :])
                            .reshape(-1, C * H), graph_id, G).reshape(G, C, H)
        # A' = Sᵀ(AS) per graph
        a_s = spmm(graph, s)                                    # [N, C]
        a_pool = seg.segment_sum((s64[:, :, None] * a_s.double()[:, None, :])
                                 .reshape(-1, C * C), graph_id, G).reshape(
            G, C, C)
        for i in range(2):
            d = getattr(self, f"dense{i}")
            h = F.relu(torch.einsum("gcd,gdh->gch", a_pool, F.linear(
                h, d.weight.double(), d.bias.double())))
        hg = h.mean(dim=1).to(z.dtype)                          # [G, H]
        if self.dropout > 0 and training:
            hg = dropout(hg, self.dropout, generator)
        return self.out(hg)
