"""SortPool (DGCNN) — the port of ``cogdl_tpu/models/nn/sortpool.py``:
three tanh GCN layers (K1 on the card), their outputs concatenated, then
each graph's ``k`` rows with the largest last channel, in descending order
(zero rows where a graph has fewer than ``k`` nodes), flattened into a
dense classifier.

The selection is the JAX package's: a ``[G, N]`` score matrix that holds a
node's key in its graph's row and ``-1e30`` elsewhere, and the top ``k``
along its rows. Equal keys (a saturated tanh gives many exact ±1) keep
the lower node index first, as ``jax.lax.top_k`` orders them: a stable
descending sort, where ``torch.topk`` orders ties in no defined way.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...layers import GCNLayer
from ...layers.utils import CDense, dropout, reset_parameters

_BIG_NEG = -1e30


class SortPool(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 32, num_layers: int = 3, k: int = 16,
                 dropout: float = 0.3):
        super().__init__()
        self.num_layers = num_layers
        self.k = k
        self.dropout = dropout
        width = in_features
        for i in range(num_layers):
            self.add_module(f"gcn{i}", GCNLayer(width, hidden_size,
                                                activation="tanh"))
            width = hidden_size
        self.fc1 = CDense(k * num_layers * hidden_size, hidden_size * 2)
        self.out = CDense(hidden_size * 2, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        graph_id = graph.extras["graph_id"]
        num_graphs = graph.meta_get("num_graphs", 1)
        hs, h = [], x
        for i in range(self.num_layers):
            h = getattr(self, f"gcn{i}")(graph, h, training)
            hs.append(h)
        h = torch.cat(hs, dim=-1)                              # [N, L*H]
        key = h[:, -1]
        mine = graph_id.long()[None, :] == torch.arange(
            num_graphs, device=h.device)[:, None]              # [G, N]
        per_g = torch.where(mine, key[None, :], torch.full_like(key, _BIG_NEG))
        top, idx = torch.sort(per_g, dim=1, descending=True, stable=True)
        top, idx = top[:, : self.k], idx[:, : self.k]           # [G, k]
        feats = h.index_select(0, idx.reshape(-1)).reshape(
            num_graphs, self.k, h.shape[-1])
        feats = feats * (top > _BIG_NEG / 2)[:, :, None].to(h.dtype)
        z = F.relu(self.fc1(feats.reshape(num_graphs, -1)))
        if self.dropout > 0 and training:
            z = dropout(z, self.dropout, generator)
        return self.out(z)
