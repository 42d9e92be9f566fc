"""DGI (Deep Graph Infomax) — the port of ``cogdl_tpu/models/nn/dgi.py``.

A one-layer GCN encoder (``encoder.gcn``, the fixed leaky ``prelu`` of
slope 0.25), the readout ``sigmoid(mean)`` over the real nodes, and a
bias-free bilinear discriminator ``disc`` between node embeddings and the
summary. The corruption (a permutation of the real rows) is the wrapper's
draw (``wrappers/self_supervised.py``). The encoder's propagation is K1
on the card, at the hidden width.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import CDense, reset_parameters


def masked_summary(h: torch.Tensor, graph: Graph) -> torch.Tensor:
    """``sigmoid`` of the mean of ``h`` over the graph's real nodes."""
    mask = graph.node_mask().to(h.dtype)[:, None]
    return torch.sigmoid((h * mask).sum(0) / mask.sum().clamp_min(1.0))


class DGIEncoder(nn.Module):
    def __init__(self, in_features: int, hidden_size: int = 512):
        super().__init__()
        self.gcn = GCNLayer(in_features, hidden_size, activation="prelu")

    def forward(self, graph: Graph, x: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        return self.gcn(sym_norm(graph), x, training)


class DGI(nn.Module):
    # the wrapper normalises the self-loop graph once; the forward's
    # sym_norm is then free
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 512):
        super().__init__()
        self.encoder = DGIEncoder(in_features, hidden_size)
        self.disc = CDense(hidden_size, hidden_size, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encoder(graph, graph.x if x is None else x, training)

    def infomax_logits(self, graph: Graph, x: torch.Tensor,
                       x_corrupt: torch.Tensor, training: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Positive and negative discriminator scores of the BCE infomax
        loss."""
        h_pos = self.encoder(graph, x, training)
        h_neg = self.encoder(graph, x_corrupt, training)
        sw = self.disc(masked_summary(h_pos, graph))
        return h_pos @ sw, h_neg @ sw

    def embed(self, graph: Graph,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder(graph, graph.x if x is None else x, False)
