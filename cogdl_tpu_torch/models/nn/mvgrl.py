"""MVGRL — the port of ``cogdl_tpu/models/nn/mvgrl.py``: two one-layer GCN
encoders (``enc_a`` over the adjacency, ``enc_d`` over the diffusion
view) and DGI's discriminator across the views.

The diffusion view is ``graph.extras["diffusion_graph"]`` when the graph
carries one. Nothing in the JAX package sets it, so both encoders run over
``sym_norm(graph)`` there (``cogdl_tpu/models/nn/mvgrl.py:32-33,39-40``),
and here too (ROADMAP.md §3). Every propagation is K1 on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import CDense, reset_parameters
from .dgi import masked_summary


class MVGRL(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 512):
        super().__init__()
        self.enc_a = GCNLayer(in_features, hidden_size, activation="prelu")
        self.enc_d = GCNLayer(in_features, hidden_size, activation="prelu")
        self.disc = CDense(hidden_size, hidden_size, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    @staticmethod
    def views(graph: Graph) -> Tuple[Graph, Graph]:
        """The adjacency view and the diffusion view (the adjacency's when
        the graph carries no ``diffusion_graph``)."""
        g = sym_norm(graph)
        diff = (graph.extras or {}).get("diffusion_graph")
        return g, (g if diff is None else diff)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = graph.x if x is None else x
        g, diff = self.views(graph)
        return self.enc_a(g, x, training) + self.enc_d(diff, x, training)

    def infomax_logits(self, graph: Graph, x: torch.Tensor,
                       x_corrupt: torch.Tensor, training: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        g, diff = self.views(graph)
        h_a = self.enc_a(g, x, training)
        h_d = self.enc_d(diff, x, training)
        hn_a = self.enc_a(g, x_corrupt, training)
        hn_d = self.enc_d(diff, x_corrupt, training)
        d_a = self.disc(masked_summary(h_a, graph))
        d_d = self.disc(masked_summary(h_d, graph))
        # cross-view scores
        return h_a @ d_d + h_d @ d_a, hn_a @ d_d + hn_d @ d_a

    def embed(self, graph: Graph,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self(graph, x, False)
