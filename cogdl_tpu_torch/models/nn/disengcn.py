"""DisenGCN — the port of ``cogdl_tpu/models/nn/disengcn.py``: each node
keeps ``channels`` unit vectors of ``channel_dim``; ``routing_iters`` rounds
of neighbourhood routing reassign each neighbour's mass among them.

No kernel of ours runs here, as in the JAX package: the routing is gathers
(``index_select``) and segment sums. Its ``[E, K, D]`` tensors are the
memory: at K=4, D=16 each is 256 B an edge, and a training step keeps
about ten of them for the backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph
from ...layers.utils import CDense, dropout, reset_parameters
from ...ops import segment as seg


def _unit(z: torch.Tensor) -> torch.Tensor:
    # rsqrt(Σz² + eps): linalg.norm has no finite gradient on zero rows
    return z * torch.rsqrt((z * z).sum(-1, keepdim=True) + 1e-12)


class DisenLayer(nn.Module):
    def __init__(self, in_features: int, channels: int = 4,
                 channel_dim: int = 16, routing_iters: int = 3):
        super().__init__()
        self.channels = channels
        self.channel_dim = channel_dim
        self.routing_iters = routing_iters
        self.proj = CDense(in_features, channels * channel_dim)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        K, D = self.channels, self.channel_dim
        z = _unit(self.proj(x).reshape(-1, K, D))
        src = seg.gather(z, graph.col)                        # [E, K, D]
        emask = graph.edge_mask().to(z.dtype)[:, None]
        c = z                                                 # [N, K, D]
        for _ in range(self.routing_iters):
            logits = (src * seg.gather(c, graph.row)).sum(-1)  # [E, K]
            att = torch.softmax(logits, dim=-1) * emask
            agg = seg.segment_sum(src * att[..., None], graph.row,
                                  graph.n_pad)
            c = _unit(z + agg)
        return c.reshape(-1, K * D)


class DisenGCN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 channels: int = 4, channel_dim: int = 16,
                 num_layers: int = 2, routing_iters: int = 3,
                 dropout: float = 0.35):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        width = in_features
        for i in range(num_layers):
            self.add_module(f"layer{i}", DisenLayer(
                width, channels, channel_dim, routing_iters))
            width = channels * channel_dim
        self.out = CDense(width, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(graph, x)
            if self.dropout > 0 and training:
                x = dropout(x, self.dropout, generator)
        return self.out(x)
