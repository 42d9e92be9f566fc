"""GRACE — the port of ``cogdl_tpu/models/nn/grace.py``: a GCN encoder
(``conv{i}``), a two-layer projection head (``proj1``, ``proj2``) and the
normalised-temperature cross entropy between two augmented views.

A view multiplies the graph's **raw** self-loop weights by an edge keep
mask, clears the norm tag and normalises again (``grace.py:52-63``), and
masks feature columns; the masks are the wrapper's draws. The model
declares no ``adj_norm``: the wrapper leaves the raw weights, which a
pre-normalised graph would have lost, and K1 reads each view's weights
through the structure (``Graph.with_edge_weight``), its topology built
once. ``nt_xent`` is dense ``[N, N]`` ``torch.matmul``, as the JAX package
computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import CDense, reset_parameters


def l2_rows(z: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit length; ``sqrt(x + eps)`` keeps the gradient of
    an all-zero (pad) row finite."""
    return z * torch.rsqrt((z * z).sum(1, keepdim=True) + 1e-12)


class GRACE(nn.Module):
    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 128, proj_size: int = 128,
                 num_layers: int = 2, tau: float = 0.4,
                 drop_edge_rates=(0.2, 0.4), drop_feature_rates=(0.3, 0.4)):
        super().__init__()
        self.num_layers = num_layers
        self.tau = tau
        self.drop_edge_rates = tuple(drop_edge_rates)
        self.drop_feature_rates = tuple(drop_feature_rates)
        width = in_features
        for i in range(num_layers):
            self.add_module(f"conv{i}", GCNLayer(width, hidden_size,
                                                 activation="relu"))
            width = hidden_size
        self.proj1 = CDense(hidden_size, proj_size)
        self.proj2 = CDense(proj_size, proj_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def encode(self, graph: Graph, x: torch.Tensor,
               training: bool = False) -> torch.Tensor:
        g = sym_norm(graph)
        h = x
        for i in range(self.num_layers):
            h = getattr(self, f"conv{i}")(g, h, training)
        return h

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encode(graph, graph.x if x is None else x, training)

    def embed(self, graph: Graph,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The frozen embeddings the probe reads: the encoder over the
        whole graph, training off."""
        return self.encode(graph, graph.x if x is None else x, False)

    def view(self, graph: Graph, x: torch.Tensor, edge_keep: torch.Tensor,
             feat_keep: torch.Tensor, training: bool = True) -> torch.Tensor:
        """The embedding of one augmented view: the raw weights times
        ``edge_keep`` (``[e_pad]``), normalised again, and the features
        times ``feat_keep`` (``[1, F]``)."""
        g = graph.with_edge_weight(graph.edge_weight
                                   * edge_keep.to(graph.edge_weight.dtype))
        g = g.replace(meta=tuple((k, v) for k, v in g.meta if k != "norm"))
        return self.encode(g, x * feat_keep.to(x.dtype), training)

    def project(self, h: torch.Tensor) -> torch.Tensor:
        return self.proj2(F.elu(self.proj1(h)))

    def nt_xent(self, z1: torch.Tensor, z2: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """Normalised-temperature cross entropy over the real nodes."""
        z1, z2 = l2_rows(z1), l2_rows(z2)
        m = mask.to(z1.dtype)
        sim11 = torch.exp(z1 @ z1.T / self.tau) * m[None, :]
        sim12 = torch.exp(z1 @ z2.T / self.tau) * m[None, :]
        pos = torch.diagonal(sim12)
        denom = sim11.sum(1) - torch.diagonal(sim11) + sim12.sum(1)
        loss = -torch.log(pos.clamp_min(1e-12) / denom.clamp_min(1e-12))
        return (loss * m).sum() / m.sum().clamp_min(1.0)
