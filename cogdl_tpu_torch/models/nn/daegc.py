"""DAEGC, deep attentional embedded graph clustering — the port of
``cogdl_tpu/models/nn/daegc.py``: two single-head GAT layers (``gat1`` at
``hidden_size`` with relu, ``gat2`` at ``emb_size``), attention dropout 0,
the inner-product decoder, and the cluster ``centers`` behind the
Student-t soft assignment ``cluster_q``.

On the card both layers run K3 (fwd, and dsd and dsrc backward) at (H, D)
= (1, ``hidden_size``) and (1, ``emb_size``). The clustering loss does not
read ``centers``; the trainer steps them with a zero gradient, as optax
does (with weight decay they move)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph
from ...layers import GATLayer
from ...layers.utils import reset_parameters
from .gae import GAE


class DAEGC(nn.Module):
    has_kl = False

    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 256, emb_size: int = 16,
                 num_clusters: int = 4):
        super().__init__()
        self.gat1 = GATLayer(in_features, hidden_size, nhead=1, attn_drop=0.0,
                             activation="relu")
        self.gat2 = GATLayer(hidden_size, emb_size, nhead=1, attn_drop=0.0)
        self.centers = nn.Parameter(torch.empty(num_clusters, emb_size))

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """``centers`` standard normal (flax ``initializers.normal(1.0)``)."""
        with torch.no_grad():
            self.centers.copy_(torch.randn(self.centers.shape,
                                           generator=generator))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def encode(self, graph: Graph, x: torch.Tensor,
               training: bool = False) -> torch.Tensor:
        return self.gat2(graph, self.gat1(graph, x, training), training)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encode(graph, graph.x if x is None else x, training)

    decode_edges = staticmethod(GAE.decode_edges)

    def cluster_q(self, z: torch.Tensor) -> torch.Tensor:
        """Student-t soft assignment of each row of ``z`` to the centers."""
        d2 = ((z[:, None, :] - self.centers[None]) ** 2).sum(-1)
        q = 1.0 / (1.0 + d2)
        return q / q.sum(1, keepdim=True).clamp_min(1e-12)

    def embed(self, graph: Graph,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encode(graph, graph.x if x is None else x, False)
