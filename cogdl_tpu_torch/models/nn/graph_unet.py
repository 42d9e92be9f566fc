"""Graph U-Net — the port of ``cogdl_tpu/models/nn/graph_unet.py``: gPool
and gUnpool with static shapes.

Pooling keeps every level at ``[n_pad, F]`` by masking: the kept nodes keep
their rows scaled by ``sigmoid(score)``, the others are zeroed, and each
level's GCN layer (K1 on the card) runs over the whole graph. A level keeps
the nodes whose score reaches the k-th largest among the nodes still in the
mask, ties included, with ``k = max(int(rate · num_nodes), 1)`` counted
over the graph's real nodes at every level, as the JAX model counts them.

``adj_norm = "sym"`` is a class attribute, as in ``models/nn/sgc.py``: the
JAX forward calls ``sym_norm`` and declares no ``adj_norm``; here the
wrapper normalises before it builds the kernels' structure, and the
model's own ``sym_norm`` is a no-op by the graph's tag."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import (
    CDense,
    dropout,
    glorot_uniform_,
    reset_parameters,
)

# the score of a node outside the current mask, as the JAX model fills it
MASKED_SCORE = -1e30


class GraphUnet(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64,
                 pooling_rates: Sequence[float] = (0.5, 0.5),
                 dropout: float = 0.3):
        super().__init__()
        self.pooling_rates = tuple(pooling_rates)
        self.dropout = dropout
        self.in_gcn = GCNLayer(in_features, hidden_size, activation="relu")
        for d in range(len(self.pooling_rates)):
            self.register_parameter(
                f"pool_w{d}", nn.Parameter(torch.empty(hidden_size, 1)))
            self.add_module(f"down_gcn{d}", GCNLayer(
                hidden_size, hidden_size, activation="relu"))
            self.add_module(f"up_gcn{d}", GCNLayer(
                hidden_size, hidden_size, activation="relu"))
        self.out = CDense(hidden_size, out_features)

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """The pooling vectors ``pool_w{d}``, Glorot uniform."""
        for d in range(len(self.pooling_rates)):
            glorot_uniform_(getattr(self, f"pool_w{d}"), generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def pool(self, d: int, h: torch.Tensor, mask: torch.Tensor,
             num_nodes: int):
        """Level ``d``'s gPool of ``h`` under ``mask`` (``[n_pad, 1]``):
        ``(score, thresh, keep)``, the nodes' scores (``MASKED_SCORE``
        outside the mask), the k-th largest of them and the kept nodes as
        a ``[n_pad, 1]`` float mask."""
        p = getattr(self, f"pool_w{d}")
        score = (h @ p).squeeze(-1) * torch.rsqrt((p ** 2).sum() + 1e-12)
        score = torch.where(mask.squeeze(-1) > 0, score,
                            torch.full_like(score, MASKED_SCORE))
        k = max(int(self.pooling_rates[d] * num_nodes), 1)
        thresh = torch.topk(score.detach(), k).values[-1]
        keep = (score >= thresh).to(h.dtype).unsqueeze(-1) * mask
        return score, thresh, keep

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                return_levels: bool = False):
        """Logits ``[n_pad, C]``; with ``return_levels``, also each level's
        ``(score, thresh, keep)`` of :meth:`pool`."""
        if x is None:
            x = graph.x
        g = sym_norm(graph)
        h = self.in_gcn(g, x, training)
        mask = graph.node_mask().to(h.dtype).unsqueeze(-1)
        skips, masks, levels = [], [], []
        for d in range(len(self.pooling_rates)):
            skips.append(h)
            score, thresh, keep = self.pool(d, h, mask, graph.num_nodes)
            h = h * keep * torch.sigmoid(score).unsqueeze(-1)
            masks.append(keep)
            levels.append((score, thresh, keep))
            mask = keep
            h = getattr(self, f"down_gcn{d}")(g, h, training)
        for d in reversed(range(len(self.pooling_rates))):
            h = h * masks[d] + skips[d]
            h = getattr(self, f"up_gcn{d}")(g, h, training)
        if self.dropout > 0 and training:
            h = dropout(h, self.dropout, generator)
        logits = self.out(h)
        return (logits, levels) if return_levels else logits
