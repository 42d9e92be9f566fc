"""SAGN — the port of ``cogdl_tpu/models/nn/sagn.py``: attention over
``num_hops`` steps of the symmetric-normalised adjacency on the input
features (K1 on the card, forward only: the features take no gradient),
each hop encoded by ``hop{i}``, the hops weighted by a softmax of
``leaky_relu(z @ attn_q, 0.2)``, then ``ln`` (flax's LayerNorm, eps 1e-6),
ReLU, dropout and ``out``. The multi-stage self-training lives in the
``sagn_staged`` wrapper (``wrappers/staged.py``).

``calls_spmm`` says the model propagates (it has no GCN layer that would
say so), and ``adj_norm = "sym"`` is a class attribute, as in
``models/nn/sgc.py``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers.utils import CDense, dropout, glorot_uniform_, reset_parameters
from ...ops import spmm


class SAGN(nn.Module):
    adj_norm = "sym"
    calls_spmm = True

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_hops: int = 3,
                 dropout: float = 0.5, attn_drop: float = 0.4):
        super().__init__()
        self.num_hops = num_hops
        self.dropout = dropout
        self.attn_drop = attn_drop
        for i in range(num_hops + 1):
            self.add_module(f"hop{i}", CDense(in_features, hidden_size))
        self.attn_q = nn.Parameter(torch.empty(hidden_size, 1))
        self.ln = nn.LayerNorm(hidden_size, eps=1e-6)   # flax default
        self.out = CDense(hidden_size, out_features)

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """``attn_q``, Glorot uniform."""
        glorot_uniform_(self.attn_q, generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        g = sym_norm(graph)
        hops = [x]
        for _ in range(self.num_hops):
            hops.append(spmm(g, hops[-1]))
        z = torch.stack([getattr(self, f"hop{i}")(h)
                         for i, h in enumerate(hops)], 1)   # [N, K+1, H]
        scores = F.leaky_relu(z @ self.attn_q, 0.2).squeeze(-1)
        att = torch.softmax(scores, 1)
        if self.attn_drop > 0 and training:
            att = dropout(att, self.attn_drop, generator)
        mixed = torch.einsum("nk,nkh->nh", att, z)
        mixed = torch.relu(self.ln(mixed))
        if self.dropout > 0 and training:
            mixed = dropout(mixed, self.dropout, generator)
        return self.out(mixed)
