"""HAN layer: one GAT a metapath, then semantic attention across the
metapaths — the port of ``cogdl_tpu/layers/han_layer.py`` (reference
``HANLayer``, cogdl/layers/han_layer.py).

Each metapath is its own graph; on the card each carries the kernel
structure (the heterogeneous wrapper's ``prepare_graph``), so every
``GATLayer`` runs K3 over its metapath graph."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..data.graph import Graph
from .gat_layer import GATLayer
from .utils import CDense, glorot_uniform_

SEM_ATTS = ("han", "linear")


class HANLayer(nn.Module):
    """``gat{i}`` over metapath ``i`` (``nhead`` heads of
    ``out_features``, concatenated, attention dropout ``dropout``), then
    semantic attention: ``"han"``, the HAN paper's shared ``sem_fc`` (128,
    tanh) and query ``sem_q`` scored by the mean over every row of the
    padded graph (pad rows included, as in the JAX layer) and a softmax over
    the metapaths; or ``"linear"``, the reference package's per-node linear
    score ``att_fc``, with no softmax."""

    def __init__(self, in_features: int, out_features: int, nhead: int = 8,
                 num_metapaths: int = 2, dropout: float = 0.5,
                 sem_att: str = "han"):
        super().__init__()
        if sem_att not in SEM_ATTS:
            raise ValueError(f"unknown sem_att {sem_att!r}: {SEM_ATTS}")
        self.num_metapaths = num_metapaths
        self.sem_att = sem_att
        for i in range(num_metapaths):
            self.add_module(f"gat{i}", GATLayer(
                in_features, out_features, nhead=nhead, attn_drop=dropout,
                concat=True))
        width = nhead * out_features
        if sem_att == "linear":
            self.att_fc = CDense(width, 1)
        else:
            self.sem_fc = CDense(width, 128)
            self.sem_q = nn.Parameter(torch.empty(128, 1))

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        if self.sem_att == "han":
            glorot_uniform_(self.sem_q, generator)

    def forward(self, graphs: Sequence[Graph], x: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if len(graphs) != self.num_metapaths:
            raise ValueError(f"HANLayer of {self.num_metapaths} metapaths got "
                             f"{len(graphs)} graphs")
        z = torch.stack([getattr(self, f"gat{i}")(g, x, training, generator)
                         for i, g in enumerate(graphs)], dim=1)  # [N, M, H·D]
        if self.sem_att == "linear":
            att = self.att_fc(z)                                 # [N, M, 1]
            return torch.einsum("nm,nmf->nf", att.squeeze(-1), z)
        w = torch.tanh(self.sem_fc(z))
        score = (w @ self.sem_q).mean(0).squeeze(-1)             # [M]
        beta = torch.softmax(score, dim=0)
        return torch.einsum("m,nmf->nf", beta, z)
