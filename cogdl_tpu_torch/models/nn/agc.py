"""AGC, adaptive graph convolution clustering — the port of
``cogdl_tpu/models/nn/agc.py``: ``max_order`` steps of the low-pass filter
``h ← (h + Â·h) / 2`` over the symmetric-normalised graph, from the
features. No parameters; the clustering wrapper reads its embeddings.

Each step is K1 on the card at the input width (``calls_spmm``), and
nothing runs backward. ``adj_norm = "sym"``, as GAE's."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...ops import spmm
from .gae import GAE


class AGC(nn.Module):
    adj_norm = "sym"
    calls_spmm = True
    has_kl = False

    def __init__(self, in_features: int, out_features: int = 0,
                 max_order: int = 8):
        super().__init__()
        self.max_order = max_order

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Nothing to initialise."""

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = graph.x if x is None else x
        g = sym_norm(graph)
        for _ in range(self.max_order):
            h = 0.5 * (h + spmm(g, h))
        return h

    decode_edges = staticmethod(GAE.decode_edges)

    def embed(self, graph: Graph,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self(graph, x, False)
