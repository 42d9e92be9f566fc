"""STGAT, the spatio-temporal GAT for traffic forecasting — the port of
``cogdl_tpu/models/nn/stgat.py``: STGCN's sandwich of gated temporal
convolutions with a multi-head GAT layer as the spatial step.

The JAX model maps one GAT layer with shared parameters over the ``B·T``
(batch, time) slices (``nn.vmap``). Here that layer runs ONCE over the
block-diagonal union of ``B·T`` copies of the road graph
(``data.batch.block_union``, through ``TrafficModel``): on the card one
K3 pass a block and mode (fwd; dsd and dsrc in the backward) at ``nhead``
heads of ``hidden_size // nhead``. The slices are not folded into heads:
``B·T·nhead`` would pass K3's 128 heads. The attention dropout is 0, as in
the JAX model, so no keep mask is drawn. ``gat{i}`` holds the vmapped
layer's shared parameters under the JAX names (``W``, ``a_src``,
``a_dst``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...layers import GATLayer
from ...layers.utils import CDense
from .stgcn import TemporalGatedConv, TrafficModel, _time_conv


class STGAT(TrafficModel):
    def __init__(self, in_features: int, out_features: int = 1,
                 hidden_size: int = 32, nhead: int = 4, num_blocks: int = 1,
                 kt: int = 3, window: int = 12):
        super().__init__()
        self.kt = kt
        self.num_blocks = num_blocks
        self.hidden_size = hidden_size
        head_dim = hidden_size // nhead
        for i in range(num_blocks):
            self.add_module(f"t1_{i}", TemporalGatedConv(
                in_features if i == 0 else hidden_size, hidden_size, kt))
            self.add_module(f"gat{i}", GATLayer(
                hidden_size, head_dim, nhead=nhead, attn_drop=0.0,
                concat=True))
            self.add_module(f"t2_{i}", TemporalGatedConv(
                nhead * head_dim, hidden_size, kt))
            self.add_module(f"ln{i}", nn.LayerNorm(hidden_size, eps=1e-6))
        self._set_window(window)
        self.out = CDense(hidden_size, out_features)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: ``[B, T, n_pad, C_in]`` (``graph.extras["window"]`` when
        None). Returns ``[B, n_pad, out_features]``."""
        if x is None:
            x = graph.extras["window"]
        self._check_window(graph, x)
        for i in range(self.num_blocks):
            x = getattr(self, f"t1_{i}")(x)
            B, T, N, C = x.shape
            out = getattr(self, f"gat{i}")(
                self.slice_union(graph, B * T), x.reshape(B * T * N, C),
                training, generator)
            x = F.relu(out).view(B, T, N, -1)
            x = getattr(self, f"ln{i}")(getattr(self, f"t2_{i}")(x))
        x = F.relu(_time_conv(self.out_t, x))
        return self.out(x).squeeze(1)
