"""GAT — the port of ``cogdl_tpu/models/nn/gat.py``.

Forward contract: ``model(graph, x=None, training=False, generator=None)
-> logits[n_pad, C]``; ``graph`` is a Graph (full batch) or a sequence of
per-hop block Graphs (sampled mini-batch, outermost-first: layer ``i``
reads ``blocks[i]``). Hidden layers concatenate ``nhead`` heads of
``hidden_size`` and apply ELU; the output layer averages ``nhead_last``
heads. Dropout on each layer's input is drawn from ``generator``.
Submodules are named ``layer{i}`` as the flax parameter tree is, so
``models.load_jax_params`` maps one onto the other.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...layers import GATLayer
from ...layers.utils import dropout


class GAT(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 8, num_layers: int = 2, nhead: int = 8,
                 nhead_last: int = 1, alpha: float = 0.2,
                 dropout: float = 0.6, attn_drop: float = 0.5,
                 residual: bool = False, norm: Optional[str] = None,
                 exact_scores: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"layer{i}", GATLayer(
                width, hidden_size, nhead=nhead, alpha=alpha,
                attn_drop=attn_drop, activation="elu", residual=residual,
                norm=norm, concat=True, exact_scores=exact_scores))
            width = hidden_size * nhead
        self.add_module(f"layer{num_layers - 1}", GATLayer(
            width, out_features, nhead=nhead_last, alpha=alpha,
            attn_drop=attn_drop, concat=False, exact_scores=exact_scores))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-initialise every layer from ``generator`` (in layer order)."""
        for i in range(self.num_layers):
            getattr(self, f"layer{i}").reset_parameters(generator)

    def forward(self, graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        blocks = (graph if isinstance(graph, (list, tuple))
                  else [graph] * self.num_layers)
        if x is None:
            x = blocks[0].x
        for i in range(self.num_layers):
            if self.dropout > 0 and training:
                x = dropout(x, self.dropout, generator)
            block = blocks[-1] if i == self.num_layers - 1 else blocks[i]
            x = getattr(self, f"layer{i}")(block, x, training, generator)
        return x
