"""GraphMAE — the port of ``cogdl_tpu/models/nn/graphmae.py``: masked
feature autoencoding. A GCN encoder (``enc{i}``, fixed ``prelu``), the
learnable ``mask_token`` in place of the masked nodes' features,
``enc2dec``, the masked nodes' latents zeroed again, and a GCN decoder
(``dec``) back to the input width; the scaled cosine error is averaged
over the masked real nodes. The node mask is the wrapper's draw. K1 runs
at the hidden width and, in the decoder, at the input width.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import CDense, reset_parameters


def sce_loss(pred: torch.Tensor, target: torch.Tensor,
             gamma: float) -> torch.Tensor:
    """Scaled cosine error a row, ``(1 − cos)^gamma``."""
    def norm(v):
        return v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-12)
    return (1.0 - (norm(pred) * norm(target)).sum(-1)) ** gamma


class GraphMAE(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 256, num_layers: int = 2,
                 mask_rate: float = 0.5, gamma: float = 2.0):
        super().__init__()
        self.num_layers = num_layers
        self.mask_rate = mask_rate
        self.gamma = gamma
        width = in_features
        for i in range(num_layers):
            self.add_module(f"enc{i}", GCNLayer(width, hidden_size,
                                                activation="prelu"))
            width = hidden_size
        self.dec = GCNLayer(hidden_size, in_features)
        self.mask_token = nn.Parameter(torch.zeros(1, in_features))
        self.enc2dec = CDense(hidden_size, hidden_size, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)
        with torch.no_grad():
            self.mask_token.zero_()

    def encode(self, graph: Graph, x: torch.Tensor,
               training: bool = False) -> torch.Tensor:
        g = sym_norm(graph)
        h = x
        for i in range(self.num_layers):
            h = getattr(self, f"enc{i}")(g, h, training)
        return h

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encode(graph, graph.x if x is None else x, training)

    def reconstruction_loss(self, graph: Graph, x: torch.Tensor,
                            mask: torch.Tensor,
                            training: bool = True) -> torch.Tensor:
        """The loss with the nodes of ``mask`` (``[n_pad, 1]`` bool, real
        nodes only) masked."""
        g = sym_norm(graph)
        h = torch.where(mask, self.mask_token, x)
        for i in range(self.num_layers):
            h = getattr(self, f"enc{i}")(g, h, training)
        h = torch.where(mask, torch.zeros_like(h), self.enc2dec(h))
        rec = self.dec(g, h, training)
        per = sce_loss(rec, x, self.gamma)
        m = mask[:, 0].to(per.dtype)
        return (per * m).sum() / m.sum().clamp_min(1.0)

    def embed(self, graph: Graph,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encode(graph, graph.x if x is None else x, False)
