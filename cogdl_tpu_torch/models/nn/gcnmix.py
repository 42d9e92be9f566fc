"""GCNMix — the port of ``cogdl_tpu/models/nn/gcnmix.py``: a two-layer GCN
(``gcn1``, ``gcn2``; K1 on the card) trained with manifold mixup of its
hidden states and the matching mix of labels.

The draw is kept apart from the arithmetic: :meth:`GCNMix.draw_mixup`
draws ``(perm, lam)`` from the caller's generators, and
:meth:`GCNMix.mixup_forward` computes from the given pair, so that a test
can replay the JAX model's draws. ``lam ~ Beta(α, α)`` comes from a host
``numpy.random.Generator`` (``torch.distributions.Beta`` takes no
generator, and a host draw waits for nothing on the card), then ``lam =
max(lam, 1 − lam)``; ``perm`` is a permutation of the real nodes drawn on
the graph's device, followed by the pad rows in place.

``adj_norm = "sym"`` is a class attribute, as in ``models/nn/sgc.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import reset_parameters


class GCNMix(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, dropout: float = 0.5,
                 alpha: float = 1.0, temperature: float = 0.1):
        super().__init__()
        self.alpha = alpha
        self.temperature = temperature
        self.gcn1 = GCNLayer(in_features, hidden_size, dropout=dropout,
                             activation="relu")
        self.gcn2 = GCNLayer(hidden_size, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        g = sym_norm(graph)
        h = self.gcn1(g, x, training, generator=generator)
        return self.gcn2(g, h, training)

    def draw_mixup(self, graph: Graph, rng: np.random.Generator,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, float]:
        """``(perm, lam)``: ``lam`` from ``rng`` (host), ``perm`` a
        permutation of the graph's real nodes from ``generator`` on the
        graph's device, then the pad rows ``num_nodes … n_pad − 1`` in
        place."""
        lam = float(rng.beta(self.alpha, self.alpha))
        lam = max(lam, 1.0 - lam)
        n, device = graph.num_nodes, graph.device
        perm = torch.cat([
            torch.randperm(n, generator=generator, device=device),
            torch.arange(n, graph.n_pad, device=device)])
        return perm, lam

    def mixup_forward(self, graph: Graph, x: torch.Tensor,
                      perm: torch.Tensor, lam: float, training: bool = True,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Logits of the manifold-mixup forward: ``gcn1``, then the hidden
        rows mixed as ``lam·h + (1 − lam)·h[perm]``, then ``gcn2``. The
        wrapper mixes the labels with the same ``(perm, lam)``."""
        g = sym_norm(graph)
        h = self.gcn1(g, x, training, generator=generator)
        h = lam * h + (1.0 - lam) * h[perm]
        return self.gcn2(g, h, training)

    def sharpen(self, probs: torch.Tensor) -> torch.Tensor:
        p = probs ** (1.0 / self.temperature)
        return p / p.sum(-1, keepdim=True).clamp_min(1e-12)
