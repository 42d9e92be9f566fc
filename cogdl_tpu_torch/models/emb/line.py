"""LINE — the port of ``cogdl_tpu/models/emb/line.py``: first- and
second-order proximity by skip-gram with negative sampling over edges
drawn by weight, on the device."""

from __future__ import annotations

import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel
from .walks import train_sgns


class LINE(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, order: int = 2,
                 num_samples: int = 2_000_000, negative: int = 5,
                 iteration: int = 4, seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.order = order
        self.num_samples = num_samples
        self.negative = negative
        self.iteration = iteration

    def _sample_pairs(self, graph: Graph, device) -> torch.Tensor:
        """``min(num_samples, 20·E)`` edges drawn with replacement by
        weight, each both ways: ``[2·S, 2]`` on ``device``."""
        E = graph.num_edges
        row = graph.row[:E].to(device).long()
        col = graph.col[:E].to(device).long()
        w = graph.edge_weight[:E].to(device, torch.float64)
        draws = self.make_draws("edges", self.seed, device)
        idx = draws.choice(w / w.sum(), min(self.num_samples, max(E * 20, E)))
        pairs = torch.stack([row[idx], col[idx]], 1)
        return torch.cat([pairs, pairs.flip(1)], 0)

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        """order=1: first-order proximity (tied vertex table); order=2:
        second-order (separate context table); order=3: both at dim/2,
        L2-normalised halves concatenated."""
        if self.order not in (1, 2, 3):
            raise ValueError(f"LINE order must be 1, 2 or 3, got {self.order}")
        device = resolve_device(device)
        self.stats = {}
        with self.stage("pairs", device):
            pairs = self._sample_pairs(graph, device)

        def run(order, dim, seed):
            with self.stage("train", device):
                e = train_sgns(pairs, graph.num_nodes, dim=dim,
                               num_negative=self.negative,
                               epochs=self.iteration,
                               draws=self.make_draws("sgns", seed, device),
                               tie_context=(order == 1), stats=self.stats)
            return e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)

        if self.order == 1:
            return run(1, self.hidden_size, self.seed)
        if self.order == 2:
            return run(2, self.hidden_size, self.seed)
        half = max(self.hidden_size // 2, 1)
        return torch.cat([run(1, half, self.seed),
                          run(2, half, self.seed + 1)], 1)
