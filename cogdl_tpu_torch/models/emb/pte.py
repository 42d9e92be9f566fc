"""PTE — the port of ``cogdl_tpu/models/emb/pte.py``: LINE-style samples of
each edge type's edges, drawn in proportion to their weights, and
skip-gram with negative sampling over the pairs and their reverses, all
on the device.

The samples of all types come from one stage's draws (``Draws.choice``:
the cumulative weights inverted, on the device), type after type in
ascending order, as the JAX model draws them from one numpy stream."""

from __future__ import annotations

import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel
from .walks import train_sgns


class PTE(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, num_samples: int = 1_000_000,
                 negative: int = 5, iteration: int = 3, seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.num_samples = num_samples
        self.negative = negative
        self.iteration = iteration

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        E = graph.num_edges
        row = graph.row[:E].to(device, torch.int64)
        col = graph.col[:E].to(device, torch.int64)
        w = graph.edge_weight[:E].to(device, torch.float64)
        etype = (graph.edge_type[:E].to(device, torch.int64)
                 if graph.edge_type is not None
                 else torch.zeros(E, dtype=torch.int64, device=device))
        with self.stage("samples", device):
            draws = self.make_draws("samples", self.seed, device)
            per_type = self.num_samples // max(int(etype.max()) + 1, 1)
            pairs = []
            for t in torch.unique(etype).tolist():
                sel = torch.nonzero(etype == t)[:, 0]
                idx = sel[draws.choice(w[sel] / w[sel].sum(), per_type)]
                pairs.append(torch.stack([row[idx], col[idx]], 1))
            P = torch.cat(pairs + [p.flip(1) for p in pairs], 0)
        with self.stage("train", device):
            return train_sgns(P, graph.num_nodes, dim=self.hidden_size,
                              num_negative=self.negative,
                              epochs=self.iteration,
                              draws=self.make_draws("sgns", self.seed,
                                                    device),
                              stats=self.stats)
