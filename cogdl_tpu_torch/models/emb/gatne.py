"""GATNE — the port of ``cogdl_tpu/models/emb/gatne.py``, the JAX package's
transductive variant: a base skip-gram over the merged multiplex graph at
``hidden_size``, plus one skip-gram for each edge type at ``edge_dim``,
projected into the base space by a fixed Johnson-Lindenstrauss matrix
``normal / √edge_dim``. Returns ``{edge type: [N, hidden_size]}``.

Each graph's walks run on the port's C++ walker (the base's seeded
``seed``, type ``t``'s ``seed + 1 + t``); the pairs, every skip-gram and
the projection on the device, the pairs shuffled at ``seed`` and each
skip-gram drawing at its walks' seed, as the JAX model seeds them."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ...data.graph import Graph, from_coo
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel
from .walks import build_csr, random_walks, train_sgns, walks_to_pairs

# the pairs each skip-gram trains on, at most (as the JAX model cuts them)
MAX_PAIRS = 1_000_000


class GATNE(EmbeddingModel):
    def __init__(self, hidden_size: int = 64, edge_dim: int = 8,
                 walk_length: int = 10, walk_num: int = 5,
                 window_size: int = 3, negative: int = 5, iteration: int = 2,
                 seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.edge_dim = edge_dim
        self.walk_length = walk_length
        self.walk_num = walk_num
        self.window_size = window_size
        self.negative = negative
        self.iteration = iteration

    def _sgns_on(self, row: np.ndarray, col: np.ndarray, num_nodes: int,
                 dim: int, seed: int, device) -> torch.Tensor:
        with self.stage("walks", device):
            g = from_coo(np.stack([row, col]), num_nodes=num_nodes)
            indptr, indices = build_csr(g)
            walks = random_walks(indptr, indices, self.walk_num,
                                 self.walk_length, seed=seed)
        with self.stage("pairs", device):
            pairs = walks_to_pairs(
                walks, self.window_size, max_pairs=MAX_PAIRS,
                draws=self.make_draws("pairs", self.seed, device),
                device=device)
        with self.stage("train", device):
            return train_sgns(pairs, num_nodes, dim=dim,
                              num_negative=self.negative,
                              epochs=self.iteration,
                              draws=self.make_draws("sgns", seed, device),
                              stats=self.stats)

    def train_embeddings(self, graph: Graph,
                         device=None) -> Dict[int, torch.Tensor]:
        device = resolve_device(device)
        self.stats = {}
        E, N = graph.num_edges, graph.num_nodes
        row = graph.row[:E].cpu().numpy()
        col = graph.col[:E].cpu().numpy()
        etype = (graph.edge_type[:E].cpu().numpy()
                 if graph.edge_type is not None else np.zeros(E, np.int64))
        base = self._sgns_on(row, col, N, self.hidden_size, self.seed,
                             device)
        proj = (self.make_draws("proj", self.seed, device).normal(
            (self.edge_dim, self.hidden_size)).float().to(device)
            / math.sqrt(self.edge_dim))
        out = {}
        for t in np.unique(etype).tolist():
            sel = etype == t
            u_t = self._sgns_on(row[sel], col[sel], N, self.edge_dim,
                                self.seed + 1 + int(t), device)
            out[int(t)] = base + u_t @ proj
        return out
