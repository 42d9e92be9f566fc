"""DeepWalk — the port of ``cogdl_tpu/models/emb/deepwalk.py``: uniform
walks from the port's C++ walker, then pairs and skip-gram with negative
sampling on the device."""

from __future__ import annotations

import numpy as np
import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel
from .walks import build_csr, random_walks, train_sgns, walks_to_pairs

# the pairs SGNS trains on, at most (a shuffled cut of all of them)
MAX_PAIRS = 4_000_000


class DeepWalk(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, walk_length: int = 40,
                 walk_num: int = 10, window_size: int = 5, iteration: int = 2,
                 negative: int = 5, seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.walk_length = walk_length
        self.walk_num = walk_num
        self.window_size = window_size
        self.iteration = iteration
        self.negative = negative

    def _walks(self, graph: Graph) -> np.ndarray:
        indptr, indices = build_csr(graph)
        return random_walks(indptr, indices, self.walk_num, self.walk_length,
                            seed=self.seed)

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        with self.stage("walks", device):
            walks = self._walks(graph)
        return sgns_embedding(self, walks, graph.num_nodes, device)


def sgns_embedding(model, walks: np.ndarray, num_nodes: int, device,
                   max_pairs: int = MAX_PAIRS) -> torch.Tensor:
    """DeepWalk's, node2vec's and metapath2vec's shared tail: the pairs of
    ``walks`` on ``device`` (at most ``max_pairs``), then
    ``model.iteration`` epochs of SGNS."""
    with model.stage("pairs", device):
        pairs = walks_to_pairs(
            walks, model.window_size, max_pairs=max_pairs,
            draws=model.make_draws("pairs", model.seed, device),
            device=device)
    with model.stage("train", device):
        return train_sgns(pairs, num_nodes, dim=model.hidden_size,
                          num_negative=model.negative,
                          epochs=model.iteration,
                          draws=model.make_draws("sgns", model.seed, device),
                          stats=model.stats)
