"""node2vec — the port of ``cogdl_tpu/models/emb/node2vec.py``:
rejection-sampled biased walks on the host (the JAX walker's numpy stream),
then pairs and skip-gram with negative sampling on the device."""

from __future__ import annotations

import numpy as np

from .deepwalk import DeepWalk
from .walks import build_csr, node2vec_walks


class Node2Vec(DeepWalk):
    def __init__(self, hidden_size: int = 128, walk_length: int = 40,
                 walk_num: int = 10, window_size: int = 5, iteration: int = 2,
                 negative: int = 5, p: float = 1.0, q: float = 1.0,
                 seed: int = 0, **kw):
        super().__init__(hidden_size, walk_length, walk_num, window_size,
                         iteration, negative, seed)
        self.p = p
        self.q = q

    def _walks(self, graph) -> np.ndarray:
        indptr, indices = build_csr(graph)
        return node2vec_walks(indptr, indices, self.walk_num,
                              self.walk_length, p=self.p, q=self.q,
                              seed=self.seed)
