"""metapath2vec — the port of ``cogdl_tpu/models/emb/metapath2vec.py``:
walks guided by a cyclic node-type schema on the host, then pairs and
skip-gram with negative sampling on the device.

The walks keep the JAX walker's ``numpy.random.default_rng(seed)`` stream,
so they are its walks bit for bit. The JAX walker visits every walker at
every step in a Python loop; here a step is one draw for all walkers
whose pool is not empty, ``rng.integers(0, sizes)`` over an array of
bounds, which gives the same numbers as the scalar calls in walker order.
A walker's pool is its node's neighbours of the step's type, read from a
CSR whose rows are grouped by the neighbour's type (each group in the
CSR's order), or all its neighbours when it has none of that type."""

from __future__ import annotations

import numpy as np
import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel
from .deepwalk import sgns_embedding
from .walks import build_csr

# the pairs SGNS trains on, at most (as the JAX model cuts them)
MAX_PAIRS = 2_000_000


def node_types(graph: Graph) -> np.ndarray:
    """``extras["node_type"]`` over the real nodes, or all zeros."""
    if graph.extras and "node_type" in graph.extras:
        return graph.extras["node_type"][: graph.num_nodes].cpu().numpy()
    return np.zeros(graph.num_nodes, np.int64)


class Metapath2Vec(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, walk_length: int = 20,
                 walk_num: int = 10, window_size: int = 5, iteration: int = 2,
                 negative: int = 5, schema: str = "0-1-0", seed: int = 0,
                 **kw):
        super().__init__(hidden_size, seed)
        self.walk_length = walk_length
        self.walk_num = walk_num
        self.window_size = window_size
        self.iteration = iteration
        self.negative = negative
        self.schema = [int(s) for s in schema.split("-")]

    def metapath_walks(self, graph: Graph) -> np.ndarray:
        """``int64 [walk_num·starts, walk_length]``: from every node of the
        schema's first type (every node when there is none), ``walk_num``
        times over, step ``t`` to a uniform neighbour of type
        ``schema[t % len(schema)]``."""
        rng = np.random.default_rng(self.seed)
        indptr, indices = build_csr(graph)
        node_type = node_types(graph).astype(np.int64)
        N = graph.num_nodes
        T = int(max(node_type.max(initial=0), max(self.schema))) + 1
        first = np.nonzero(node_type == self.schema[0])[0]
        starts = np.tile(first if first.size else np.arange(N),
                         self.walk_num)
        # each row's entries grouped by their type, the CSR's order kept
        # inside a group; group (v, τ) spans tptr[v·T + τ] to the next
        deg = np.diff(indptr)
        rows = np.repeat(np.arange(N, dtype=np.int64), deg)
        order = np.argsort(rows * T + node_type[indices], kind="stable")
        grouped = indices[order]
        tcount = np.bincount(rows * T + node_type[indices],
                             minlength=N * T)
        tptr = np.concatenate([[0], np.cumsum(tcount)])
        L = len(self.schema)
        walks = np.empty((starts.shape[0], self.walk_length), np.int64)
        walks[:, 0] = starts
        cur = starts.copy()
        for t in range(1, self.walk_length):
            key = cur * T + self.schema[t % L]
            typed = tcount[key]
            size = np.where(typed > 0, typed, deg[cur])
            live = np.nonzero(size > 0)[0]
            nxt = cur.copy()
            if live.size:
                off = rng.integers(0, size[live])
                of_type = typed[live] > 0
                a, b = live[of_type], live[~of_type]
                nxt[a] = grouped[tptr[key[a]] + off[of_type]]
                nxt[b] = indices[indptr[cur[b]] + off[~of_type]]
            walks[:, t] = nxt
            cur = nxt
        return walks

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        with self.stage("walks", device):
            walks = self.metapath_walks(graph)
        return sgns_embedding(self, walks, graph.num_nodes, device,
                              max_pairs=MAX_PAIRS)
