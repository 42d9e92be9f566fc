"""graph2vec — the port of ``cogdl_tpu/models/emb/graph2vec.py``:
Weisfeiler-Lehman subtree hashes of each graph on the host, their counts
in ``dim_buckets`` buckets, TF-IDF weights and a truncated SVD on the
device.

:func:`wl_features` hashes with Python's own ``hash`` of the JAX
package's int tuples, ``% 2**31``: that hash is the function (the same in
every CPython 3.8+, ints not being salted). A node's neighbour labels come
from the graph's CSR slices, sorted once for all nodes, where the JAX
function scans every edge for every node; the multiset, and so the hash,
is the same."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, top_svd


def wl_features(graph: Graph, iterations: int = 3) -> List[int]:
    """The Weisfeiler-Lehman subtree hashes of one graph: the initial
    labels (a one-hot feature's column, else the degree), then each
    iteration's ``hash((label, *sorted neighbour labels)) % 2**31``, node
    after node."""
    E, N = graph.num_edges, graph.num_nodes
    row = graph.row[:E].cpu().numpy().astype(np.int64)
    col = graph.col[:E].cpu().numpy().astype(np.int64)
    x = None if graph.x is None else graph.x[:N].cpu().numpy()
    if x is not None and x.ndim > 1 and np.all((x == 0) | (x == 1)):
        labels = np.argmax(x, 1).astype(np.int64)
    else:
        labels = np.bincount(row, minlength=N).astype(np.int64)
    ptr = np.zeros(N + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=N), out=ptr[1:])
    feats = labels.tolist()
    for _ in range(iterations):
        nbr = labels[col]
        # each row's neighbour labels in ascending order
        nbr = nbr[np.lexsort((nbr, row))].tolist()
        own = labels.tolist()
        labels = np.asarray(
            [hash((own[v],) + tuple(nbr[ptr[v]: ptr[v + 1]])) % (2 ** 31)
             for v in range(N)], np.int64)
        feats.extend(labels.tolist())
    return feats


def bucket_counts(graphs: List[Graph], iterations: int, buckets: int,
                  device) -> torch.Tensor:
    """``float32 [G, buckets]``: graph ``i``'s WL features counted by
    ``feature % buckets``, summed on ``device``."""
    feats = [np.asarray(wl_features(g, iterations), np.int64) % buckets
             for g in graphs]
    gid = np.repeat(np.arange(len(graphs), dtype=np.int64),
                    [f.size for f in feats])
    flat = torch.from_numpy(gid * buckets + np.concatenate(feats)).to(device)
    counts = torch.zeros(len(graphs) * buckets, device=device)
    counts.index_add_(0, flat, torch.ones(flat.numel(), device=device))
    return counts.view(len(graphs), buckets)


class Graph2Vec(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, wl_iterations: int = 3,
                 dim_buckets: int = 2048, seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.wl_iterations = wl_iterations
        self.dim_buckets = dim_buckets

    def train_graph_embeddings(self, graphs: List[Graph],
                               device=None) -> torch.Tensor:
        """``[G, min(hidden_size, min(G, buckets) − 1)]`` (at least 2),
        float64: the TF-IDF weighted counts ``counts · log(G / df)`` (df
        the graphs holding a bucket, at least 1) through ``top_svd``."""
        device = resolve_device(device)
        self.stats = {}
        with self.stage("wl", device):
            counts = bucket_counts(graphs, self.wl_iterations,
                                   self.dim_buckets, device)
        with self.stage("factorize", device):
            df = (counts > 0).sum(0).clamp_min(1).double()
            tfidf = counts.double() * torch.log(len(graphs) / df)[None, :]
            k = min(self.hidden_size, min(tfidf.shape) - 1)
            return top_svd(tfidf, max(k, 2), self.seed)
