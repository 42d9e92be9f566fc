"""Shallow-embedding model base — the port of
``cogdl_tpu/models/emb/base.py``: ``graph_to_scipy`` and the
``EmbeddingModel`` interface, ``train_embeddings(graph) -> np.ndarray
[num_nodes, dim]``. ``top_svd`` (scikit-learn) waits for the embedding
models."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ...data.graph import Graph


def graph_to_scipy(graph: Graph, directed: bool = False) -> sp.csr_matrix:
    """The real edges' weighted adjacency as a scipy CSR matrix on the host;
    symmetrised by the elementwise maximum unless ``directed``."""
    E, N = graph.num_edges, graph.num_nodes
    row = graph.row[:E].cpu().numpy()
    col = graph.col[:E].cpu().numpy()
    w = graph.edge_weight[:E].detach().cpu().numpy()
    A = sp.csr_matrix((w, (row, col)), shape=(N, N))
    if not directed:
        A = A.maximum(A.T)
    return A


class EmbeddingModel:
    def __init__(self, hidden_size: int = 128, seed: int = 0, **kw):
        self.hidden_size = hidden_size
        self.seed = seed

    def train_embeddings(self, graph: Graph) -> np.ndarray:
        raise NotImplementedError
