"""Adversarial-robustness utilities — the port of ``gnnguard_reweight`` from
``cogdl_tpu/utils/grb.py``. The attacks and the rest of the module wait in
ROADMAP.md §1."""

from __future__ import annotations

import torch

from ..data.graph import Graph
from ..ops.segment import gather, segment_sum


def gnnguard_reweight(graph: Graph, x: torch.Tensor,
                      threshold: float = 0.1) -> Graph:
    """GNNGuard's edge weights from the features ``x``: the cosine
    similarity of each edge's endpoints, zero below ``threshold``, on self
    loops and on pad edges, normalised to sum 1 over each destination row;
    each self loop then weighs ``1 / (deg + 1)`` with ``deg`` the row's
    edges left. Shapes stay: a pruned edge keeps its slot at weight 0. The
    weights carry ``x``'s gradient, and a kernel structure on the graph
    takes them (``Graph.with_edge_weight``)."""
    # index_select (ops.gather), not x[idx]: its backward is index_add,
    # where advanced indexing's is the card's sort-based index_put
    row, col = graph.row, graph.col
    xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
    sim = (gather(xn, row) * gather(xn, col)).sum(-1)
    sim = torch.where(sim < threshold, torch.zeros_like(sim), sim)
    not_loop = row != col
    sim = sim * graph.edge_mask() * not_loop
    row_sum = segment_sum(sim, row, graph.n_pad)
    w = sim / gather(row_sum, row).clamp_min(1e-12)
    deg = segment_sum((sim > 0).float(), row, graph.n_pad)
    lam = 1.0 / (deg + 1.0)
    is_loop = ~not_loop & graph.edge_mask()
    w = torch.where(is_loop, gather(lam, row), w)
    return graph.with_edge_weight(w)
