"""Multi-graph batching — the port of ``cogdl_tpu/data/batch.py``: the
disconnected union of many small graphs, padded to sizes that every batch
of one list shares.

The layout is the JAX package's, array for array: node indices offset per
graph, ``extras["graph_id"]`` mapping each node to its graph (pad nodes to
the dummy slot ``G_pad - 1``), ``extras["graph_mask"]`` true on the real
graphs and ``extras["graph_y"]`` their labels. Built on the host.

``block_union`` is the port's own: the union of many copies of one graph,
built on its device, which runs the traffic models' spatial step over every
(batch, time) slice of a window at once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .graph import Graph, _bucket, _np, from_coo


def union_batch(
    graphs: Sequence[Graph],
    labels: Optional[np.ndarray] = None,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    num_graphs_pad: Optional[int] = None,
) -> Graph:
    """Concatenate ``graphs`` into one disconnected union graph on the
    CPU. ``meta["num_graphs"]`` is the padded graph count ``G_pad``
    (``_bucket(G + 1)`` unless given), whose last slot collects the pad
    nodes."""
    rows, cols, ws, xs, gids = [], [], [], [], []
    off = 0
    for gi, g in enumerate(graphs):
        E, N = g.num_edges, g.num_nodes
        rows.append(_np(g.row)[:E].astype(np.int64) + off)
        cols.append(_np(g.col)[:E].astype(np.int64) + off)
        ws.append(_np(g.edge_weight)[:E])
        if g.x is not None:
            xs.append(_np(g.x)[:N])
        gids.append(np.full(N, gi, np.int32))
        off += N
    row = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    col = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    w = np.concatenate(ws) if ws else np.zeros(0, np.float32)
    x = np.concatenate(xs) if xs else None
    gid = np.concatenate(gids) if gids else np.zeros(0, np.int32)

    G = len(graphs)
    G_pad = num_graphs_pad or _bucket(G + 1)
    g_union = from_coo(
        np.stack([row, col]), num_nodes=off, edge_weight=w, x=x,
        n_pad=n_pad, e_pad=e_pad,
        meta={"num_graphs": G_pad,
              "num_classes": graphs[0].meta_get("num_classes")},
    )
    gid_pad = np.full(g_union.n_pad, G_pad - 1, np.int32)
    gid_pad[:off] = gid
    graph_mask = np.zeros(G_pad, bool)
    graph_mask[:G] = True
    y = np.zeros(G_pad, np.int32)
    if labels is not None:
        y[:G] = np.asarray(labels[:G], np.int32)
    return g_union.replace(extras={
        "graph_id": torch.from_numpy(gid_pad),
        "graph_mask": torch.from_numpy(graph_mask),
        "graph_y": torch.from_numpy(y),
    })


def make_batches(
    graphs: Sequence[Graph],
    labels: Optional[np.ndarray],
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
) -> List[Graph]:
    """Split ``graphs`` into union batches of ``batch_size`` that share one
    padded shape, sized to the largest chunk; the order is shuffled once at
    ``seed`` when ``shuffle`` is set."""
    idx = np.arange(len(graphs))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    chunks = [idx[i: i + batch_size] for i in range(0, len(idx), batch_size)]
    max_nodes = max(sum(graphs[i].num_nodes for i in c) for c in chunks)
    max_edges = max(sum(graphs[i].num_edges for i in c) for c in chunks)
    n_pad = _bucket(max_nodes + 1)
    e_pad = _bucket(max_edges)
    g_pad = _bucket(batch_size + 1)
    return [union_batch([graphs[i] for i in c],
                        None if labels is None else labels[c],
                        n_pad=n_pad, e_pad=e_pad, num_graphs_pad=g_pad)
            for c in chunks]


def block_union(graph: Graph, copies: int) -> Graph:
    """The disconnected union of ``copies`` copies of ``graph``'s real
    edges (a block-diagonal adjacency), built on ``graph``'s device. Copy
    ``c`` holds rows ``[c·n_pad, (c+1)·n_pad)`` of ``graph``'s padded row
    space, so that a ``[copies, n_pad, F]`` tensor, viewed as
    ``[copies·n_pad, F]``, lines up with the union's rows; the pad rows
    have no edge. The edges keep their CSR order, weights and ``meta``
    (the normalisation tag with them); there is no pad edge and no sink
    row: ``n_pad = num_nodes = copies·graph.n_pad``, ``e_pad = num_edges =
    copies·graph.num_edges``. ``meta["copies"]`` records the count. No
    kernel structure is copied."""
    n, E = graph.n_pad, graph.num_edges
    if copies < 1 or E == 0:
        raise ValueError(f"block_union needs at least one copy of a graph "
                         f"with edges, got {copies} of {E} edges")
    off = torch.arange(copies, dtype=torch.int32,
                       device=graph.device)[:, None] * n
    row = (graph.row[:E][None] + off).reshape(-1)
    counts = torch.bincount(graph.row[:E].long(), minlength=n).repeat(copies)
    ptr = torch.zeros(copies * n + 1, dtype=torch.int32, device=graph.device)
    ptr[1:] = torch.cumsum(counts, 0)
    meta = {k: v for k, v in graph.meta if k != "spmm_panel_rows"}
    meta["copies"] = copies
    return Graph(row_ptr=ptr, row=row,
                 col=(graph.col[:E][None] + off).reshape(-1),
                 edge_weight=graph.edge_weight[:E].repeat(copies),
                 num_nodes=copies * n, num_edges=copies * E,
                 meta=tuple(sorted(meta.items())))
