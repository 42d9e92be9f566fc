"""SpMM dispatch and the multi-head attention ops — the port of
``cogdl_tpu/ops/spmm.py`` (the GCN and GAT slices).

Two tiers share one contract (features ``[n_pad, F]`` in, ``[n_pad, F]``
out, pad rows give zeros because pad edges carry zero weight):

  * the plain tier: gather + ``index_add_`` (``spmm_coo``); autograd derives
    the transposed SpMM for dx and the SDDMM for dw;
  * the kernel tier: the hand-written CUDA CSR kernel behind
    :func:`cogdl_tpu_torch.ops.cuda.maybe_cuda_spmm`, taken whenever the
    graph carries the structure ``prepare_spmm`` builds.

A CUDA tensor always goes to the kernel; ``spmm`` raises rather than run the
plain tier on the card.

``gather_src``, ``sddmm``, ``edge_softmax``, ``mh_spmm`` and ``mh_sddmm`` are
plain torch on any device: they carry GAT's unfused route, which a layer
takes only for a graph without the kernel structure (on the card the fused
attention kernel runs instead, ``ops/cuda``).

``aggregate`` is GraphSAGE's neighbourhood reduction: ``"sum"`` is ``spmm``
(the kernel tier on the card); ``"mean"``, ``"max"`` and the regular-fanout
branch are torch index ops on any device, as the JAX package computes them
outside any kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.graph import Graph
from . import segment as seg

__all__ = ["spmm", "spmm_coo", "source_table", "cache_propagation",
           "gather_src", "sddmm", "edge_softmax", "mh_spmm", "mh_sddmm",
           "s_add_e_sum", "s_mul_e_sum", "s_sub_e_sum", "s_add_e_mean",
           "s_mul_e_mean", "s_dot_t", "aggregate"]


def spmm_coo(
    x: torch.Tensor,
    row: torch.Tensor,
    col: torch.Tensor,
    weight: Optional[torch.Tensor],
    num_segments: int,
    sorted: bool = True,
) -> torch.Tensor:
    """``out[r] = Σ_{e: row[e]==r} weight[e] · x[col[e]]``."""
    msg = seg.gather(x, col)
    if weight is not None:
        msg = msg * weight.reshape((-1,) + (1,) * (msg.ndim - 1))
    return seg.segment_sum(msg, row, num_segments, sorted)


def source_table(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """The table source-side gathers read from: ``x`` itself on one device.
    The halo exchange of graph-partition parallelism belongs to the
    multi-device slice, which is not ported yet."""
    if graph.extras and "halo_send_ring" in graph.extras:
        raise NotImplementedError(
            "halo-partitioned graphs are not yet ported to cogdl_tpu_torch "
            "(ROADMAP.md §1, multi-device)")
    return x


def gather_src(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Per-edge source features ``x[col[e]]``."""
    return seg.gather(source_table(graph, x), graph.col)


def spmm(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` over the graph's weighted adjacency: aggregates source
    features into destination nodes."""
    from .cuda import maybe_cuda_spmm

    out = maybe_cuda_spmm(graph, x)
    if out is not None:
        return out
    return spmm_coo(source_table(graph, x), graph.row, graph.col,
                    graph.edge_weight, graph.n_pad)


def cache_propagation(graph: Graph, adj_norm: str = "sym") -> Graph:
    """Precompute the first-layer propagation ``P = Â X`` and the row-sum
    column ``s = Â 1`` that carries the bias through the aggregation.

    A GCN's first layer is linear in the static input features, so
    ``Â (X W + 1 bᵀ) = (Â X) W + (Â 1) bᵀ``; with ``Â`` and ``X`` constant
    across steps, caching ``P`` and ``s`` removes that layer's SpMM from
    every forward and backward pass. Call after any normalisation and
    ``prepare_spmm``. Stores ``extras["prop_x"]`` ([n_pad, F]) and
    ``extras["prop_s"]`` ([n_pad, 1]).
    """
    from ..data.graph import col_norm, row_norm, sym_norm

    g = {"sym": sym_norm, "row": row_norm, "col": col_norm,
         "none": lambda a: a}[adj_norm](graph)
    if g.x is None:
        raise ValueError("cache_propagation needs node features on the graph")
    with torch.no_grad():
        p = spmm(g, g.x)
        s = spmm(g, g.x.new_ones((g.n_pad, 1)))
    extras = dict(graph.extras or {})
    extras.update(prop_x=p, prop_s=s)
    return graph.replace(extras=extras)


def sddmm(graph: Graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense product: per-edge ``a[row[e]] · b[col[e]]``;
    ``[E]`` for 2-D inputs, ``[E, H]`` for 3-D ``[N, H, D]`` inputs."""
    return (seg.gather(a, graph.row) * gather_src(graph, b)).sum(-1)


def edge_softmax(graph: Graph, scores: torch.Tensor,
                 mask_pad: bool = True) -> torch.Tensor:
    """Per-destination softmax of edge scores ``[E]`` or ``[E, H]``; pad
    edges get zero attention."""
    mask = graph.edge_mask() if mask_pad else None
    return seg.segment_softmax(scores, graph.row, graph.n_pad, mask=mask)


def mh_spmm(graph: Graph, attention: torch.Tensor,
            h: torch.Tensor) -> torch.Tensor:
    """Multi-head SpMM: ``out[v, h, :] = Σ_e att[e, h] · feat[col[e], h, :]``
    with ``attention`` ``[E, H]`` and ``h`` ``[N, H, D]``."""
    H, D = h.shape[1], h.shape[2]
    msg = gather_src(graph, h.reshape(-1, H * D)).reshape(-1, H, D)
    return seg.segment_sum(msg * attention[:, :, None], graph.row,
                           graph.n_pad)


def mh_sddmm(graph: Graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge, per-head dots of ``[N, H, D]`` inputs: ``[E, H]``."""
    H, D = a.shape[1], a.shape[2]
    ae = seg.gather(a.reshape(-1, H * D), graph.row).reshape(-1, H, D)
    be = gather_src(graph, b.reshape(-1, H * D)).reshape(-1, H, D)
    return (ae * be).sum(-1)


# ---------------------------------------------------------------------------
# Generic message ops: a source feature combined with an edge feature,
# aggregated by destination (index ops on every device)
# ---------------------------------------------------------------------------

def _combine(op: str, src: torch.Tensor, edge: torch.Tensor) -> torch.Tensor:
    if edge.ndim < src.ndim:
        edge = edge.reshape(tuple(edge.shape) + (1,) * (src.ndim - edge.ndim))
    if op == "add":
        return src + edge
    if op == "mul":
        return src * edge
    if op == "sub":
        return src - edge
    raise ValueError(op)


def _s_op_e_agg(op: str, agg: str, graph: Graph, src_feat, edge_feat):
    msg = _combine(op, gather_src(graph, src_feat), edge_feat)
    # pad edges contribute nothing: their messages are zeroed (the sink's
    # features are 0, but an edge feature on a pad slot need not be)
    m = graph.edge_mask().reshape((-1,) + (1,) * (msg.ndim - 1))
    msg = torch.where(m, msg, torch.zeros_like(msg))
    if agg == "sum":
        return seg.segment_sum(msg, graph.row, graph.n_pad)
    if agg == "mean":
        s = seg.segment_sum(msg, graph.row, graph.n_pad)
        deg = graph.in_degrees().reshape((-1,) + (1,) * (msg.ndim - 1))
        return s / deg.clamp_min(1.0)
    if agg == "max":
        return seg.segment_max(msg, graph.row, graph.n_pad)
    raise ValueError(agg)


def s_add_e_sum(graph, src, edge):
    return _s_op_e_agg("add", "sum", graph, src, edge)


def s_mul_e_sum(graph, src, edge):
    return _s_op_e_agg("mul", "sum", graph, src, edge)


def s_sub_e_sum(graph, src, edge):
    return _s_op_e_agg("sub", "sum", graph, src, edge)


def s_add_e_mean(graph, src, edge):
    return _s_op_e_agg("add", "mean", graph, src, edge)


def s_mul_e_mean(graph, src, edge):
    return _s_op_e_agg("mul", "mean", graph, src, edge)


def s_dot_t(graph, src, dst):
    """Per-edge dot of the source and destination features, ``[E, 1]``."""
    return sddmm(graph, dst, src)[:, None]


def aggregate(graph: Graph, x: torch.Tensor, how: str = "sum") -> torch.Tensor:
    """Neighbourhood aggregation of source features into destinations:
    ``"sum"``, ``"mean"`` or ``"max"`` over each row's edges."""
    f = graph.meta_get("fanout")
    if f and how in ("sum", "mean"):
        # regular-fanout block (device sampler): every real dst owns exactly
        # f dst-major slots, so the scatter is a [n, f, F] reshape-reduce, no
        # segment op at all (dead slots carry zero features and weights)
        n = graph.meta_get("frontier")
        msg = seg.gather(x, graph.col[: n * f]).reshape(n, f, -1)
        ew = graph.edge_weight[: n * f].reshape(n, f, 1)
        red = (msg * ew).sum(1)
        if how == "mean":
            # weighted mean over live slots (dead slots carry weight 0);
            # under the device sampler's unit weights this equals sum / f
            red = red / ew.sum(1).clamp_min(1.0)
        return torch.cat(
            [red, red.new_zeros((graph.n_pad - n, red.shape[-1]))])
    if how == "sum":
        return spmm(graph, x)
    msg = seg.gather(x, graph.col)
    if how == "mean":
        return seg.segment_mean(msg, graph.row, graph.n_pad)
    if how == "max":
        m = graph.edge_mask().reshape((-1,) + (1,) * (msg.ndim - 1))
        msg = torch.where(m, msg, torch.full_like(msg, seg._NEG_INF))
        return seg.segment_max(msg, graph.row, graph.n_pad)
    raise ValueError(how)
