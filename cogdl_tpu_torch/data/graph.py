"""Statically shaped graph container on torch tensors — the PyTorch port of
``cogdl_tpu/data/graph.py``.

Layout and padding contract (identical to the JAX package, so the arrays of
the two packages compare one to one):
  * CSR over destination rows: ``row_ptr[int32, n_pad+1]``, ``col[int32,
    e_pad]``, with the sorted destination vector ``row[int32, e_pad]`` kept
    alongside for segment ops.
  * Nodes are padded to ``n_pad`` and edges to ``e_pad`` (``_bucket``).
      - pad nodes occupy rows [num_nodes, n_pad); their features are zero and
        every node mask is False there.
      - pad edges point at the *sink node* ``n_pad - 1`` (a pad node whenever
        pad edges exist) with ``edge_weight == 0``.
  * Normalisation folds into ``edge_weight`` and tags ``meta["norm"]`` so a
    second call is free.
  * New weights reach the kernel structure (``spmm_*`` extras): every way
    of changing them (``with_edge_weight``, ``replace(edge_weight=...)``
    without new extras, the norms) takes the structure's weights from the
    new ones and keeps its topology (``ops.cuda.reweighted_structure``).

Construction and structural rebuilds run on the host with numpy; the result
lands on the device of the graph it was built from. Weight transforms
(``sym_norm`` and friends) run on whatever device the graph lives on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Graph",
    "from_coo",
    "sym_norm",
    "row_norm",
    "col_norm",
    "add_self_loops",
    "remove_self_loops",
    "to_undirected",
    "pad_to",
]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket(x: int, minimum: int = 8) -> int:
    """Next power-of-two-ish bucket ≥ x (1.0x–2.0x overhead)."""
    if x <= minimum:
        return minimum
    p = 1 << (int(x - 1).bit_length())
    # refine with quarter-steps between powers of two: 1.0, 1.25, 1.5, 1.75
    for frac in (p // 2 + p // 8, p // 2 + p // 4, p // 2 + 3 * p // 8):
        if x <= frac:
            return frac
    return p


def _np(a):
    """Host numpy view of an array-like (torch tensors are copied off the
    device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass(frozen=True)
class Graph:
    """Immutable, statically shaped graph of torch tensors.

    Shapes (``N = n_pad`` padded nodes, ``E = e_pad`` padded edges):
      row_ptr int32[N + 1], row int32[E], col int32[E], edge_weight float32[E],
      x float32[N, F], y int32[N] (or float[N, C]), *_mask bool[N],
      edge_attr [E, D], edge_type int32[E], extras: dict of tensors.
    ``num_nodes``/``num_edges`` are the real (pre-padding) counts.
    """

    row_ptr: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    edge_weight: torch.Tensor
    num_nodes: int
    num_edges: int
    edge_attr: Optional[torch.Tensor] = None
    edge_type: Optional[torch.Tensor] = None
    x: Optional[torch.Tensor] = None
    y: Optional[torch.Tensor] = None
    train_mask: Optional[torch.Tensor] = None
    val_mask: Optional[torch.Tensor] = None
    test_mask: Optional[torch.Tensor] = None
    extras: Optional[Dict[str, torch.Tensor]] = None
    meta: Tuple[Tuple[str, Any], ...] = ()

    # -- static sizes -------------------------------------------------------
    @property
    def n_pad(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def e_pad(self) -> int:
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def num_features(self) -> int:
        if self.x is None:
            raise ValueError("graph has no node features")
        return int(self.x.shape[-1])

    def meta_get(self, key: str, default=None):
        for k, v in self.meta:
            if k == key:
                return v
        return default

    @property
    def num_classes(self) -> Optional[int]:
        return self.meta_get("num_classes")

    # -- masks & degrees ----------------------------------------------------
    def node_mask(self) -> torch.Tensor:
        """bool[N_pad]: True on real nodes."""
        return torch.arange(self.n_pad, device=self.device) < self.num_nodes

    def edge_mask(self) -> torch.Tensor:
        """bool[E_pad]: True on real edges."""
        return torch.arange(self.e_pad, device=self.device) < self.num_edges

    def in_degrees(self, weighted: bool = False) -> torch.Tensor:
        """Degree of each node as a destination (CSR row lengths)."""
        if weighted:
            return self.edge_weight.new_zeros(self.n_pad).index_add_(
                0, self.row, self.edge_weight)
        return (self.row_ptr[1:] - self.row_ptr[:-1]).float()

    def out_degrees(self, weighted: bool = False) -> torch.Tensor:
        w = self.edge_weight if weighted else self.edge_mask().float()
        return w.new_zeros(self.n_pad).index_add_(0, self.col, w)

    def replace(self, **kw) -> "Graph":
        """A copy with the fields ``kw`` replaced. New ``edge_weight``
        without new ``extras`` is a reweight (:meth:`with_edge_weight`); a
        caller that passes both (a copy to another device) passes the
        kernel structure that goes with the weights, as it is."""
        if "edge_weight" in kw and "extras" not in kw:
            w = kw.pop("edge_weight")
            return dataclasses.replace(self, **kw).with_edge_weight(w)
        return dataclasses.replace(self, **kw)

    def with_edge_weight(self, w: torch.Tensor) -> "Graph":
        """The graph with the weights ``w`` (``[e_pad]``). A kernel
        structure in ``extras``, which K1 reads, takes them too
        (``ops.cuda.reweighted_structure``): ``spmm_fw_w`` with their
        gradient, ``spmm_bw_w`` as a constant, one gather each; its
        topology and schedules stay. A structure that cannot take new
        weights (panel-major) raises."""
        g = dataclasses.replace(self, edge_weight=w)
        if g.extras and "spmm_fw_w" in g.extras:
            from ..ops.cuda import reweighted_structure

            g = dataclasses.replace(g, extras=reweighted_structure(g))
        return g

    def with_meta(self, **kw) -> "Graph":
        d = dict(self.meta)
        d.update(kw)
        return self.replace(meta=tuple(sorted(d.items())))

    def to(self, device) -> "Graph":
        """The same graph with every tensor on ``device``, extras included:
        a tensor, a ``Graph`` or a tuple of them (a heterogeneous graph's
        ``metapath_graphs``). A value that two keys share is moved once and
        stays shared (``metapath_graphs is relation_graphs``)."""
        device = torch.device(device)
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                moved[f.name] = v.to(device)
        if self.extras:
            done = {}

            def move(v):
                if id(v) not in done:
                    done[id(v)] = (tuple(move(u) for u in v)
                                   if isinstance(v, tuple) else v.to(device))
                return done[id(v)]

            moved["extras"] = {k: move(v) for k, v in self.extras.items()}
        return self.replace(**moved)

    def __repr__(self) -> str:  # short, shape-centric
        parts = [f"Graph(nodes={self.num_nodes}/{self.n_pad}, "
                 f"edges={self.num_edges}/{self.e_pad}"]
        if self.x is not None:
            parts.append(f", x={tuple(self.x.shape)}")
        if self.y is not None:
            parts.append(f", y={tuple(self.y.shape)}")
        parts.append(f", device={self.device}")
        return "".join(parts) + ")"


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------

def from_coo(
    edge_index,
    num_nodes: Optional[int] = None,
    edge_weight=None,
    edge_attr=None,
    edge_type=None,
    x=None,
    y=None,
    train_mask=None,
    val_mask=None,
    test_mask=None,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    bucket: bool = True,
    coalesce: bool = False,
    meta: Optional[Dict[str, Any]] = None,
) -> Graph:
    """Build a :class:`Graph` on the CPU from a COO edge list.

    ``edge_index`` is ``(2, E)`` with ``edge_index[0] = destination (row)``
    and ``edge_index[1] = source (col)``: ``spmm`` aggregates sources into
    destinations over CSR rows.
    """
    ei = _np(edge_index)
    if ei.ndim != 2 or ei.shape[0] != 2:
        raise ValueError(f"edge_index must be (2, E), got {ei.shape}")
    row, col = ei[0].astype(np.int64), ei[1].astype(np.int64)
    E = row.shape[0]
    if num_nodes is None:
        num_nodes = int(max(row.max(initial=-1), col.max(initial=-1)) + 1)
        if x is not None:
            num_nodes = max(num_nodes, int(_np(x).shape[0]))
    N = int(num_nodes)

    w = (np.ones(E, dtype=np.float32) if edge_weight is None
         else _np(edge_weight).astype(np.float32).reshape(E))
    ea = None if edge_attr is None else _np(edge_attr)
    et = (None if edge_type is None
          else _np(edge_type).astype(np.int32).reshape(E))

    # sort by (row, col) → CSR order, as a stable sort of one key: the
    # order np.lexsort((col, row)) gives, and fast on the nearly sorted
    # lists that a rebuild of a graph (add_self_loops) passes, where
    # lexsort is not
    span = max(N, int(col.max(initial=-1)) + 1)
    order = np.argsort(row * span + col, kind="stable")
    row, col, w = row[order], col[order], w[order]
    if ea is not None:
        ea = ea[order]
    if et is not None:
        et = et[order]

    if coalesce and E > 0:
        key = row * N + col
        uniq, inv = np.unique(key, return_inverse=True)
        w = np.bincount(inv, weights=w, minlength=uniq.shape[0]).astype(np.float32)
        row = (uniq // N).astype(np.int64)
        col = (uniq % N).astype(np.int64)
        if ea is not None or et is not None:
            # keep the first occurrence's attributes (the sentinel must be
            # LARGER than any index or minimum.at never updates it)
            first = np.full(uniq.shape[0], inv.shape[0], dtype=np.int64)
            np.minimum.at(first, inv, np.arange(inv.shape[0]))
            if ea is not None:
                ea = ea[first]
            if et is not None:
                et = et[first]
        E = row.shape[0]

    if n_pad is None:
        n_pad = _bucket(N + 1) if bucket else N + 1
    if e_pad is None:
        e_pad = _bucket(max(E, 1)) if bucket else max(E, 1)
    n_pad = max(n_pad, N + (1 if e_pad > E else 0))
    e_pad = max(e_pad, E)
    sink = n_pad - 1

    row_p = np.full(e_pad, sink, dtype=np.int32)
    col_p = np.full(e_pad, sink, dtype=np.int32)
    w_p = np.zeros(e_pad, dtype=np.float32)
    row_p[:E], col_p[:E], w_p[:E] = row, col, w

    # CSR pointer over padded rows: pad edges all live in the sink row
    counts = np.bincount(row_p, minlength=n_pad)
    row_ptr = np.zeros(n_pad + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])

    def _pad(a, size, fill=0):
        if a is None:
            return None
        if a.shape[0] == size:
            return a
        pad_shape = (size - a.shape[0],) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)])

    def _t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    def _mask(m):
        return None if m is None else _pad(_np(m).astype(bool), n_pad, False)

    meta_d = dict(meta or {})
    if et is not None and E > 0 and "num_relations" not in meta_d:
        meta_d["num_relations"] = int(et[:E].max()) + 1
    return Graph(
        row_ptr=_t(row_ptr),
        row=_t(row_p),
        col=_t(col_p),
        edge_weight=_t(w_p),
        edge_attr=_t(_pad(ea, e_pad)),
        edge_type=_t(_pad(et, e_pad)),
        x=_t(_pad(None if x is None else _np(x).astype(np.float32), n_pad)),
        y=_t(_pad(None if y is None else _np(y), n_pad)),
        train_mask=_t(_mask(train_mask)),
        val_mask=_t(_mask(val_mask)),
        test_mask=_t(_mask(test_mask)),
        num_nodes=N,
        num_edges=int(E),
        meta=tuple(sorted(meta_d.items())),
    )


# ---------------------------------------------------------------------------
# Weight transforms (on the graph's device)
# ---------------------------------------------------------------------------

def sym_norm(g: Graph, add_self_loops_first: bool = False) -> Graph:
    """GCN symmetric normalisation ``D^-1/2 A D^-1/2`` folded into
    ``edge_weight``, with a zero-degree guard. Idempotent through the
    ``meta["norm"]`` tag."""
    if g.meta_get("norm") == "sym":
        return g
    if add_self_loops_first:
        g = add_self_loops(g)
    deg = g.in_degrees(weighted=True)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                           torch.zeros_like(deg))
    w = g.edge_weight * inv_sqrt[g.row] * inv_sqrt[g.col]
    return _reweighted(g, w, "sym")


def row_norm(g: Graph) -> Graph:
    """Random-walk normalisation ``D^-1 A`` (destination degree)."""
    if g.meta_get("norm") == "row":
        return g
    deg = g.in_degrees(weighted=True)
    inv = torch.where(deg > 0, 1.0 / deg.clamp_min(1e-12), torch.zeros_like(deg))
    return _reweighted(g, g.edge_weight * inv[g.row], "row")


def col_norm(g: Graph) -> Graph:
    """``A D^-1`` (source degree) normalisation."""
    if g.meta_get("norm") == "col":
        return g
    deg = g.out_degrees(weighted=True)
    inv = torch.where(deg > 0, 1.0 / deg.clamp_min(1e-12), torch.zeros_like(deg))
    return _reweighted(g, g.edge_weight * inv[g.col], "col")


def _reweighted(g: Graph, w: torch.Tensor, norm: str) -> Graph:
    """``g`` with the weights ``w``, tagged ``meta["norm"] = norm``; a kernel
    structure in extras takes the new weights
    (:meth:`Graph.with_edge_weight`)."""
    return g.with_edge_weight(w).with_meta(norm=norm)


def _without_structure(g: Graph) -> Graph:
    """``g`` without the kernel structures in its extras (``spmm_*``);
    node-level extras are kept."""
    if not g.extras:
        return g
    extras = {k: v for k, v in g.extras.items() if not k.startswith("spmm_")}
    return g.replace(extras=extras or None)


# ---------------------------------------------------------------------------
# Structural transforms (host-side rebuild, result on the graph's device)
# ---------------------------------------------------------------------------

def _real_edges(g: Graph):
    E = g.num_edges
    return (_np(g.row)[:E].astype(np.int64), _np(g.col)[:E].astype(np.int64),
            _np(g.edge_weight)[:E])


def add_self_loops(g: Graph, fill_value: float = 1.0,
                   loop_type: int = 0) -> Graph:
    """Rebuild with one self loop per real node, replacing any existing self
    loops. Per-edge attrs follow their edges; loops get zero attrs /
    ``loop_type``."""
    row, col, w = _real_edges(g)
    keep = row != col
    loops = np.arange(g.num_nodes, dtype=np.int64)
    new_row = np.concatenate([row[keep], loops])
    new_col = np.concatenate([col[keep], loops])
    new_w = np.concatenate([w[keep], np.full(g.num_nodes, fill_value, np.float32)])
    ea, et = _edge_data(g)
    if ea is not None:
        ea = np.concatenate(
            [ea[keep], np.zeros((g.num_nodes,) + ea.shape[1:], ea.dtype)])
    if et is not None:
        et = np.concatenate([et[keep], np.full(g.num_nodes, loop_type, et.dtype)])
    return _rebuild_structure(g, new_row, new_col, new_w, ea, et)


def remove_self_loops(g: Graph) -> Graph:
    row, col, w = _real_edges(g)
    keep = row != col
    ea, et = _edge_data(g)
    return _rebuild_structure(g, row[keep], col[keep], w[keep],
                              None if ea is None else ea[keep],
                              None if et is None else et[keep])


def to_undirected(g: Graph) -> Graph:
    """Symmetrise: add reversed edges, keep the first copy of duplicates."""
    row, col, w = _real_edges(g)
    new_row = np.concatenate([row, col])
    new_col = np.concatenate([col, row])
    new_w = np.concatenate([w, w])
    key = new_row * g.num_nodes + new_col
    _, first = np.unique(key, return_index=True)
    ea, et = _edge_data(g)
    if ea is not None:
        ea = np.concatenate([ea, ea])[first]
    if et is not None:
        et = np.concatenate([et, et])[first]
    return _rebuild_structure(g, new_row[first], new_col[first], new_w[first],
                              ea, et)


def _edge_data(g: Graph):
    """Per-edge attr/type sliced to real edges (numpy), or None."""
    ea = None if g.edge_attr is None else _np(g.edge_attr)[: g.num_edges]
    et = None if g.edge_type is None else _np(g.edge_type)[: g.num_edges]
    return ea, et


def _rebuild_structure(g: Graph, row, col, w, ea=None, et=None) -> Graph:
    """Rebuild the adjacency and keep the node data. The normalisation tag is
    dropped (edges changed), as are kernel structures in extras (``spmm_*``
    index the old edge order); node-level extras are kept."""
    ng = from_coo(np.stack([row, col]), num_nodes=g.num_nodes, edge_weight=w,
                  edge_attr=ea, edge_type=et, bucket=True).to(g.device)
    return ng.replace(
        x=_repad_nodes(g.x, ng.n_pad),
        y=_repad_nodes(g.y, ng.n_pad),
        train_mask=_repad_nodes(g.train_mask, ng.n_pad),
        val_mask=_repad_nodes(g.val_mask, ng.n_pad),
        test_mask=_repad_nodes(g.test_mask, ng.n_pad),
        extras=_without_structure(g).extras,
        meta=tuple((k, v) for k, v in g.meta if k != "norm"),
    )


def _repad_nodes(a: Optional[torch.Tensor], n_pad: int):
    if a is None:
        return None
    if a.shape[0] == n_pad:
        return a
    if a.shape[0] > n_pad:
        return a[:n_pad]
    pad = a.new_zeros((n_pad - a.shape[0],) + tuple(a.shape[1:]))
    return torch.cat([a, pad])


def pad_to(g: Graph, n_pad: int, e_pad: int) -> Graph:
    """Repad an existing graph to larger static sizes."""
    if n_pad < g.n_pad or e_pad < g.e_pad:
        raise ValueError("pad_to can only grow the static shapes")
    row, col, w = _real_edges(g)
    ng = from_coo(np.stack([row, col]), num_nodes=g.num_nodes, edge_weight=w,
                  n_pad=n_pad, e_pad=e_pad, bucket=False).to(g.device)
    return ng.replace(
        x=_repad_nodes(g.x, ng.n_pad),
        y=_repad_nodes(g.y, ng.n_pad),
        train_mask=_repad_nodes(g.train_mask, ng.n_pad),
        val_mask=_repad_nodes(g.val_mask, ng.n_pad),
        test_mask=_repad_nodes(g.test_mask, ng.n_pad),
        extras=g.extras,
        meta=g.meta,
    )
