"""Host-side samplers — the port of ``cogdl_tpu/data/sampling.py``: the
neighbor path (``graph_csr``, ``sample_adj``, ``NeighborSampler``,
``Prefetcher``) and the cluster and GraphSAINT samplers (``bfs_partition``,
``bfs_partition_cached``, ``ClusterLoader``, ``saint_node_subgraph``,
``saint_walk_subgraph``, ``random_partition_batches``).

The sampler runs on the host with numpy and the port's C++ library
(``cogdl_tpu_torch.native``) and emits statically shaped batches: per-hop
block Graphs over one deduplicated node frame, outermost-first, built by
``from_coo`` on the CPU. ``Prefetcher`` runs the sampler in a worker thread
and, for a card, copies each batch there from pinned memory on a stream of
its own, so sampling and the copy overlap the train step.

Draws follow the JAX package: one ``numpy.random.Generator`` per sampler,
advanced exactly as the JAX sampler advances its own. ``backend="native"``
draws one 62-bit seed from it a hop and hands that to the library (whose
draws are fixed by that seed and the thread count); ``backend="numpy"`` is
the JAX package's numpy branch and runs only when asked for.

Not ported yet (ROADMAP.md §1, item 11f): the cluster and GraphSAINT
samplers of the same module.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
import weakref
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from .graph import Graph, _bucket, _np, from_coo

__all__ = ["graph_csr", "sample_adj", "NeighborSampler", "Prefetcher",
           "bfs_partition", "bfs_partition_cached", "ClusterLoader",
           "saint_node_subgraph", "saint_walk_subgraph",
           "random_partition_batches"]

BACKENDS = ("native", "numpy")


def graph_csr(graph: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, weights) of the real edges, destination-major, on
    the host."""
    E = graph.num_edges
    row = _np(graph.row[:E])
    col = _np(graph.col[:E])
    w = _np(graph.edge_weight[:E])
    order = np.argsort(row, kind="stable")
    row, col, w = row[order], col[order], w[order]
    indptr = np.zeros(graph.num_nodes + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=graph.num_nodes), out=indptr[1:])
    return indptr, col, w


def sample_adj(indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray,
               fanout: int, rng: np.random.Generator,
               backend: str = "native", num_threads: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-hop fanout sampling with replacement: ``(src_global, dst_local,
    mask)``, each ``[len(seeds) · fanout]``, seed-major; a seed without an
    edge gets itself in every slot, masked off.

    ``backend="native"``: the port's C++ library on ``num_threads`` threads
    (the machine's OpenMP count when None), seeded with one
    ``rng.integers(0, 2**62)``. ``backend="numpy"``: the JAX package's numpy
    branch (``cogdl_tpu/data/sampling.py:53-68``): ``rng.random`` offsets in
    float64, truncated, capped at ``deg − 1``, positions capped at the last
    edge."""
    n = seeds.shape[0]
    if backend == "native":
        src, mask = native.sample_neighbors(
            indptr, indices, seeds, fanout, seed=int(rng.integers(0, 2 ** 62)),
            num_threads=(native.max_threads() if num_threads is None
                         else num_threads))
        return src, np.repeat(np.arange(n), fanout), mask
    if backend != "numpy":
        raise ValueError(f"sample_adj: backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    deg = indptr[seeds + 1] - indptr[seeds]
    offs = (rng.random((n, fanout)) * np.maximum(deg, 1)[:, None]).astype(
        np.int64)
    take = np.minimum(offs, np.maximum(deg - 1, 0)[:, None])
    # a zero-degree seed's CSR offset may equal len(indices)
    pos = np.minimum(indptr[seeds][:, None] + take,
                     max(indices.shape[0] - 1, 0))
    src = indices[pos] if indices.size else np.zeros((n, fanout), np.int64)
    mask = np.broadcast_to(deg[:, None], (n, fanout)) > 0
    # masked slots point at the seed itself, so relabelling never meets an
    # id outside the frame
    src = np.where(mask, src, seeds[:, None])
    dst_local = np.broadcast_to(np.arange(n)[:, None], (n, fanout))
    return src.ravel(), dst_local.ravel(), mask.ravel()


class NeighborSampler:
    """Multi-hop fanout sampler → per-hop bipartite block Graphs on the CPU.

    Each batch is ``(blocks, frame, seeds)``: ``frame`` the global ids of
    the batch's node frame (the seeds first, then each hop's new nodes in
    order of first occurrence), ``seeds`` the ``batch_size`` seed ids (the
    last batch of an epoch wrap-padded from the start of the shuffled ids).
    ``blocks[i]`` is read by layer ``i``: ``blocks[0]`` holds the last hop's
    edges, ``blocks[-1]`` the seeds' own. All blocks share ``n_pad =
    _bucket(layer_sizes[-1] + 1)`` rows; block ``k`` counted from the seeds
    has ``e_pad = _bucket(layer_sizes[k] · fanouts[k])`` slots. Every block
    carries the frame's ``x`` (unless ``device_features``), ``y`` and
    ``train_mask`` rows, one tensor each, shared. With ``device_features``
    the feature table stays where the graph is: ``blocks[0].extras`` holds
    ``x_table`` (the graph's ``x``) and ``frame``, ``int32[n_pad]`` padded
    with the table's sink row ``graph.n_pad − 1``.

    ``backend``/``num_threads`` as :func:`sample_adj`; ``num_threads`` is
    the machine's OpenMP count when None, and the count used is kept in
    ``self.num_threads`` (None under ``backend="numpy"``)."""

    def __init__(self, graph: Graph, fanouts: Sequence[int],
                 batch_size: int = 512, seed: int = 0,
                 node_idx: Optional[np.ndarray] = None,
                 device_features: bool = False, backend: str = "native",
                 num_threads: Optional[int] = None):
        if backend not in BACKENDS:
            raise ValueError(f"NeighborSampler: backend must be one of "
                             f"{BACKENDS}, got {backend!r}")
        self.graph = graph
        self.fanouts = [int(f) for f in fanouts]
        self.batch_size = int(batch_size)
        self.device_features = device_features
        self.backend = backend
        self.num_threads = None
        if backend == "native":
            self.num_threads = (native.max_threads() if num_threads is None
                                else int(num_threads))
        self.rng = np.random.default_rng(seed)
        self.indptr, indices, _ = graph_csr(graph)
        # int64 once, not at every call into the library
        self.indices = indices.astype(np.int64)
        # the node rows a batch gathers, read off the graph's device once
        self._x = (None if graph.x is None or device_features
                   else _np(graph.x))
        self._y = None if graph.y is None else _np(graph.y)
        self._train_mask = (None if graph.train_mask is None
                            else _np(graph.train_mask))
        if node_idx is None:
            if self._train_mask is None:
                raise ValueError("NeighborSampler: no node_idx and no train "
                                 "mask to take the seeds from")
            node_idx = np.nonzero(self._train_mask[: graph.num_nodes])[0]
        self.node_idx = np.asarray(node_idx)
        if self.node_idx.size == 0:
            raise ValueError("NeighborSampler: no seed nodes (empty train "
                             "mask)")
        sizes = [self.batch_size]
        for f in self.fanouts:
            sizes.append(sizes[-1] * f + sizes[-1])
        self.layer_sizes = sizes   # nodes at each depth (upper bound)

    def __len__(self):
        return (len(self.node_idx) + self.batch_size - 1) // self.batch_size

    def epoch(self, shuffle: bool = True
              ) -> Iterator[Tuple[List[Graph], np.ndarray, np.ndarray]]:
        idx = self.node_idx.copy()
        if shuffle:
            self.rng.shuffle(idx)
        B = self.batch_size
        for start in range(0, len(idx), B):
            seeds = idx[start: start + B]
            if seeds.shape[0] < B:
                # static batch: np.resize tiles cyclically, also when B >
                # len(idx)
                seeds = np.concatenate(
                    [seeds, np.resize(idx, B - seeds.shape[0])])
            yield self._batch(seeds) + (seeds,)

    def _batch(self, seeds: np.ndarray) -> Tuple[List[Graph], np.ndarray]:
        cur = seeds
        per_hop = []
        for f in self.fanouts:
            src, dst_local, mask = sample_adj(
                self.indptr, self.indices, cur, f, self.rng, self.backend,
                self.num_threads)
            per_hop.append((src, dst_local, mask, cur))
            cur = np.concatenate([cur, src[mask]])   # destinations first
            cur = cur[np.sort(np.unique(cur, return_index=True)[1])]
        frame = cur
        n_pad = _bucket(self.layer_sizes[-1] + 1)
        e_pads = [_bucket(self.layer_sizes[k] * self.fanouts[k])
                  for k in range(len(self.fanouts))]
        order = np.argsort(frame)
        sorted_frame = frame[order]

        def relabel(ids):
            return order[np.searchsorted(sorted_frame, ids)]

        rows_of = {}
        if self._x is not None:
            feats = np.zeros((n_pad, self._x.shape[1]), self._x.dtype)
            feats[: frame.shape[0]] = self._x[frame]
            rows_of["x"] = torch.from_numpy(feats)
        if self._y is not None:
            ys = np.zeros((n_pad,) + self._y.shape[1:], self._y.dtype)
            ys[: frame.shape[0]] = self._y[frame]
            rows_of["y"] = torch.from_numpy(ys)
        # the train mask per frame row: a wrap-padded batch dedups, so its
        # first batch_size rows may hold sampled neighbours, whose labels
        # must not train
        tm = np.zeros(n_pad, bool)
        if self._train_mask is not None:
            tm[: frame.shape[0]] = self._train_mask[frame]
        rows_of["train_mask"] = torch.from_numpy(tm)
        blocks = []
        for k, (src, dst_local, mask, dst_global) in enumerate(per_hop):
            rows = relabel(dst_global)[dst_local][mask]
            cols = relabel(src)[mask]
            blocks.append(from_coo(np.stack([rows, cols]),
                                   num_nodes=frame.shape[0], n_pad=n_pad,
                                   e_pad=e_pads[k]).replace(**rows_of))
        blocks.reverse()   # outermost first: layer i reads blocks[i]
        if self.device_features:
            fr = np.full(n_pad, self.graph.n_pad - 1, np.int32)
            fr[: frame.shape[0]] = frame
            blocks[0] = blocks[0].replace(extras={
                "frame": torch.from_numpy(fr), "x_table": self.graph.x})
        return blocks, frame


_END = object()


def _to_device(item, device: torch.device, copied: list, memo: dict):
    """``item`` (Graphs, tuples, lists, dicts of tensors) with every tensor
    not yet on ``device`` copied there from pinned memory, asynchronously on
    the current stream; each tensor once however often it occurs. The new
    device tensors are appended to ``copied``."""
    if isinstance(item, torch.Tensor):
        if item.device == device:
            return item
        if id(item) not in memo:
            t = item.pin_memory().to(device, non_blocking=True)
            memo[id(item)] = t
            copied.append(t)
        return memo[id(item)]
    if isinstance(item, Graph):
        fields = {f: getattr(item, f) for f in item.__dataclass_fields__}
        moved = {k: _to_device(v, device, copied, memo)
                 for k, v in fields.items()
                 if isinstance(v, (torch.Tensor, dict))}
        return item.replace(**moved)
    if isinstance(item, dict):
        return {k: _to_device(v, device, copied, memo)
                for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_to_device(v, device, copied, memo) for v in item)
    return item


class Prefetcher:
    """Background-thread batch pipeline: the sampler (and, for a card, the
    copy of each batch there) runs ahead of the train step in a worker
    thread, a bounded queue of ``depth`` batches between them.

    Wraps a zero-argument iterator factory; each ``iter()`` starts a fresh
    worker thread (one an epoch), so the object can be iterated again. A
    worker's exception is raised in the consumer. When the consumer stops
    early (the iterator is closed or collected) the worker stops after the
    batch it is on.

    ``device`` a card: the worker copies each batch's tensors from pinned
    host memory with ``non_blocking=True`` on a CUDA stream of its own and
    records an event; the consumer's stream waits on that event before the
    batch is handed out, and every copied tensor is marked as used on the
    consumer's stream (``record_stream``), so the caching allocator does not
    hand its memory to the copy stream while a step still reads it. Tensors
    already on the card (a resident feature table) are passed as they are.
    ``device`` None or the CPU: batches pass through unchanged."""

    def __init__(self, factory, depth: int = 2, device=None):
        self.factory = factory
        self.depth = depth
        self.device = None if device is None else torch.device(device)

    def __iter__(self):
        cuda = self.device is not None and self.device.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        stream = torch.cuda.Stream(self.device) if cuda else None

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self.factory():
                    if cuda:
                        copied = []
                        with torch.cuda.stream(stream):
                            item = _to_device(item, self.device, copied, {})
                            event = torch.cuda.Event()
                            event.record(stream)
                        item = (item, event, copied)
                    if not put(item):
                        return
                put(_END)
            except BaseException as e:   # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                if cuda:
                    item, event, copied = item
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for c in copied:
                        c.record_stream(current)
                yield item
        finally:
            stop.set()
            t.join()


# ---------------------------------------------------------------------------
# The cluster (ClusterGCN) and GraphSAINT samplers
# ---------------------------------------------------------------------------

def bfs_partition(graph: Graph, n_parts: int, seed: int = 0,
                  weights=None, node_slack: float = 1.5) -> np.ndarray:
    """Balanced BFS-grown partition, ``int64[num_nodes]`` part ids: a greedy
    multi-source BFS with a budget cap per part, the JAX package's stand-in
    for METIS (``cogdl_tpu/data/sampling.py:247``), ported as it is (a
    Python loop over the edges of each frontier until its part is full).

    ``weights=None`` balances node counts. ``weights="degree"`` balances
    each part's sum of in-degree + 1 instead, with a second cap of
    ``node_slack`` × the balanced share on its node count; an explicit
    per-node weight array is balanced the same way."""
    N = graph.num_nodes
    indptr, indices, _ = graph_csr(graph)
    rng = np.random.default_rng(seed)
    if weights is None:
        wt = np.ones(N, np.int64)
        node_cap = None
    else:
        if isinstance(weights, str):
            if weights != "degree":
                raise ValueError(f"unknown weights {weights!r}")
            wt = (indptr[1:] - indptr[:-1]).astype(np.int64) + 1
        else:
            wt = np.asarray(weights, np.int64)
        node_cap = int(np.ceil(N / n_parts * node_slack))
    cap = int(np.ceil(wt.sum() / n_parts))
    part = np.full(N, -1, np.int64)
    sizes = np.zeros(n_parts, np.int64)      # weight budget used
    counts = np.zeros(n_parts, np.int64)     # node counts

    def fits(p):
        return sizes[p] < cap and (node_cap is None or counts[p] < node_cap)

    seeds = rng.choice(N, size=n_parts, replace=N < n_parts)
    frontiers = [[s] for s in seeds]
    for p, s in enumerate(seeds):
        if part[s] == -1:
            part[s] = p
            sizes[p] += wt[s]
            counts[p] += 1
    active = True
    while active:
        active = False
        for p in range(n_parts):
            if not fits(p) or not frontiers[p]:
                continue
            nxt = []
            for u in frontiers[p]:
                for v in indices[indptr[u]: indptr[u + 1]]:
                    if part[v] == -1 and fits(p):
                        part[v] = p
                        sizes[p] += wt[v]
                        counts[p] += 1
                        nxt.append(v)
            frontiers[p] = nxt
            if nxt:
                active = True
    # unassigned (disconnected, or every reachable part capped) → the
    # lightest part under the node cap
    for v in np.nonzero(part == -1)[0]:
        order = np.argsort(sizes)
        p = next((int(q) for q in order
                  if node_cap is None or counts[q] < node_cap), int(order[0]))
        part[v] = p
        sizes[p] += wt[v]
        counts[p] += 1
    return part


_DIGEST_CACHE: dict = {}


def _structure_digest(row, col, E: int) -> str:
    """Fingerprint of the first ``E`` entries of ``row`` and ``col`` (int32,
    as both packages store them), memoized per (row, col) object identity:
    on a card the hash copies both edge arrays to the host, which a second
    lookup on the same Graph must not pay again. Weak references guard
    against ``id()`` reuse after collection."""
    key = (id(row), id(col), E)
    hit = _DIGEST_CACHE.get(key)
    if hit is not None:
        ref_r, ref_c, digest = hit
        if ref_r() is row and ref_c() is col:
            return digest
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(_np(row[:E])))
    h.update(np.ascontiguousarray(_np(col[:E])))
    digest = h.hexdigest()
    try:
        _DIGEST_CACHE[key] = (weakref.ref(row), weakref.ref(col), digest)
        if len(_DIGEST_CACHE) > 64:
            _DIGEST_CACHE.pop(next(iter(_DIGEST_CACHE)))
    except TypeError:   # an array type without weak references: no memo
        pass
    return digest


def bfs_partition_cached(graph: Graph, n_parts: int, seed: int = 0,
                         weights=None, cache_dir=None) -> np.ndarray:
    """:func:`bfs_partition` with a cache on disk under ``cache_dir`` (None:
    no cache), one ``.npy`` file per graph and parameters. The file name
    holds the graph's name, node and edge counts, the digest of its edge
    structure and the parameters (a custom weight array by a digest of its
    values): the JAX package forms the same name for the same graph."""
    if cache_dir is None:
        return bfs_partition(graph, n_parts, seed, weights=weights)
    name = graph.meta_get("name", "graph")
    E = graph.num_edges
    gdigest = _structure_digest(graph.row, graph.col, E)
    if isinstance(weights, (str, type(None))):
        wtag = weights
    else:
        wh = hashlib.blake2b(np.ascontiguousarray(np.asarray(weights)),
                             digest_size=6)
        wtag = f"custom{wh.hexdigest()}"
    key = (f"{name}_N{graph.num_nodes}_E{E}_g{gdigest}"
           f"_p{n_parts}_s{seed}_w{wtag}.npy")
    path = os.path.join(cache_dir, key)
    if os.path.exists(path):
        part = np.load(path)
        if part.shape[0] == graph.num_nodes:
            return part
    part = bfs_partition(graph, n_parts, seed, weights=weights)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, part)
    os.replace(tmp, path)
    return part


class ClusterLoader:
    """ClusterGCN loader: each epoch, a random order of the partition's
    parts cut into groups of ``batch_size`` parts, each group's induced
    subgraph one batch Graph on the CPU (reference
    ``cogdl_tpu/data/sampling.py:387``).

    Every batch has ``n_pad = _bucket(sum of the batch_size largest part
    sizes + 1)`` rows; ``e_pad`` is the bucket of the epoch's largest edge
    count, and grows when a later epoch has a larger one. A batch carries
    the group's edges with the graph's weights as they are, its ``x``,
    ``y`` and ``train_mask`` rows, and ``num_classes`` as its only meta (so
    a model normalises it again, as in the JAX package). The loader's
    generator draws each epoch's order; the partition gets a generator of
    its own from the same ``seed``. ``cache_dir`` as
    :func:`bfs_partition_cached`."""

    def __init__(self, graph: Graph, n_clusters: int = 20,
                 batch_size: int = 5, seed: int = 0, cache_dir=None):
        self.graph = graph
        self.n_clusters = n_clusters
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.part = bfs_partition_cached(graph, n_clusters, seed,
                                         cache_dir=cache_dir)
        counts = np.bincount(self.part, minlength=n_clusters)
        self.n_pad = _bucket(int(np.sort(counts)[-batch_size:].sum()) + 1)
        self._host_copies(graph)

        self.e_pad = None   # set by the first epoch's scan

    def _host_copies(self, graph: Graph) -> None:
        """The graph's edges and node rows on the host, copied once."""
        E = graph.num_edges
        self._row = _np(graph.row[:E])
        self._col = _np(graph.col[:E])
        self._w = _np(graph.edge_weight[:E])
        self._x = None if graph.x is None else _np(graph.x)
        self._y = None if graph.y is None else _np(graph.y)
        self._train_mask = (None if graph.train_mask is None
                            else _np(graph.train_mask))

    def epoch(self) -> Iterator[Graph]:
        order = self.rng.permutation(self.n_clusters)
        groups = [order[i: i + self.batch_size]
                  for i in range(0, self.n_clusters, self.batch_size)]
        batches = [self._induced(np.nonzero(np.isin(self.part, grp))[0])
                   for grp in groups]
        # one e_pad for the epoch
        e_max = max(b[0].shape[1] if b[0].shape[1] else 1 for b in batches)
        if self.e_pad is None or e_max > self.e_pad:
            self.e_pad = _bucket(e_max)
        for ei, nodes, w in batches:
            g = from_coo(ei, num_nodes=nodes.shape[0], edge_weight=w,
                         n_pad=self.n_pad, e_pad=self.e_pad,
                         meta={"num_classes": self.graph.num_classes})

            def pad_nodes(a, fill=0):
                if a is None:
                    return None
                out = np.full((self.n_pad,) + a.shape[1:], fill, a.dtype)
                out[: nodes.shape[0]] = a[nodes]
                return torch.from_numpy(out)

            yield g.replace(x=pad_nodes(self._x), y=pad_nodes(self._y),
                            train_mask=pad_nodes(self._train_mask, False))

    def _induced(self, nodes: np.ndarray):
        """``(edge_index, nodes, weights)`` of the subgraph induced by the
        sorted global ids ``nodes``, relabelled to ``0..len(nodes)``."""
        sel = np.zeros(self.graph.num_nodes, bool)
        sel[nodes] = True
        emask = sel[self._row] & sel[self._col]
        r, c, w = self._row[emask], self._col[emask], self._w[emask]
        relabel = np.full(self.graph.num_nodes, -1, np.int64)
        relabel[nodes] = np.arange(nodes.shape[0])
        return np.stack([relabel[r], relabel[c]]), nodes, w


def saint_node_subgraph(graph: Graph, size: int, rng) -> np.ndarray:
    """GraphSAINT node sampler: ``size`` distinct nodes, uniformly."""
    return rng.choice(graph.num_nodes, size=size, replace=False)


def saint_walk_subgraph(graph: Graph, roots: int, length: int, rng,
                        csr=None) -> np.ndarray:
    """GraphSAINT random-walk sampler: the sorted distinct nodes touched by
    ``roots`` walks of ``length`` steps from uniform roots (a node without
    an edge stays put). ``csr``: the graph's :func:`graph_csr`, when the
    caller keeps it (it is built from the graph otherwise, as the JAX
    package builds it at every call); the draws are the same."""
    indptr, indices, _ = graph_csr(graph) if csr is None else csr
    starts = rng.choice(graph.num_nodes, size=roots)
    nodes = [starts]
    cur = starts
    deg = np.diff(indptr)
    for _ in range(length):
        d = deg[cur]
        off = (rng.random(cur.shape[0]) * np.maximum(d, 1)).astype(np.int64)
        nxt = indices[indptr[cur] + np.minimum(off, np.maximum(d - 1, 0))]
        cur = np.where(d > 0, nxt, cur)
        nodes.append(cur)
    return np.unique(np.concatenate(nodes))


def random_partition_batches(graph: Graph, n_parts: int, seed: int = 0
                             ) -> Iterator[Graph]:
    """One epoch of induced subgraphs over a uniformly random node partition
    into ``n_parts`` parts, one part a batch (reference
    ``cogdl_tpu/data/sampling.py:473``)."""
    rng = np.random.default_rng(seed)
    part = rng.integers(0, n_parts, graph.num_nodes)
    loader = ClusterLoader.__new__(ClusterLoader)
    loader.graph = graph
    loader.part = part
    loader.n_clusters = n_parts
    loader.batch_size = 1
    loader.rng = rng
    counts = np.bincount(part, minlength=n_parts)
    loader.n_pad = _bucket(int(counts.max()) + 1)
    loader.e_pad = None
    loader._host_copies(graph)
    return loader.epoch()
