"""Host-side neighbor sampling — the port of the host neighbor path of
``cogdl_tpu/data/sampling.py`` (``graph_csr``, ``sample_adj``,
``NeighborSampler``, ``Prefetcher``).

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

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from .graph import Graph, _bucket, _np, from_coo

__all__ = ["graph_csr", "sample_adj", "NeighborSampler", "Prefetcher"]

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
