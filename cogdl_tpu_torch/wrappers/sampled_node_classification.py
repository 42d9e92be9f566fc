"""Sampled mini-batch node classification — the port of
``cogdl_tpu/wrappers/sampled_node_classification.py``: the neighbor
sampling wrappers (``SampledNodeClfWrapper``,
``DeviceSampledNodeClfWrapper``) and the subgraph wrappers
(``ClusterNodeClfWrapper``, ``GraphSAINTWrapper``).

``SampledNodeClfWrapper`` (``neighbor_sampling``) samples each mini-batch
on the host (``data/sampling.py``: the port's C++ sampler, or the JAX
package's numpy branch when asked for) in a prefetch worker, which also
builds the kernels' structure of each block when the model reads it and
copies the batch to the card. ``DeviceSampledNodeClfWrapper``
(``neighbor_sampling_device``) samples on the device from the prepared
graph's CSR (``data/device_sampling.py``): a batch costs the host one
``[B]`` seed row. Evaluation is full batch in both, inherited from
``NodeClfWrapper``, so on the card it runs the kernels the full-batch model
runs (K1 for GraphSAGE ``sum``/``gcn``, K3 for GAT).

``ClusterNodeClfWrapper`` (``cluster``, ClusterGCN) trains on the induced
subgraphs of groups of BFS-partition parts, ``GraphSAINTWrapper``
(``graphsaint``) on GraphSAINT's node or random-walk subgraphs with its
unbiased estimator. Their batches are drawn on the host in a prefetch
worker, which also applies the model's normalisation and builds each
batch's kernel structure when the model reads it, then copies the batch to
the card; evaluation is full batch.
"""

from __future__ import annotations

import collections
import time
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.device_sampling import (
    DeviceNeighborSampler,
    frame_features,
    sample_blocks_device,
)
from ..data.graph import Graph, _np, from_coo, sym_norm
from ..data.sampling import (
    ClusterLoader,
    NeighborSampler,
    Prefetcher,
    graph_csr,
    saint_node_subgraph,
    saint_walk_subgraph,
)
from ..layers import GATLayer, GCNLayer, SAGELayer, SAINTLayer
from ..ops.cuda import prepare_spmm
from ..utils.evaluator import masked_cross_entropy
from .node_classification import NodeClfWrapper, apply_adj_norm


def timed_batches(draws: Iterator, prepare, host_ms) -> Iterator:
    """Each batch of ``draws`` through ``prepare`` (None: as drawn), the
    prefetch worker's own time a batch appended to ``host_ms`` as ``(draw,
    prepare)`` in ms, ``prepare`` None where there is nothing to
    prepare."""
    while True:
        t0 = time.perf_counter()
        batch = next(draws, None)
        if batch is None:
            return
        t1 = time.perf_counter()
        prepare_ms = None
        if prepare is not None:
            batch = prepare(batch)
            prepare_ms = (time.perf_counter() - t1) * 1e3
        host_ms.append(((t1 - t0) * 1e3, prepare_ms))
        yield batch


def reads_kernel_structure(model) -> bool:
    """Whether a layer of ``model`` runs K1 or K3 over a batch, and so needs
    the structure ``prepare_spmm`` builds: GAT, GCN, SAINT layers that
    propagate (order above 0), GraphSAGE summing its neighbours (``sum``,
    ``gcn``), and every layer whose ``calls_spmm`` says it propagates
    (GCNII, APPNP, MixHop and SGC). GraphSAGE ``mean`` and ``max`` and
    DeeperGCN's GENConv are torch index ops."""
    return any(isinstance(m, (GATLayer, GCNLayer))
               or (isinstance(m, SAGELayer) and m.aggr in ("sum", "gcn"))
               or (isinstance(m, SAINTLayer) and m.order > 0)
               or getattr(m, "calls_spmm", False)
               for m in model.modules())


class SampledNodeClfWrapper(NodeClfWrapper):
    """Neighbor-sampled training on host-sampled blocks, full-batch
    evaluation (reference ``cogdl_tpu/wrappers/sampled_node_classification.py:23-92``).

    ``train_batches`` gives a :class:`Prefetcher` over one epoch of the
    sampler, read anew every epoch (``refresh_per_epoch``). Its worker
    samples each batch and, when the model reads it, builds every block's
    kernel structure with ``prepare_spmm`` on the host (building it on the
    card would stop the stream at every batch), then copies the batch to
    the graph's device. ``host_ms`` keeps the worker's own time a batch,
    ``(sampling, structure)`` in ms (structure None where none is built),
    for the last 4096 batches.
    ``backend``/``num_threads``: the sampler's (``data/sampling.py``)."""

    refresh_per_epoch = True

    def __init__(self, model, dataset=None, fanouts=(10, 10),
                 batch_size: int = 256, seed: int = 0,
                 device_features: bool = False, backend: str = "native",
                 num_threads: Optional[int] = None):
        super().__init__(model, dataset)
        self.fanouts = list(fanouts)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.device_features = device_features
        self.backend = backend
        self.num_threads = num_threads
        self.host_ms = collections.deque(maxlen=4096)
        self._sampler = None

    def prepare_graph(self, graph: Graph) -> Graph:
        """``NodeClfWrapper.prepare_graph``, then the sampler over the
        prepared graph."""
        graph = super().prepare_graph(graph)
        self.build_sampler(graph)
        return graph

    def build_sampler(self, graph: Graph) -> NeighborSampler:
        """The host sampler over ``graph`` (called by ``prepare_graph``)."""
        self._sampler = NeighborSampler(
            graph, self.fanouts, batch_size=self.batch_size, seed=self.seed,
            device_features=self.device_features, backend=self.backend,
            num_threads=self.num_threads)
        return self._sampler

    def draw_init_batch(self):
        """The shape-defining batch the JAX wrapper's ``init`` samples
        (``next(epoch(shuffle=False))``). The port's models take their
        shapes from their constructor, but the draw advances the sampler's
        generator, and every later batch depends on it."""
        return next(self._sampler.epoch(shuffle=False))

    def init(self, generator: torch.Generator, graph: Graph):
        self.draw_init_batch()
        super().init(generator, graph)

    def _epoch_batches(self):
        """One epoch of batches (the block tuple), each block with the
        kernels' structure when the model reads it; times the host's work."""
        prepare = None
        if reads_kernel_structure(self.model):
            def prepare(blocks):
                return tuple(prepare_spmm(b) for b in blocks)
        return timed_batches((tuple(b[0]) for b in self._sampler.epoch()),
                             prepare, self.host_ms)

    @staticmethod
    def _block_x(blocks):
        """The frame's features: carried by the first block, or gathered
        from the resident table (``device_features``)."""
        if blocks[0].x is not None:
            return blocks[0].x
        return frame_features(blocks)

    def train_batches(self, graph: Graph) -> Prefetcher:
        return Prefetcher(self._epoch_batches, device=graph.device)

    def loss(self, batch, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        """Cross-entropy over the frame's first ``batch_size`` rows (the
        seeds, deduplicated) that are train nodes by the per-frame train
        mask."""
        blocks = list(batch)
        logits = self.model(blocks, self._block_x(blocks), training=training,
                            generator=generator)
        B = self.batch_size
        tm = blocks[0].train_mask
        mask = (torch.ones(B, dtype=torch.bool, device=logits.device)
                if tm is None else tm[:B])
        return masked_cross_entropy(logits[:B], blocks[0].y[:B], mask)


class DeviceSampledNodeClfWrapper(NodeClfWrapper):
    """Neighbor-sampled training with on-device sampling, full-batch
    evaluation. Follows the trainer's epoch protocol: ``epoch_xs`` gives an
    epoch's ``[n_batches, B]`` seed rows (new seeds every epoch) and
    ``make_batch`` one step's batch; the step samples its blocks inside
    ``loss``. ``init`` is inherited: the port's models take their shapes
    from their constructor, so unlike the JAX wrapper it samples no batch
    to initialise them."""

    refresh_per_epoch = True

    def __init__(self, model, dataset=None, fanouts=(10, 10),
                 batch_size: int = 256, seed: int = 0):
        super().__init__(model, dataset)
        self.fanouts = tuple(int(f) for f in fanouts)
        self.batch_size = int(batch_size)
        self.seed = seed
        self._sampler = None

    def prepare_graph(self, graph: Graph) -> Graph:
        """``NodeClfWrapper.prepare_graph`` (self loops, norm, the kernels'
        structure on the card), then the sampler over the prepared graph."""
        graph = super().prepare_graph(graph)
        self._sampler = DeviceNeighborSampler(
            graph, self.fanouts, batch_size=self.batch_size, seed=self.seed)
        return graph

    def train_batches(self, graph: Graph):
        return [self.make_batch(graph, x) for x in self.epoch_xs(graph)]

    def epoch_xs(self, graph: Graph) -> torch.Tensor:
        """One epoch's shuffled seed rows, ``int32[n_batches, B]``, copied to
        the graph's device in one transfer."""
        return torch.from_numpy(self._sampler.epoch_seeds()).to(graph.device)

    def make_batch(self, graph: Graph, x: torch.Tensor):
        return {"graph": graph, "seeds": x}

    def loss(self, batch, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        """Sample the batch's blocks from ``generator``, run the model over
        them and take the cross-entropy over the seed rows (``logits[:B]``
        with the ``[B]`` labels and train mask the sampler gathered)."""
        blocks, _ = sample_blocks_device(batch["graph"], batch["seeds"],
                                         generator, self.fanouts)
        logits = self.model(list(blocks), frame_features(blocks),
                            training=training, generator=generator)
        ex = blocks[0].extras
        B = self.batch_size
        mask = ex["seed_train_mask"]
        if mask is None:
            mask = torch.ones(B, dtype=torch.bool, device=logits.device)
        return masked_cross_entropy(logits[:B], ex["seed_y"], mask)


class _SubgraphClfWrapper(NodeClfWrapper):
    """Training on one subgraph Graph a batch, full-batch evaluation: the
    part the cluster and GraphSAINT wrappers share.

    ``train_batches`` gives a :class:`Prefetcher` over one epoch of
    subgraphs (:meth:`_epoch_factory`). Its worker draws each batch and,
    when the model reads it, applies the model's adjacency normalisation
    and then builds the batch's kernel structure with ``prepare_spmm`` on
    the host, from the final weights; then it copies the batch to the
    graph's device. ``host_ms`` keeps the worker's own time a batch,
    ``(subgraph, structure)`` in ms (structure None where none is built),
    for the last 4096 batches."""

    refresh_per_epoch = True

    def __init__(self, model, dataset=None):
        super().__init__(model, dataset)
        self.host_ms = collections.deque(maxlen=4096)

    def _epoch_factory(self):
        """A zero-argument callable giving one epoch's subgraphs; called
        once by each ``train_batches``."""
        raise NotImplementedError

    def _prepare(self, batch: Graph) -> Graph:
        """The model's normalisation, then the kernels' structure from the
        final weights."""
        return prepare_spmm(apply_adj_norm(self.model, batch))

    def train_batches(self, graph: Graph) -> Prefetcher:
        draws = self._epoch_factory()
        prepare = (self._prepare if reads_kernel_structure(self.model)
                   else None)
        return Prefetcher(
            lambda: timed_batches(draws(), prepare, self.host_ms),
            device=graph.device)


class ClusterNodeClfWrapper(_SubgraphClfWrapper):
    """ClusterGCN: batches of ``cluster_batch`` parts of a BFS partition
    into ``n_clusters`` parts, a new random grouping every epoch (reference
    ``cogdl_tpu/wrappers/sampled_node_classification.py:174``). The loss
    is the cross-entropy over the batch's train nodes."""

    def __init__(self, model, dataset=None, n_clusters: int = 20,
                 cluster_batch: int = 5, seed: int = 0):
        super().__init__(model, dataset)
        self.n_clusters = n_clusters
        self.cluster_batch = cluster_batch
        self.seed = seed
        self._loader = None

    def prepare_graph(self, graph: Graph) -> Graph:
        """``NodeClfWrapper.prepare_graph``, then the loader (the partition
        and the host copies of the graph) over the prepared graph."""
        graph = super().prepare_graph(graph)
        self._loader = ClusterLoader(graph, n_clusters=self.n_clusters,
                                     batch_size=self.cluster_batch,
                                     seed=self.seed)
        return graph

    def _epoch_factory(self):
        # each call draws a new grouping from the loader's generator
        return self._loader.epoch

    def loss(self, batch: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        logits = self.model(batch, batch.x, training=training,
                            generator=generator)
        return masked_cross_entropy(logits, batch.y,
                                    batch.train_mask & batch.node_mask())


class GraphSAINTWrapper(_SubgraphClfWrapper):
    """GraphSAINT: training on sampled subgraphs with the unbiased
    estimator (reference
    ``cogdl_tpu/wrappers/sampled_node_classification.py:209``).

    ``prepare_graph`` normalises the full graph symmetrically (after the
    model's own normalisation) and estimates, from ``est_samples`` draws of
    the training sampler, each node's inclusion count C_v and each edge's
    C_e: ``norm_loss[v] ∝ 1 / C_v`` (scaled so that its sum over the train
    nodes is their number) and ``norm_aggr[e] = C_dst(e) / C_e``, capped at
    ``est_samples``. A subgraph carries the full graph's normalised weights
    times ``norm_aggr``, its meta (``norm="sym"`` included, so the model
    does not normalise it again) and ``extras["norm_loss"]``. Samplers:
    ``node`` (``sample_size`` uniform nodes) and ``walk`` (``walk_roots``
    random walks of ``walk_length``). Each epoch draws
    ``batches_per_epoch`` subgraphs from ``default_rng(seed + 1000·epoch +
    1)``. The loss is the ``norm_loss``-weighted cross-entropy summed over
    the batch's train nodes, over their count."""

    def __init__(self, model, dataset=None, sampler: str = "walk",
                 sample_size: int = 1024, walk_roots: int = 128,
                 walk_length: int = 4, batches_per_epoch: int = 8,
                 est_samples: int = 40, seed: int = 0):
        super().__init__(model, dataset)
        self.sampler = sampler
        self.sample_size = sample_size
        self.walk_roots = walk_roots
        self.walk_length = walk_length
        self.batches_per_epoch = batches_per_epoch
        self.est_samples = est_samples
        self.seed = seed
        self._epoch = 0

    def _draw(self, rng) -> np.ndarray:
        if self.sampler == "walk":
            return saint_walk_subgraph(self._graph, self.walk_roots,
                                       self.walk_length, rng, csr=self._csr)
        return saint_node_subgraph(
            self._graph, min(self.sample_size, self._graph.num_nodes), rng)

    def prepare_graph(self, graph: Graph) -> Graph:
        """:meth:`normalise` and the symmetric normalisation of the full
        graph (subgraphs inherit its weights, rescaled by ``norm_aggr``);
        the host copies and the estimator; last, on the card, the full
        graph's kernel structure from its final weights."""
        graph = sym_norm(self.normalise(graph))
        self._graph = graph
        E, N = graph.num_edges, graph.num_nodes
        self._row = _np(graph.row[:E])
        self._col = _np(graph.col[:E])
        self._w = _np(graph.edge_weight[:E])
        self._x, self._y = _np(graph.x), _np(graph.y)
        self._train_mask = _np(graph.train_mask)
        self._meta = dict(graph.meta)
        self._csr = graph_csr(graph) if self.sampler == "walk" else None
        rng = np.random.default_rng(self.seed)
        cv = np.zeros(N, np.int64)
        ce = np.zeros(E, np.int64)
        for _ in range(self.est_samples):
            nodes = self._draw(rng)
            sel = np.zeros(N, bool)
            sel[nodes] = True
            cv[nodes] += 1
            ce += sel[self._row] & sel[self._col]
        nl = 1.0 / np.maximum(cv, 1)
        tr = self._train_mask[:N]
        denom = max(float(nl[tr].sum()), 1e-12)
        self._norm_loss = (nl * tr.sum() / denom).astype(np.float32)
        self._norm_aggr = (np.maximum(cv[self._row], 1)
                           / np.maximum(ce, 1)).astype(np.float32)
        self._norm_aggr = np.minimum(self._norm_aggr, self.est_samples)
        return self.with_structure(graph)

    def _subgraph(self, nodes: np.ndarray) -> Graph:
        """The subgraph induced by ``nodes`` on the CPU: edges relabelled,
        weights times ``norm_aggr``, the nodes' rows, the full graph's meta
        and ``extras["norm_loss"]``."""
        nodes = np.sort(nodes)
        N = self._graph.num_nodes
        sel = np.zeros(N, bool)
        sel[nodes] = True
        em = sel[self._row] & sel[self._col]
        relabel = np.full(N, -1, np.int64)
        relabel[nodes] = np.arange(len(nodes))
        r, c = relabel[self._row[em]], relabel[self._col[em]]
        w = self._w[em] * self._norm_aggr[em]
        g = from_coo(np.stack([r, c]), num_nodes=len(nodes), edge_weight=w,
                     x=self._x[nodes], y=self._y[nodes],
                     train_mask=self._train_mask[nodes], meta=self._meta)
        nlw = np.zeros(g.n_pad, np.float32)
        nlw[: len(nodes)] = self._norm_loss[nodes]
        return g.replace(extras={**(g.extras or {}),
                                 "norm_loss": torch.from_numpy(nlw)})

    def _epoch_factory(self):
        epoch = self._epoch
        self._epoch += 1

        def draws():
            rng = np.random.default_rng(self.seed + 1000 * epoch + 1)
            for _ in range(self.batches_per_epoch):
                yield self._subgraph(self._draw(rng))

        return draws

    def loss(self, batch: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        logits = self.model(batch, batch.x, training=training,
                            generator=generator)
        mask = (batch.train_mask & batch.node_mask()).float()
        ce = -F.log_softmax(logits, -1).gather(
            1, batch.y.long()[:, None])[:, 0]
        return ((ce * batch.extras["norm_loss"] * mask).sum()
                / mask.sum().clamp_min(1.0))
