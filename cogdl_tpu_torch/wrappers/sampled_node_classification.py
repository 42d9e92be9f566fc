"""Sampled mini-batch node classification — the port of the neighbor
sampling wrappers of ``cogdl_tpu/wrappers/sampled_node_classification.py``
(``SampledNodeClfWrapper``, ``DeviceSampledNodeClfWrapper``).

``SampledNodeClfWrapper`` (``neighbor_sampling``) samples each mini-batch
on the host (``data/sampling.py``: the port's C++ sampler, or the JAX
package's numpy branch when asked for) in a prefetch worker, which also
builds the kernels' structure of each block when the model reads it and
copies the batch to the card. ``DeviceSampledNodeClfWrapper``
(``neighbor_sampling_device``) samples on the device from the prepared
graph's CSR (``data/device_sampling.py``): a batch costs the host one
``[B]`` seed row. Evaluation is full batch in both, inherited from
``NodeClfWrapper``, so on the card it runs the kernels the full-batch model
runs (K1 for GraphSAGE ``sum``/``gcn``, K3 for GAT). The cluster and
GraphSAINT wrappers (``cluster``, ``graphsaint``) are not ported yet.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import torch

from ..data.device_sampling import (
    DeviceNeighborSampler,
    frame_features,
    sample_blocks_device,
)
from ..data.graph import Graph
from ..data.sampling import NeighborSampler, Prefetcher
from ..layers import GATLayer, SAGELayer
from ..ops.cuda import prepare_spmm
from ..utils.evaluator import masked_cross_entropy
from .node_classification import NodeClfWrapper


def reads_kernel_structure(model) -> bool:
    """Whether a layer of ``model`` runs K1 or K3 over a block, and so needs
    the structure ``prepare_spmm`` builds: GAT, and GraphSAGE summing its
    neighbours (``sum``, ``gcn``). ``mean`` and ``max`` are torch index
    ops."""
    return any(isinstance(m, GATLayer)
               or (isinstance(m, SAGELayer) and m.aggr in ("sum", "gcn"))
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
        structure = reads_kernel_structure(self.model)
        it = self._sampler.epoch()
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            t1 = time.perf_counter()
            blocks, structure_ms = batch[0], None
            if structure:
                blocks = [prepare_spmm(b) for b in blocks]
                structure_ms = (time.perf_counter() - t1) * 1e3
            self.host_ms.append(((t1 - t0) * 1e3, structure_ms))
            yield tuple(blocks)

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
