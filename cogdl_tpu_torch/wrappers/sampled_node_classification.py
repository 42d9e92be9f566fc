"""Sampled mini-batch node classification — the port of the device-sampled
wrapper of ``cogdl_tpu/wrappers/sampled_node_classification.py``
(``DeviceSampledNodeClfWrapper``).

Training samples each mini-batch on the device from the prepared graph's
CSR (``data/device_sampling.py``): a batch costs the host one ``[B]`` seed
row, and sampling, the frame's feature gather and the train step all run on
the device. Evaluation is full batch, inherited from ``NodeClfWrapper``, so
on the card it runs the kernels the full-batch model runs (K1 for
GraphSAGE ``sum``/``gcn``, K3 for GAT). The host-sampled wrappers
(``neighbor_sampling``, ``cluster``, ``graphsaint``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.device_sampling import (
    DeviceNeighborSampler,
    frame_features,
    sample_blocks_device,
)
from ..data.graph import Graph
from ..utils.evaluator import masked_cross_entropy
from .node_classification import NodeClfWrapper


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
