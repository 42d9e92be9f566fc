"""Full-batch node classification wrapper — the port of
``cogdl_tpu/wrappers/node_classification.py`` (``NodeClfWrapper``): masked
cross-entropy on the train nodes, accuracy (micro-F1 for multilabel ``y``)
on train/val/test, and ``GCNMixWrapper``, its manifold-mixup form."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.graph import Graph, add_self_loops, row_norm, sym_norm
from ..ops.cuda import prepare_spmm
from ..utils.evaluator import (
    bce_with_logits_loss,
    masked_accuracy,
    masked_cross_entropy,
)


def apply_adj_norm(model, graph: Graph) -> Graph:
    """``graph`` under ``model``'s adjacency normalisation (its ``adj_norm``,
    ``"sym"`` or ``"row"``), as the model's forward applies it; unchanged
    for a model without one and for a graph already tagged with it."""
    norm = getattr(model, "adj_norm", None)
    if norm == "sym":
        return sym_norm(graph)
    if norm == "row":
        return row_norm(graph)
    return graph


class NodeClfWrapper:
    eval_metric = "val_acc"
    eval_mode = "max"

    def __init__(self, model, dataset=None):
        self.model = model
        self.dataset = dataset

    # -- data ---------------------------------------------------------------
    def prepare_graph(self, graph: Graph) -> Graph:
        """:meth:`normalise`, then on the card the kernels' structure (K1 and
        K3), built from the final weights."""
        return self.with_structure(self.normalise(graph))

    @staticmethod
    def with_structure(graph: Graph) -> Graph:
        """On the card, ``graph`` with the kernels' structure from its
        current weights (``prepare_spmm``); elsewhere ``graph``."""
        if graph.device.type == "cuda":
            graph = prepare_spmm(graph)
        return graph

    def normalise(self, graph: Graph) -> Graph:
        """Add self loops and apply the model's adjacency normalisation
        once."""
        return apply_adj_norm(self.model, add_self_loops(graph))

    def train_batches(self, graph: Graph):
        return [graph]

    # -- steps --------------------------------------------------------------
    def init(self, generator: torch.Generator, graph: Graph):
        self.model.reset_parameters(generator)

    def multilabel(self, graph: Graph) -> bool:
        return graph.y is not None and graph.y.ndim == 2

    def loss(self, graph: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        logits = self.model(graph, graph.x, training=training,
                            generator=generator)
        mask = graph.train_mask & graph.node_mask()
        if self.multilabel(graph):
            return bce_with_logits_loss(logits, graph.y.float(), mask)
        return masked_cross_entropy(logits, graph.y, mask)

    @torch.no_grad()
    def evaluate(self, graph: Graph) -> Dict[str, torch.Tensor]:
        logits = self.model(graph, graph.x, training=False)
        node_m = graph.node_mask()
        out = {}
        for split, m in (("train", graph.train_mask), ("val", graph.val_mask),
                         ("test", graph.test_mask)):
            if m is None:
                continue
            mask = m & node_m
            if self.multilabel(graph):
                pred = (logits > 0).float()
                tgt = graph.y.float()
                mm = mask.float().unsqueeze(-1)
                tp = (pred * tgt * mm).sum()
                fp = (pred * (1 - tgt) * mm).sum()
                fn = ((1 - pred) * tgt * mm).sum()
                out[f"{split}_acc"] = 2 * tp / (2 * tp + fp + fn).clamp_min(1.0)
            else:
                out[f"{split}_acc"] = masked_accuracy(logits, graph.y, mask)
        return out


class GCNMixWrapper(NodeClfWrapper):
    """Manifold mixup with the matching label mix — the port of
    ``GCNMixWrapper``: ``lam·CE(logits, y) + (1 − lam)·CE(logits,
    y[perm])`` over the train nodes, the logits from the model's
    ``mixup_forward`` at ``(perm, lam)`` drawn by its ``draw_mixup``:
    ``lam`` from a host ``numpy.random.Generator`` seeded with the run's
    ``seed``, ``perm`` from the step's generator on the graph's device. No
    draw touches torch's or numpy's global generator, and none waits for
    the card."""

    def __init__(self, model, dataset=None, seed: int = 0):
        super().__init__(model, dataset)
        self.rng = np.random.default_rng(seed)

    def loss(self, graph: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        perm, lam = self.model.draw_mixup(graph, self.rng, generator)
        logits = self.model.mixup_forward(graph, graph.x, perm, lam,
                                          training=True, generator=generator)
        mask = graph.train_mask & graph.node_mask()
        return (lam * masked_cross_entropy(logits, graph.y, mask)
                + (1.0 - lam) * masked_cross_entropy(logits, graph.y[perm],
                                                     mask))
