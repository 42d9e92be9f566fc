"""Multi-stage self-training wrappers — the port of
``cogdl_tpu/wrappers/staged.py``: ``SAGNWrapper`` (later stages add
confident pseudo-labels), ``M3SWrapper`` (KMeans over the embeddings
expands the training set) and ``CorrectSmoothWrapper`` (an MLP with C&S
post-processing at evaluation), on the trainer's stage hooks.

The trainer calls ``pre_stage(stage, graph)`` with the best snapshot's
weights in the model, as the JAX trainer passes its best parameters; a
returned graph replaces the run's graph. ``graph.replace(y=...,
train_mask=...)`` keeps ``extras``, so the kernels' structure carries over
and no ``prepare_spmm`` runs between stages."""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.graph import Graph
from ..utils.evaluator import masked_accuracy
from ..utils.kmeans import kmeans
from .node_classification import NodeClfWrapper


class SAGNWrapper(NodeClfWrapper):
    """Stage 0 trains on the true labels; each later stage adds the
    predictions whose softmax maximum exceeds ``threshold`` on the nodes
    that are in no split (val and test keep their true labels)."""

    num_stages = 2

    def __init__(self, model, dataset=None, threshold: float = 0.9,
                 num_stages: int = 2):
        super().__init__(model, dataset)
        self.threshold = threshold
        self.num_stages = num_stages
        # each later stage's pseudo-labels (Trainer.run's "stages")
        self.stage_record: Dict[int, Dict[str, float]] = {}

    @torch.no_grad()
    def pre_stage(self, stage: int, graph: Graph) -> Optional[Graph]:
        if stage == 0:
            return None
        probs = torch.softmax(self.model(graph, graph.x, training=False), -1)
        conf, pred = probs.max(-1)
        unlabeled = ~graph.train_mask & graph.node_mask()
        for m in (graph.val_mask, graph.test_mask):
            if m is not None:
                unlabeled &= ~m
        take = unlabeled & (conf > self.threshold)
        self.stage_record[stage] = {"pseudo_labels": int(take.sum())}
        return graph.replace(y=torch.where(take, pred.to(graph.y.dtype),
                                           graph.y),
                             train_mask=graph.train_mask | take)


def expand_labels(emb: np.ndarray, labels: np.ndarray, centers: np.ndarray,
                  y: np.ndarray, train: np.ndarray, reserved: np.ndarray,
                  nmask: np.ndarray, num_classes: int,
                  num_new_labels: int):
    """M3S's label expansion, on the host: each of the ``2·C`` clusters
    (``labels`` over the real nodes, ``centers``) with a train node takes
    the majority train label of its members and gives it to its
    ``num_new_labels`` members closest to its centre among those neither
    train nor reserved (val, test). Returns ``(new_y, new_train)``,
    ``[n_pad]`` arrays; the JAX ``pre_stage``'s arithmetic."""
    clusters = np.full(y.shape[0], -1)
    clusters[nmask] = labels
    new_train = train.copy()
    new_y = y.copy()
    for c in range(num_classes * 2):
        members = np.nonzero((clusters == c) & nmask)[0]
        lab_members = members[train[members]]
        if lab_members.size == 0:
            continue
        maj = np.bincount(y[lab_members], minlength=num_classes).argmax()
        cand = members[~reserved[members]]
        if cand.size == 0:
            continue
        d = np.linalg.norm(emb[cand] - centers[c], axis=1)
        take = cand[np.argsort(d)[:num_new_labels]]
        new_train[take] = True
        new_y[take] = maj
    return new_y, new_train


class M3SWrapper(NodeClfWrapper):
    """M3S: at each stage after the first, KMeans (2·C clusters, 3 seeded
    runs, on the graph's device) over the model's embeddings of the real
    nodes, then :func:`expand_labels` on the host."""

    num_stages = 2

    def __init__(self, model, dataset=None, num_stages: int = 2,
                 num_new_labels: int = 20):
        super().__init__(model, dataset)
        self.num_stages = num_stages
        self.num_new_labels = num_new_labels
        # each later stage's labels added and KMeans seconds and
        # iterations (Trainer.run's "stages")
        self.stage_record: Dict[int, Dict[str, float]] = {}

    @torch.no_grad()
    def pre_stage(self, stage: int, graph: Graph) -> Optional[Graph]:
        if stage == 0 or not hasattr(self.model, "embed"):
            return None
        nmask_t = graph.node_mask()
        # C as the JAX wrapper takes it: the largest real label + 1
        num_classes = int(graph.y[nmask_t].max()) + 1
        emb_t = self.model.embed(graph, graph.x)
        t0 = time.perf_counter()
        km = kmeans(emb_t[nmask_t], num_classes * 2, n_init=3, seed=0)
        km_labels = km.labels.cpu().numpy()
        kmeans_s = time.perf_counter() - t0
        nmask = nmask_t.cpu().numpy()
        y = graph.y.cpu().numpy()
        train = graph.train_mask.cpu().numpy() & nmask
        reserved = train.copy()
        for m in (graph.val_mask, graph.test_mask):
            if m is not None:
                reserved |= m.cpu().numpy()
        new_y, new_train = expand_labels(
            emb_t.cpu().numpy(), km_labels, km.centers.cpu().numpy(), y,
            train, reserved, nmask, num_classes, self.num_new_labels)
        self.stage_record[stage] = {"new_labels": int((new_train & ~train).sum()),
                                "kmeans_s": kmeans_s,
                                "kmeans_iters": km.n_iter}
        device = graph.device
        return graph.replace(y=torch.from_numpy(new_y).to(device),
                             train_mask=torch.from_numpy(new_train).to(device))


class CorrectSmoothWrapper(NodeClfWrapper):
    """MLP training, then C&S post-processing (``postprocess``) of the
    logits at every evaluation."""

    @torch.no_grad()
    def evaluate(self, graph: Graph) -> Dict[str, torch.Tensor]:
        logits = self.model(graph, graph.x, training=False)
        smoothed = self.model.postprocess(graph, logits)
        node_m = graph.node_mask()
        out = {}
        for split, m in (("train", graph.train_mask), ("val", graph.val_mask),
                         ("test", graph.test_mask)):
            if m is not None:
                out[f"{split}_acc"] = masked_accuracy(smoothed, graph.y,
                                                      m & node_m)
        return out
