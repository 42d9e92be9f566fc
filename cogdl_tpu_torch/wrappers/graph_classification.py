"""Graph classification wrapper — the port of ``GraphClfWrapper`` in
``cogdl_tpu/wrappers/graph_classification.py``: union-batched training
over many small graphs with a per-graph cross-entropy, and a train / val /
test split over graphs (seeded, or the dataset's official ``split_idx``).

The batches are built once, in ``__init__``, as the JAX package builds
them: the train list shuffled once at ``seed`` and trained in that order
every epoch. The wrapper holds them itself; the trainer, which has no
single graph to move, hands it the device (:meth:`to_device`). There each
batch gets the kernels' structure on the host (``prepare_spmm``, once: the
list never changes) when the model reads it, and is copied to the device.
``PatchySANWrapper`` (PATCHY-SAN's receptive fields) holds its tensors the
same way. ``InfoGraphWrapper`` trains InfoGraph on the same batches
without labels and probes its graph embeddings with an SVC
(``utils/svm.py``, no scikit-learn).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.batch import make_batches
from ..data.graph import Graph
from ..ops.cuda import prepare_spmm
from ..utils.evaluator import masked_cross_entropy
from ..utils.svm import cross_val_accuracy
from .sampled_node_classification import reads_kernel_structure

SPLITS = ("train", "val", "test")


class GraphClfWrapper:
    eval_metric = "val_acc"
    eval_mode = "max"
    # evaluation loops over the batches of each split
    jit_eval = False

    def __init__(self, model, dataset=None, batch_size: int = 32,
                 train_ratio: float = 0.7, val_ratio: float = 0.1,
                 seed: int = 0):
        self.model = model
        self.dataset = dataset
        graphs, labels = dataset.graphs, np.asarray(dataset.labels)
        official = getattr(dataset, "split_idx", None)
        if official:
            self._splits = {
                "train": np.asarray(official["train"]),
                "val": np.asarray(official.get("valid",
                                               official.get("val", []))),
                "test": np.asarray(official.get("test", [])),
            }
        else:
            idx = np.random.default_rng(seed).permutation(len(graphs))
            n_tr = int(train_ratio * len(graphs))
            n_va = int(val_ratio * len(graphs))
            self._splits = {"train": idx[:n_tr],
                            "val": idx[n_tr: n_tr + n_va],
                            "test": idx[n_tr + n_va:]}
        self._batches: Dict[str, List[Graph]] = {
            split: make_batches([graphs[i] for i in ids], labels[ids],
                                batch_size, shuffle=(split == "train"),
                                seed=seed)
            for split, ids in self._splits.items()}

    def to_device(self, device) -> None:
        """Move every batch to ``device``, each with the kernels' structure
        built on the host first when the model reads it."""
        device = torch.device(device)
        structure = reads_kernel_structure(self.model)
        self._batches = {
            split: [(prepare_spmm(b.to("cpu")) if structure else b).to(device)
                    for b in batches]
            for split, batches in self._batches.items()}

    def train_batches(self, graph=None) -> List[Graph]:
        return self._batches["train"]

    def init(self, generator: torch.Generator, graph=None):
        self.model.reset_parameters(generator)

    def loss(self, batch: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        logits = self.model(batch, batch.x, training=training,
                            generator=generator)
        return masked_cross_entropy(logits, batch.extras["graph_y"],
                                    batch.extras["graph_mask"])

    @torch.no_grad()
    def evaluate(self, graph=None) -> Dict[str, torch.Tensor]:
        """Accuracy over every batch of each split, summed on the device:
        the host waits once a split, when the caller reads it."""
        out = {}
        for split in SPLITS:
            correct = total = 0.0
            for b in self._batches[split]:
                pred = self.model(b, b.x, training=False).argmax(-1)
                m = b.extras["graph_mask"].float()
                correct = correct + ((pred == b.extras["graph_y"].long())
                                     .float() * m).sum()
                total = total + m.sum()
            out[f"{split}_acc"] = correct / total.clamp_min(1.0)
        return out


class InfoGraphWrapper(GraphClfWrapper):
    """InfoGraph (the port of ``InfoGraphWrapper``): the Jensen-Shannon
    mutual-information objective between node and graph summaries over each
    union batch, ``E_neg[softplus(T)] − E_pos[−softplus(−T)]`` over the
    ``[N, G]`` grid masked to real nodes and graphs; evaluated by
    ``cross_val_score(SVC(), X, y, cv=3)``'s mean accuracy
    (``utils/svm.cross_val_accuracy``) over the standardised embeddings of
    every graph of the three splits. The embeddings come from the device;
    the SVC runs on the host in float64 (``probe_ms`` its own time)."""

    def loss(self, batch: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        scores = self.model.mi_scores(batch, batch.x, training)   # [N, G]
        graph_id = batch.extras["graph_id"].long()
        G = scores.shape[1]
        pos = (graph_id[:, None] == torch.arange(
            G, device=scores.device)[None, :]).to(scores.dtype)
        valid = (batch.node_mask()[:, None]
                 & batch.extras["graph_mask"][None, :]).to(scores.dtype)
        pos_term = (-F.softplus(-scores) * pos * valid).sum() / (
            pos * valid).sum().clamp_min(1.0)
        neg = (1 - pos) * valid
        neg_term = (F.softplus(scores) * neg).sum() / neg.sum().clamp_min(1.0)
        return neg_term - pos_term

    @torch.no_grad()
    def embeddings(self):
        """Every real graph's embedding (float64, on the host) and label,
        over the batches of the three splits in order."""
        embs, labels = [], []
        for split in SPLITS:
            for b in self._batches[split]:
                m = b.extras["graph_mask"]
                embs.append(self.model(b, b.x, training=False)[m])
                labels.append(b.extras["graph_y"][m])
        return (torch.cat(embs).double().cpu().numpy(),
                torch.cat(labels).cpu().numpy())

    @staticmethod
    def standardize(X: np.ndarray) -> np.ndarray:
        return (X - X.mean(0)) / np.maximum(X.std(0), 1e-8)

    def evaluate(self, graph=None) -> Dict[str, float]:
        X, y = self.embeddings()
        t0 = time.perf_counter()
        acc = float(np.mean(cross_val_accuracy(self.standardize(X), y,
                                               cv=3)))
        return {"val_acc": acc, "test_acc": acc,
                "probe_ms": (time.perf_counter() - t0) * 1e3}


class PatchySANWrapper:
    """PATCHY-SAN — the port of ``PatchySANWrapper``: every graph's
    receptive fields assembled on the host once (``assemble_fields``) into
    ``[G, w, k, F]`` features, split over graphs as the JAX wrapper splits
    them (a ``default_rng(seed)`` permutation, ``train_ratio`` /
    ``val_ratio``), the whole train split one batch, the mean NLL, and the
    accuracy of each split. It holds its tensors itself and moves them in
    :meth:`to_device`, as ``GraphClfWrapper`` does."""

    eval_metric = "val_acc"
    eval_mode = "max"

    def __init__(self, model, dataset=None, train_ratio: float = 0.7,
                 val_ratio: float = 0.1, seed: int = 0):
        from ..models.nn.patchy_san import assemble_fields

        self.model = model
        graphs, labels = dataset.graphs, np.asarray(dataset.labels)
        fields = assemble_fields(graphs, width=model.width, k=model.k)
        feats = np.zeros(fields.shape + (graphs[0].num_features,), np.float32)
        for i, g in enumerate(graphs):
            feats[i] = g.x.cpu().numpy()[fields[i]]
        idx = np.random.default_rng(seed).permutation(len(graphs))
        n_tr = int(train_ratio * len(graphs))
        n_va = int(val_ratio * len(graphs))
        self._data = {
            split: (torch.from_numpy(feats[sl]), torch.from_numpy(labels[sl]))
            for split, sl in (("train", idx[:n_tr]),
                              ("val", idx[n_tr: n_tr + n_va]),
                              ("test", idx[n_tr + n_va:]))}

    def to_device(self, device) -> None:
        self._data = {split: (X.to(device), y.to(device))
                      for split, (X, y) in self._data.items()}

    def train_batches(self, graph=None):
        return [self._data["train"]]

    def init(self, generator: torch.Generator, graph=None):
        self.model.reset_parameters(generator)

    def loss(self, batch, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        X, y = batch
        logp = torch.log_softmax(
            self.model(X, training=training, generator=generator), -1)
        return -logp.gather(1, y.long().unsqueeze(1)).mean()

    @torch.no_grad()
    def evaluate(self, graph=None) -> Dict[str, torch.Tensor]:
        out = {}
        for split in SPLITS:
            X, y = self._data[split]
            if X.shape[0] == 0:
                continue
            pred = self.model(X, training=False).argmax(-1)
            out[f"{split}_acc"] = (pred == y.long()).float().mean()
        return out
