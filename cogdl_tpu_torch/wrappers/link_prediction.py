"""GNN link prediction — the port of
``cogdl_tpu/wrappers/link_prediction.py`` (``LinkPredictionWrapper``):
hold out a share of the undirected edges, train any full-batch encoder with
dot-product edge scores against random negative pairs (BCE), evaluate
ROC-AUC on the held-out pairs.

The split runs on the host in numpy with the JAX wrapper's generator
(``numpy.random.default_rng(seed)``), so the training edges, the negatives
and both evaluation pair sets equal the JAX wrapper's for the same seed.
The training graph gets its self loops and the model's normalisation, and
on the card the kernels' structure built on it (``NodeClfWrapper``'s
``normalise`` and ``with_structure``).

The step's random negatives come from ``draws(graph, generator)`` and the
loss is ``loss_at(graph, draws, training, generator)``: a caller holds the
two packages to each other by handing ``loss_at`` the JAX wrapper's draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.graph import Graph, from_coo
from ..models.nn.gae import GAE
from ..utils.evaluator import bce_logits, roc_auc_score
from .node_classification import NodeClfWrapper


def _pairs(a) -> np.ndarray:
    """Official pairs as ``[n, 2]``, from ``[n, 2]`` or ``[2, n]``."""
    a = np.asarray(a)
    return a.reshape(-1, 2) if a.shape[0] != 2 else a.T


def draw_negative_pairs(graph: Graph,
                        generator: Optional[torch.Generator]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``e_pad`` random ``(row, col)`` node pairs over the real nodes, on
    the graph's device (the JAX wrappers' ``randint`` negatives)."""
    n, e = graph.num_nodes, graph.e_pad
    return tuple(torch.randint(0, n, (e,), generator=generator,
                               device=graph.device) for _ in range(2))


def edge_bce(pos: torch.Tensor, neg: torch.Tensor,
             graph: Graph) -> torch.Tensor:
    """The BCE of positive logits (target 1) and negative ones (target 0),
    each over the graph's real edge slots, averaged over both."""
    m = graph.edge_mask().to(pos.dtype)
    return ((bce_logits(pos, 1.0) * m).sum()
            + (bce_logits(neg, 0.0) * m).sum()) / (
        2.0 * m.sum()).clamp_min(1.0)


class LinkPredictionWrapper(NodeClfWrapper):
    eval_metric = "val_auc"
    eval_mode = "max"

    def __init__(self, model, dataset=None, test_ratio: float = 0.1,
                 val_ratio: float = 0.05, seed: int = 0):
        super().__init__(model, dataset)
        self.test_ratio = test_ratio
        self.val_ratio = val_ratio
        self.seed = seed

    # -- data ---------------------------------------------------------------
    def split(self, graph: Graph) -> Graph:
        """The edge split on the host: the training graph (both directions
        of the training pairs, on the host), with ``eval_edges``, ``{"val":
        (pos, neg), "test": (pos, neg)}`` as ``[n, 2]`` int64 arrays. With
        the dataset's ``link_split`` (official pairs) the graph holds the
        training edges already and comes back as it is."""
        rng = np.random.default_rng(self.seed)
        official = getattr(self.dataset, "link_split", None)
        if official:
            self.eval_edges = {}
            for split in ("val", "test"):
                pos, neg = official.get(
                    "valid" if split == "val" else split, (None, None))
                if pos is None:
                    continue
                pos = _pairs(pos)
                neg = (rng.integers(0, graph.num_nodes, size=(len(pos), 2))
                       if neg is None else _pairs(neg))
                self.eval_edges[split] = (pos, neg)
            return graph
        N, E = graph.num_nodes, graph.num_edges
        row = graph.row[:E].cpu().numpy().astype(np.int64)
        col = graph.col[:E].cpu().numpy().astype(np.int64)
        # the undirected pairs (min, max) in lexicographic order, as
        # np.unique(..., axis=0) gives them
        keys = np.unique(np.minimum(row, col) * N + np.maximum(row, col))
        pairs = np.stack([keys // N, keys % N], 1)
        perm = rng.permutation(pairs.shape[0])
        n_te = int(self.test_ratio * pairs.shape[0])
        n_va = int(self.val_ratio * pairs.shape[0])
        te = pairs[perm[:n_te]]
        va = pairs[perm[n_te: n_te + n_va]]
        tr = pairs[perm[n_te + n_va:]]

        def negatives(n):
            # the JAX wrapper's filter, in one pass: drop graph pairs in
            # either direction and self pairs, keep the first n
            cand = rng.integers(0, N, size=(int(1.2 * n) + 8, 2))
            ck = cand.min(1) * N + cand.max(1)
            ok = ~np.isin(ck, keys) & (cand[:, 0] != cand[:, 1])
            return cand[ok][:n].astype(np.int64)

        self.eval_edges = {"val": (va, negatives(len(va))),
                           "test": (te, negatives(len(te)))}
        self.train_pairs = tr

        def host(a):
            return None if a is None else a[:N].cpu()

        return from_coo(np.stack([np.concatenate([tr[:, 0], tr[:, 1]]),
                                  np.concatenate([tr[:, 1], tr[:, 0]])]),
                        num_nodes=N, x=host(graph.x), y=host(graph.y),
                        meta=dict(graph.meta))

    def prepare_graph(self, graph: Graph) -> Graph:
        """:meth:`split`, then the self loops and the model's normalisation
        on the training graph, on ``graph``'s device, with the kernels'
        structure there on the card."""
        device = graph.device
        train = self.split(graph)
        return self.with_structure(self.normalise(train.to(device)))

    # -- steps --------------------------------------------------------------
    def draws(self, graph: Graph, generator: Optional[torch.Generator]):
        return draw_negative_pairs(graph, generator)

    def loss(self, graph: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        return self.loss_at(graph, self.draws(graph, generator), training,
                            generator)

    def loss_at(self, graph: Graph, draws, training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """BCE of the training edges' scores (every edge slot of the
        prepared graph, self loops included, pad slots masked) against the
        ``draws`` negatives, the embeddings from the model's forward (its
        dropout from ``generator``)."""
        nr, nc = draws
        z = self.model(graph, graph.x, training=training, generator=generator)
        return edge_bce(GAE.decode_edges(z, graph.row, graph.col),
                        GAE.decode_edges(z, nr, nc), graph)

    @torch.no_grad()
    def evaluate(self, graph: Graph) -> Dict[str, float]:
        z = self.model(graph, graph.x, training=False).float().cpu().numpy()
        out = {}
        for split, (pos, neg) in self.eval_edges.items():
            if len(pos) == 0 or len(neg) == 0:
                continue
            sp = (z[pos[:, 0]] * z[pos[:, 1]]).sum(-1)
            sn = (z[neg[:, 0]] * z[neg[:, 1]]).sum(-1)
            ytrue = np.r_[np.ones(len(sp)), np.zeros(len(sn))]
            out[f"{split}_auc"] = roc_auc_score(ytrue, np.r_[sp, sn])
        return out

