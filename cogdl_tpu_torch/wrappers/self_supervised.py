"""Self-supervised node wrappers — the port of
``cogdl_tpu/wrappers/self_supervised.py``: DGI (and MVGRL), GRACE,
GraphMAE, GraphMAE2, BGRL, unsupervised GraphSAGE and the self-auxiliary
wrapper. Each trains its encoder on its own objective and evaluates frozen
embeddings with the logistic-regression probe (``utils/probe.py``, no
scikit-learn); the self-auxiliary wrapper adds an auxiliary task to
supervised training.

Each wrapper takes its random draws from the run's ``torch.Generator`` in
one method, ``draws(graph, generator)``, and its loss is
``loss_at(graph, draws, training)``: the DGI permutation, GRACE's and
BGRL's edge and feature keep masks, GraphMAE's node mask and GraphMAE2's
remasks, each on the graph's device. JAX's and torch's random streams
differ; a caller holds the two packages to each other by handing
``loss_at`` the JAX package's draws.

The EMA teachers (GraphMAE2, BGRL) live in the model as buffers
(``layers.utils.frozen_copy``), so the trainer's snapshots carry them and
no optimizer sees them. ``loss_at`` moves them toward the student's
weights as they are before ``optimizer.step()``, as the JAX package does
inside its loss.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..data.graph import Graph, from_coo, sym_norm
from ..data.sampling import graph_csr
from ..layers.utils import dropout_keep as _keep
from ..layers.utils import ema_
from ..models.nn.graphmae import sce_loss
from ..utils.probe import logreg_probe
from ..utils.transforms import drop_edge, drop_feature
from .node_classification import NodeClfWrapper


def _bce(logit: torch.Tensor, target: float) -> torch.Tensor:
    return (logit.clamp_min(0) - logit * target
            + torch.log1p(torch.exp(-logit.abs())))


class DGIWrapper(NodeClfWrapper):
    """DGI's (and MVGRL's) infomax objective: the discriminator tells the
    graph's embeddings from those of its features with the **real** rows
    permuted (pad rows keep their place), BCE over the real nodes. The
    graph gets self loops and the model's normalisation, as
    ``NodeClfWrapper`` prepares it."""

    def draws(self, graph: Graph, generator: Optional[torch.Generator]):
        n = graph.num_nodes
        return torch.cat([
            torch.randperm(n, generator=generator, device=graph.device),
            torch.arange(n, graph.n_pad, device=graph.device)])

    def loss(self, graph: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        return self.loss_at(graph, self.draws(graph, generator), training)

    def loss_at(self, graph: Graph, perm: torch.Tensor,
                training: bool = True) -> torch.Tensor:
        pos, neg = self.model.infomax_logits(graph, graph.x, graph.x[perm],
                                             training)
        m = graph.node_mask().to(pos.dtype)
        return ((_bce(pos, 1.0) + _bce(neg, 0.0)) * m).sum() / (
            2 * m.sum()).clamp_min(1.0)

    @torch.no_grad()
    def evaluate(self, graph: Graph) -> Dict[str, float]:
        return logreg_probe(self.model.embed(graph), graph)


class GRACEWrapper(DGIWrapper):
    """GRACE: two views a step, each dropping edges and feature columns at
    the model's rates; the symmetric NT-Xent of their projections."""

    def draws(self, graph: Graph, generator: Optional[torch.Generator]):
        m, F_in = self.model, graph.x.shape[1]
        return tuple(
            (_keep(graph.e_pad, m.drop_edge_rates[i], graph.device,
                   generator),
             _keep((1, F_in), m.drop_feature_rates[i], graph.device,
                   generator))
            for i in range(2))

    def loss_at(self, graph: Graph, views, training: bool = True
                ) -> torch.Tensor:
        m = self.model
        h1, h2 = (m.project(m.view(graph, graph.x, e, f, training))
                  for e, f in views)
        mask = graph.node_mask()
        return 0.5 * (m.nt_xent(h1, h2, mask) + m.nt_xent(h2, h1, mask))


class GraphMAEWrapper(DGIWrapper):
    """GraphMAE: masked-feature reconstruction; the mask a Bernoulli draw
    of ``mask_rate`` over the real nodes."""

    def _node_mask(self, graph: Graph, rate: float, generator):
        return (_keep((graph.n_pad, 1), 1.0 - rate, graph.device, generator)
                & graph.node_mask()[:, None])

    def draws(self, graph: Graph, generator: Optional[torch.Generator]):
        return self._node_mask(graph, self.model.mask_rate, generator)

    def loss_at(self, graph: Graph, mask: torch.Tensor,
                training: bool = True) -> torch.Tensor:
        return self.model.reconstruction_loss(graph, graph.x, mask, training)


class GraphMAE2Wrapper(GraphMAEWrapper):
    """GraphMAE2: the masked inputs encoded once; the remasked decodes'
    scaled cosine error plus ``lam`` times the latent loss on the kept real
    nodes against the teacher; then the teacher moves toward the student's
    pre-step encoder and projector at ``ema_decay``."""

    def __init__(self, model, dataset=None, ema_decay: float = 0.996):
        super().__init__(model, dataset)
        self.ema_decay = float(ema_decay)

    def draws(self, graph: Graph, generator: Optional[torch.Generator]):
        m = self.model
        mask = self._node_mask(graph, m.mask_rate, generator)
        # the remasks cover pad rows too, as the JAX draws do
        remasks = [_keep((graph.n_pad, 1), 1.0 - m.remask_rate, graph.device,
                         generator) for _ in range(m.num_remasking)]
        return mask, remasks

    def loss_at(self, graph: Graph, draws, training: bool = True
                ) -> torch.Tensor:
        mask, remasks = draws
        m = self.model
        enc_rep = m.encode(graph, m.mask_inputs(graph.x, mask), training)
        latent_pred = m.student_latent(enc_rep)
        latent_tgt = m.teacher_latent(graph, graph.x)
        keep = (graph.node_mask()[:, None] & ~mask)[:, 0].to(
            latent_pred.dtype)
        lat = (sce_loss(latent_pred, latent_tgt, 1.0) * keep).sum() / (
            keep.sum().clamp_min(1.0))
        rec = m.remask_decode(graph, enc_rep, mask, remasks, training)
        ema_(m.teacher.enc, m.enc, self.ema_decay)
        ema_(m.teacher.proj, m.proj, self.ema_decay)
        return rec + m.lam * lat


class BGRLWrapper(DGIWrapper):
    """BGRL: two views (DropEdge at ``drop_edge_rates``, feature masking at
    ``drop_feature_rates``); the student (encoder and predictor, its batch
    statistics updated by view 1, then view 2) predicts the teacher's
    embedding of the other view; the loss is ``2 − 2·cos`` over the real
    nodes. Then the teacher's weights move toward the student's pre-step
    encoder and its statistics toward the student's after view 2, at the
    cosine-annealed decay ``1 − (1 − ema_decay)·(cos(π·t/T) + 1)/2``, ``t``
    the model's ``ema_step``, ``T`` ``ema_total_steps``."""

    def __init__(self, model, dataset=None, drop_edge_rates=(0.2, 0.3),
                 drop_feature_rates=(0.2, 0.3), ema_decay: float = 0.99,
                 ema_total_steps: int = 1000):
        super().__init__(model, dataset)
        self.drop_edge_rates = tuple(drop_edge_rates)
        self.drop_feature_rates = tuple(drop_feature_rates)
        self.ema_decay = float(ema_decay)
        self.ema_total_steps = int(ema_total_steps)

    def draws(self, graph: Graph, generator: Optional[torch.Generator]):
        F_in = graph.x.shape[1]
        return tuple(
            (_keep(graph.e_pad, self.drop_edge_rates[i], graph.device,
                   generator),
             _keep((1, F_in), self.drop_feature_rates[i], graph.device,
                   generator))
            for i in range(2))

    def views(self, graph: Graph, draws):
        """The two ``(normalised graph, features)`` views of ``draws``."""
        return [(sym_norm(drop_edge(graph, self.drop_edge_rates[i],
                                    keep=e)),
                 drop_feature(graph.x, self.drop_feature_rates[i], keep=f))
                for i, (e, f) in enumerate(draws)]

    def loss_at(self, graph: Graph, draws, training: bool = True
                ) -> torch.Tensor:
        m = self.model
        (g1, x1), (g2, x2) = self.views(graph, draws)
        # the online branch always runs in training mode, as in the JAX
        # wrapper
        p1 = m.student(g1, x1, True)
        p2 = m.student(g2, x2, True)
        t1 = m.teacher_embed(g1, x1)
        t2 = m.teacher_embed(g2, x2)

        def cos_loss(p, t):
            pn = p * torch.rsqrt((p * p).sum(-1, keepdim=True).clamp_min(
                1e-12))
            tn = t * torch.rsqrt((t * t).sum(-1, keepdim=True).clamp_min(
                1e-12))
            return 2.0 - 2.0 * (pn * tn).sum(-1)

        mask = graph.node_mask().to(p1.dtype)
        loss = ((cos_loss(p1, t2) + cos_loss(p2, t1)) * mask).sum() / (
            2.0 * mask.sum().clamp_min(1.0))
        with torch.no_grad():
            frac = (m.ema_step / max(self.ema_total_steps, 1)).clamp(max=1.0)
            beta = 1.0 - (1.0 - self.ema_decay) * (
                torch.cos(math.pi * frac) + 1.0) / 2.0
            ema_(m.teacher, m.enc, beta)
            m.ema_step.add_(1.0)
        return loss


class UnsupGraphSAGEWrapper(DGIWrapper):
    """Unsupervised GraphSAGE: random-walk co-occurrence positives and
    uniform negatives with the sigmoid loss. Every epoch the host draws
    ``pairs_per_epoch`` walk starts, the walks (the port's C++ library,
    ``native.random_walk``, on ``num_threads`` threads, seeded by one more
    draw) and ``num_negatives`` negatives a start, all from one
    ``numpy.random.default_rng(0)``, as the JAX wrapper draws them with the
    native library built; the batch reaches the device once."""

    walk_length = 3
    num_negatives = 8
    pairs_per_epoch = 2048
    refresh_per_epoch = True

    def __init__(self, model, dataset=None,
                 num_threads: Optional[int] = None):
        super().__init__(model, dataset)
        self.num_threads = num_threads

    def prepare_graph(self, graph: Graph) -> Graph:
        graph = super().prepare_graph(graph)
        self._csr = graph_csr(graph)
        self._rng_np = np.random.default_rng(0)
        return graph

    def train_batches(self, graph: Graph):
        indptr, indices, _ = self._csr
        rng = self._rng_np
        starts = rng.integers(0, graph.num_nodes, self.pairs_per_epoch)
        threads = (native.max_threads() if self.num_threads is None
                   else self.num_threads)
        walks = native.random_walk(indptr, indices, starts, self.walk_length,
                                   seed=int(rng.integers(0, 2 ** 62)),
                                   num_threads=threads)
        neg = rng.integers(0, graph.num_nodes,
                           (starts.shape[0], self.num_negatives))
        dev = graph.device
        return [(graph, torch.from_numpy(starts).to(dev),
                 torch.from_numpy(walks[:, -1]).to(dev),
                 torch.from_numpy(neg).to(dev))]

    def loss(self, batch, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        graph, u, v, neg = batch
        z = self.model(graph, graph.x, training=training, generator=generator)
        zu = z[u]
        pos = (zu * z[v]).sum(-1)
        negs = torch.einsum("bd,bkd->bk", zu, z[neg])
        return -F.logsigmoid(pos).mean() - F.logsigmoid(-negs).mean()


class AuxHead(torch.nn.Module):
    """The auxiliary task's linear head, ``w`` ``[hidden, out]`` and ``b``
    as the JAX wrapper keeps them (``params["aux"]``)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = torch.nn.Parameter(w)
        self.b = torch.nn.Parameter(b)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.w + self.b


class SelfAuxiliaryWrapper(NodeClfWrapper):
    """Supervised training plus a self-supervised auxiliary loss — the port
    of ``SelfAuxiliaryWrapper``. ``auxiliary_task``:

    * ``edgemask``: ``mask_ratio`` of the undirected edges held out (both
      directions) and as many non-edges drawn; the head classifies
      ``|h_u − h_v|``; the supervised loss trains on the graph without the
      held-out edges (``_train_graph``, its own K1 structure);
    * ``attributemask``: ``mask_ratio`` of the nodes outside the train
      split get zero features in ``_train_graph``; the head regresses their
      original features;
    * ``pairwise-distance``: node pairs at BFS distance 1, 2 and 3 or more,
      classified from ``|h_u − h_v|``.

    The task is built once on the host from ``default_rng(seed)`` in the
    JAX wrapper's draw order; evaluation runs on the full graph. The head
    (:class:`AuxHead`) is the model's ``aux`` submodule, attached by
    :meth:`init`, so the optimizer and the snapshots take it with the
    encoder.
    """

    def __init__(self, model, dataset=None, auxiliary_task: str = "edgemask",
                 mask_ratio: float = 0.1, aux_weight: float = 1.0,
                 num_pairs: int = 4000, seed: int = 0):
        super().__init__(model, dataset)
        self.auxiliary_task = auxiliary_task
        self.mask_ratio = mask_ratio
        self.aux_weight = aux_weight
        self.num_pairs = num_pairs
        self.seed = seed

    # -- the task (host, once) ------------------------------------------------
    def prepare_graph(self, graph: Graph) -> Graph:
        full = super().prepare_graph(graph)
        rng = np.random.default_rng(self.seed)
        E, N = graph.num_edges, graph.num_nodes
        row = graph.row[:E].cpu().numpy().astype(np.int64)
        col = graph.col[:E].cpu().numpy().astype(np.int64)
        dev = graph.device
        task = self.auxiliary_task
        if task == "edgemask":
            # canonical undirected pairs as keys lo·N + hi: their sorted
            # order is the JAX wrapper's np.unique(axis=0) row order
            key = np.minimum(row, col) * N + np.maximum(row, col)
            canon = np.unique(key)
            canon = canon[canon // N != canon % N]
            k = max(1, int(self.mask_ratio * canon.shape[0]))
            held_keys = canon[rng.permutation(canon.shape[0])[:k]]
            masked = np.stack([held_keys // N, held_keys % N], 1)
            keep = ~np.isin(key, held_keys)
            # the JAX wrapper draws one pair a try until k pairs are neither
            # loops nor held out; numpy gives the same pairs drawn as a
            # batch of tries from the same stream, and nothing draws after
            neg = np.empty((0, 2), np.int64)
            while neg.shape[0] < k:
                tries = rng.integers(0, N, (k - neg.shape[0] + 64, 2))
                u, v = tries[:, 0], tries[:, 1]
                ok = (u != v) & ~np.isin(np.minimum(u, v) * N
                                         + np.maximum(u, v), held_keys)
                neg = np.concatenate([neg, tries[ok]])
            self._pairs = torch.from_numpy(np.concatenate(
                [masked, neg[:k]])).to(dev)
            self._pair_labels = torch.from_numpy(np.concatenate(
                [np.ones(k, np.int64), np.zeros(k, np.int64)])).to(dev)
            self._train_graph = super().prepare_graph(
                self._rebuild(graph, row[keep], col[keep]))
        elif task == "attributemask":
            train_mask = graph.train_mask[:N].cpu().numpy()
            unlabeled = np.nonzero(~train_mask)[0]
            k = min(max(1, int(self.mask_ratio * N)), unlabeled.size)
            masked = rng.permutation(unlabeled)[:k]
            x = full.x.cpu().numpy().copy()
            self._masked_nodes = torch.from_numpy(masked).to(dev)
            self._feat_targets = torch.from_numpy(x[masked]).to(dev)
            x[masked] = 0.0
            self._train_graph = full.replace(x=torch.from_numpy(x).to(dev))
        elif task == "pairwise-distance":
            self._pairs, self._pair_labels = self._distance_pairs(full, rng)
            self._pairs = self._pairs.to(dev)
            self._pair_labels = self._pair_labels.to(dev)
            self._num_dist_classes = 3
            self._train_graph = full
        else:
            raise ValueError(
                f"unknown auxiliary_task {task!r}; known: edgemask | "
                "attributemask | pairwise-distance")
        return full

    def _distance_pairs(self, full: Graph, rng):
        """BFS distance classes 1 / 2 / >=3 from seeded anchors, in the JAX
        wrapper's order of draws and pairs."""
        indptr, indices, _ = graph_csr(full)
        N = full.num_nodes
        per_class = self.num_pairs // 3
        anchors = rng.permutation(N)[: min(N, 4 * per_class)]
        buckets = [[], [], []]
        for a in anchors:
            dist = {int(a): 0}
            frontier = [int(a)]
            for d in (1, 2):
                nxt = []
                for u in frontier:
                    for v in indices[indptr[u]: indptr[u + 1]]:
                        v = int(v)
                        if v < N and v not in dist:
                            dist[v] = d
                            nxt.append(v)
                frontier = nxt
            for v, d in dist.items():
                if d > 0 and len(buckets[d - 1]) < per_class:
                    buckets[d - 1].append((int(a), v))
            while len(buckets[2]) < per_class:
                v = int(rng.integers(0, N))
                if v not in dist:
                    buckets[2].append((int(a), v))
                    break
            if all(len(b) >= per_class for b in buckets):
                break
        pairs, labels = [], []
        for cls, b in enumerate(buckets):
            if not b:  # a tiny or dense graph may lack a distance class
                continue
            arr = np.asarray(b, np.int64)
            pairs.append(arr)
            labels.append(np.full(arr.shape[0], cls, np.int64))
        return (torch.from_numpy(np.concatenate(pairs)),
                torch.from_numpy(np.concatenate(labels)))

    @staticmethod
    def _rebuild(graph: Graph, row, col) -> Graph:
        n = graph.num_nodes

        def host(t):
            return None if t is None else t[:n].cpu().numpy()

        return from_coo(np.stack([row, col]), num_nodes=n, x=host(graph.x),
                        y=host(graph.y), train_mask=host(graph.train_mask),
                        val_mask=host(graph.val_mask),
                        test_mask=host(graph.test_mask),
                        meta=dict(graph.meta)).to(graph.device)

    def train_batches(self, graph: Graph):
        return [self._train_graph]

    # -- parameters ------------------------------------------------------------
    def _embed_width(self) -> int:
        """The width of ``model.embed``, from a one-node graph on the
        model's device."""
        dev = next(self.model.parameters()).device
        f_in = self._train_graph.x.shape[1]
        tiny = from_coo(np.zeros((2, 1), np.int64), num_nodes=1,
                        x=np.zeros((1, f_in), np.float32)).to(dev)
        with torch.no_grad():
            return int(self.model.embed(tiny).shape[-1])

    def init(self, generator: torch.Generator, graph: Graph):
        self.model.reset_parameters(generator)
        h = self._embed_width()
        task = self.auxiliary_task
        if task == "edgemask":
            out = 2
        elif task == "attributemask":
            out = self._train_graph.x.shape[-1]
        else:
            out = self._num_dist_classes
        dev = next(self.model.parameters()).device
        w = torch.randn(h, out, generator=generator) / math.sqrt(h)
        self.model.aux = AuxHead(w.to(dev), torch.zeros(out, device=dev))

    # -- the joint loss ---------------------------------------------------------
    def loss(self, graph: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        sup = super().loss(graph, generator, training)
        emb = self.model.embed(graph)
        aux = self.model.aux
        if self.auxiliary_task == "attributemask":
            pred = aux(emb[self._masked_nodes])
            ssl = ((pred - self._feat_targets) ** 2).mean()
        else:
            logits = aux((emb[self._pairs[:, 0]]
                          - emb[self._pairs[:, 1]]).abs())
            logp = torch.log_softmax(logits, -1)
            ssl = -logp.gather(1, self._pair_labels[:, None]).mean()
        return sup + self.aux_weight * ssl
