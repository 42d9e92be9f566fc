"""Heterogeneous wrappers — the port of
``cogdl_tpu/wrappers/heterogeneous.py`` (reference heterogeneous_gnn_dw/mw,
multiplex_embedding_mw,
graph_embedding_mw): ``HeterogeneousGNNWrapper``, masked cross-entropy
node classification whose model reads the metapath graphs carried in the
graph's extras (HAN, GTN) or the typed union graph itself (RGCN, CompGCN,
Simple-HGN); ``MultiplexEmbeddingWrapper``, GATNE's per-edge-type
ROC-AUC of held-out edges; ``GraphEmbeddingWrapper``, graph2vec's and
DGK's whole-graph embeddings under a 3-fold SVC (``utils/svm.py``, no
scikit-learn). The last two own their whole loop (``run_embedding``)."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..data.graph import Graph, from_coo
from ..models import build_model
from ..trainer.trainer import resolve_device
from ..utils.evaluator import roc_auc_score
from ..utils.svm import cross_val_accuracy
from .node_classification import NodeClfWrapper
from .sampled_node_classification import reads_kernel_structure

METAPATH_KEYS = ("metapath_graphs", "relation_graphs")


class HeterogeneousGNNWrapper(NodeClfWrapper):
    """The union graph is used as it is: no self loops, no normalisation
    (the metapath graphs carry their own self loops). On the card, when the
    model runs K1 or K3 (HAN's GAT layers, GTN's ``calls_spmm``), each
    metapath graph gets the kernels' structure once; a tuple held under
    both keys of :data:`METAPATH_KEYS` is prepared once and stays shared.
    RGCN, CompGCN and Simple-HGN use torch index ops on the union graph,
    which gets no structure."""

    def prepare_graph(self, graph: Graph) -> Graph:
        if not graph.extras or not reads_kernel_structure(self.model):
            return graph
        extras = dict(graph.extras)
        prepared = {}
        for key in METAPATH_KEYS:
            gs = extras.get(key)
            if gs is None:
                continue
            if id(gs) not in prepared:
                prepared[id(gs)] = tuple(self.with_structure(g) for g in gs)
            extras[key] = prepared[id(gs)]
        return graph.replace(extras=extras)

    def init(self, generator: torch.Generator, graph: Graph):
        """Size the model to the graph's counts of metapaths, relations and
        edge types where it reads them (its ``fit_graph``, as flax sizes
        them at the first call), then initialise it from ``generator``."""
        fit = getattr(self.model, "fit_graph", None)
        if fit is not None:
            fit(graph)
        super().init(generator, graph)


def _edge_auc(emb: torch.Tensor, pos, neg) -> float:
    """ROC-AUC of the dot-product scores, computed on ``emb``'s device, of
    the ``pos`` pairs (label 1) against the ``neg`` pairs (label 0), each a
    pair of index arrays."""
    def scores(pairs):
        a, b = (torch.as_tensor(np.asarray(p), device=emb.device)
                for p in pairs)
        return (emb[a] * emb[b]).sum(1)

    sp, sn = scores(pos), scores(neg)
    s = torch.cat([sp, sn]).cpu().numpy()
    return roc_auc_score(np.r_[np.ones(sp.numel()), np.zeros(sn.numel())],
                         s)


class MultiplexEmbeddingWrapper:
    """GATNE-style evaluation: the model embeds the graph once per edge
    type (``{type: [N, D]}``, or one ``[N, D]`` for all), and each type
    scores its held-out edges against negatives by dot products on the
    device: ``auc_type<t>``, and their mean as ``val_acc`` / ``test_acc``
    / ``test_auc``. A dataset with official pairs (``multiplex_eval``, the
    GATNE loaders) scores each type's test positives and negatives on the
    graph it holds. Otherwise a random hold-out: ``default_rng(seed)``
    draws ``random(E) < test_ratio`` over the edges, the model trains on
    the rest, and each type with at least four held-out edges draws as
    many uniform negative pairs; these numpy draws are the protocol, the
    JAX wrapper's."""

    def __init__(self, model_name: str, dataset, seed: int = 0,
                 test_ratio: float = 0.2, **model_kwargs):
        self.model = build_model(model_name, seed=seed, **model_kwargs)
        self.dataset = dataset
        self.seed = seed
        self.test_ratio = test_ratio

    def _embed(self, graph: Graph, device):
        t0 = time.perf_counter()
        embs = self.model.train_embeddings(graph, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self._embed_s = time.perf_counter() - t0
        return embs

    def _result(self, out: Dict, aucs) -> Dict:
        mean_auc = float(np.mean(aucs)) if aucs else 0.0
        out.update({"val_acc": mean_auc, "test_acc": mean_auc,
                    "test_auc": mean_auc, "embed_s": self._embed_s,
                    "stats": dict(self.model.stats)})
        return out

    def run_embedding(self, device=None) -> Dict[str, float]:
        """Train on ``device`` (``cuda`` unless the caller names another;
        raises without a card), then score. The result also carries
        ``embed_s`` and the model's ``stats``."""
        device = resolve_device(device)
        graph = self.dataset.graph
        official = getattr(self.dataset, "multiplex_eval", None)
        if official:
            embs = self._embed(graph, device)
            out, aucs = {}, []
            for t, splits in official.items():
                emb = embs.get(int(t)) if isinstance(embs, dict) else embs
                pos, neg = splits["test"]
                if emb is None or pos.shape[1] < 2 or neg.shape[1] < 2:
                    continue
                auc = _edge_auc(emb, pos, neg)
                out[f"auc_type{t}"] = auc
                aucs.append(auc)
            return self._result(out, aucs)
        rng = np.random.default_rng(self.seed)
        E, N = graph.num_edges, graph.num_nodes
        row = graph.row[:E].cpu().numpy()
        col = graph.col[:E].cpu().numpy()
        etype = (graph.edge_type[:E].cpu().numpy()
                 if graph.edge_type is not None else np.zeros(E, np.int64))
        test_sel = rng.random(E) < self.test_ratio
        train_graph = from_coo(np.stack([row[~test_sel], col[~test_sel]]),
                               num_nodes=N, edge_type=etype[~test_sel])
        embs = self._embed(train_graph, device)
        out, aucs = {}, []
        for t in np.unique(etype):
            emb = embs.get(int(t)) if isinstance(embs, dict) else embs
            if emb is None:
                continue
            sel = test_sel & (etype == t)
            pos = (row[sel], col[sel])
            if pos[0].size < 4:
                continue
            neg = (rng.integers(0, N, pos[0].size),
                   rng.integers(0, N, pos[0].size))
            auc = _edge_auc(emb, pos, neg)
            out[f"auc_type{t}"] = auc
            aucs.append(auc)
        return self._result(out, aucs)


class GraphEmbeddingWrapper:
    """graph2vec / DGK: whole-graph embeddings on the device, then
    ``cross_val_score(SVC(), emb, labels, cv=3)`` as the port computes it
    (``utils/svm.cross_val_accuracy``: stratified, unshuffled folds, the
    RBF SVC by SMO on the host in float64). ``val_acc`` and ``test_acc``
    are the folds' mean accuracy, ``acc_std`` their spread; the result also
    carries ``embed_s``, ``svc_s`` and the model's ``stats``."""

    def __init__(self, model_name: str, dataset, seed: int = 0,
                 **model_kwargs):
        self.model = build_model(model_name, seed=seed, **model_kwargs)
        self.dataset = dataset
        self.seed = seed

    def run_embedding(self, device=None) -> Dict[str, float]:
        device = resolve_device(device)
        labels = np.asarray(self.dataset.labels)
        t0 = time.perf_counter()
        emb = self.model.train_graph_embeddings(self.dataset.graphs, device)
        emb = emb.cpu().numpy()
        t1 = time.perf_counter()
        scores = cross_val_accuracy(emb, labels, cv=3)
        acc = float(np.mean(scores))
        return {"val_acc": acc, "test_acc": acc,
                "acc_std": float(np.std(scores)), "embed_s": t1 - t0,
                "svc_s": time.perf_counter() - t1,
                "stats": dict(self.model.stats)}
