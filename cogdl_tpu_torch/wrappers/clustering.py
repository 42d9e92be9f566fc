"""Attributed graph clustering — the port of
``cogdl_tpu/wrappers/clustering.py`` (``ClusteringWrapper``): train an
encoder (GAE, VGAE, AGC, DAEGC) by edge reconstruction, cluster its
embeddings with k-means, report NMI.

The graph gets its self loops and the model's normalisation, with the
kernels' structure on the card (``NodeClfWrapper.prepare_graph``). The
loss is the decoder's BCE over the graph's edge slots against ``e_pad``
random pairs, plus VGAE's KL over ``num_nodes``. Its draws, the negative
pairs and VGAE's noise, come from ``draws(graph, generator)``, and
``loss_at(graph, draws, training, generator)`` takes them, so that a
caller can hand it the JAX wrapper's. The evaluation clusters the real
nodes' embeddings with the port's KMeans (``utils/kmeans.py``, best of
``n_init=4`` from seed 0, on the embeddings' device) and scores them with
``normalized_mutual_info``; no scikit-learn."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..data.graph import Graph
from ..utils.evaluator import normalized_mutual_info
from ..utils.kmeans import kmeans
from .link_prediction import draw_negative_pairs, edge_bce
from .node_classification import NodeClfWrapper


class ClusteringWrapper(NodeClfWrapper):
    eval_metric = "val_nmi"
    eval_mode = "max"

    def __init__(self, model, dataset=None, n_clusters: int = 0,
                 num_neg: int = 4):
        super().__init__(model, dataset)
        self.n_clusters = n_clusters
        self.num_neg = num_neg

    def draws(self, graph: Graph, generator: Optional[torch.Generator]):
        """``(negative rows, negative cols, eps)``: ``eps`` is VGAE's
        noise, None for the other models."""
        nr, nc = draw_negative_pairs(graph, generator)
        eps = (self.model.draw_eps(graph, generator)
               if getattr(self.model, "has_kl", False) else None)
        return nr, nc, eps

    def loss(self, graph: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        return self.loss_at(graph, self.draws(graph, generator), training,
                            generator)

    def loss_at(self, graph: Graph, draws, training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        nr, nc, eps = draws
        m = self.model
        kw = {} if eps is None else {"eps": eps}
        z = m(graph, graph.x, training=training, generator=generator, **kw)
        loss = edge_bce(m.decode_edges(z, graph.row, graph.col),
                        m.decode_edges(z, nr, nc), graph)
        if getattr(m, "has_kl", False):
            loss = loss + m.kl(graph, graph.x) / max(float(graph.num_nodes),
                                                     1.0)
        return loss

    @torch.no_grad()
    def evaluate(self, graph: Graph) -> Dict[str, float]:
        n = graph.num_nodes
        z = self.model.embed(graph)[:n].float()
        y = graph.y[:n].cpu().numpy()
        k = self.n_clusters or (int(y.max()) + 1)
        pred = kmeans(z, k, n_init=4, seed=0).labels.cpu().numpy()
        nmi = normalized_mutual_info(y, pred)
        return {"val_nmi": nmi, "test_nmi": nmi}
