"""Heterogeneous node classification wrapper — the port of
``HeterogeneousGNNWrapper`` in ``cogdl_tpu/wrappers/heterogeneous.py``
(reference heterogeneous_gnn_dw/mw): masked cross-entropy node
classification whose model reads the metapath graphs carried in the
graph's extras (HAN, GTN) or the typed union graph itself (RGCN, CompGCN,
Simple-HGN)."""

from __future__ import annotations

import torch

from ..data.graph import Graph
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
