"""Dataset container — the port of ``cogdl_tpu/datasets/dataset.py``: one
graph (node-level tasks), a list of graphs with their labels and an
optional official split (graph-level tasks), or a dict of KG triples
(``from_triples``: ``train`` / ``valid`` / ``test`` ``[n, 3]`` arrays,
``num_entities``, ``num_relations``; no features, no classes).

``link_split``, an attribute a loader may set (the JAX package's OGB link
loader does), holds official evaluation pairs for the link-prediction
wrapper: ``{"valid" | "test": (pos, neg)}``, each ``[n, 2]`` or ``[2, n]``,
``neg`` possibly None."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.graph import Graph


@dataclass
class Dataset:
    name: str = "dataset"
    graph: Optional[Graph] = None
    graphs: Optional[List[Graph]] = None
    labels: Optional[np.ndarray] = None
    # official split of a multi-graph set: "train", "valid" (or "val") and
    # "test" index arrays, which the graph classification wrapper honours
    split_idx: Optional[Dict[str, np.ndarray]] = None
    triples: Optional[Dict[str, Any]] = None
    metric: str = "accuracy"
    link_split: Optional[Dict[str, Any]] = None

    @classmethod
    def from_graph(cls, graph: Graph, name: str = "dataset",
                   metric: str = "accuracy"):
        return cls(name=name, graph=graph, metric=metric)

    @classmethod
    def from_graphs(cls, graphs: List[Graph], labels=None,
                    name: str = "dataset", split_idx=None):
        return cls(name=name, graphs=graphs, labels=labels,
                   split_idx=split_idx)

    @classmethod
    def from_triples(cls, triples: Dict[str, Any], name: str = "dataset"):
        return cls(name=name, triples=triples, metric="mrr")

    def _first(self) -> Optional[Graph]:
        if self.graph is not None:
            return self.graph
        return self.graphs[0] if self.graphs else None

    @property
    def num_features(self) -> int:
        g = self._first()
        if g is None or g.x is None:
            return 0
        return g.num_features

    @property
    def num_classes(self) -> Optional[int]:
        g = self._first()
        if g is None:
            return None
        nc = g.num_classes
        if nc is None and g.y is not None:
            nc = int(torch.max(g.y)) + 1 if g.y.ndim == 1 else int(g.y.shape[1])
        if nc is None and self.labels is not None:
            nc = int(np.max(self.labels)) + 1
        return nc

    def __len__(self):
        return len(self.graphs) if self.graphs is not None else 1

    def __repr__(self):
        if self.graphs is not None:
            return f"Dataset({self.name}, {len(self.graphs)} graphs)"
        if self.triples is not None:
            return f"Dataset({self.name}, KG triples)"
        return f"Dataset({self.name}, {self.graph})"
