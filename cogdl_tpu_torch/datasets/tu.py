"""TU-format graph-classification loader — the port of
``cogdl_tpu/datasets/tu.py`` (MUTAG, PROTEINS, NCI1, ...):
``<NAME>_A.txt`` (1-based ``a, b`` rows), ``<NAME>_graph_indicator.txt``,
``<NAME>_graph_labels.txt`` and, optionally, ``<NAME>_node_labels.txt``,
flat under ``<root>/raw`` or in the upstream zip layout
``raw/<CANON>/<CANON>_*.txt`` (:data:`CANONICAL`).

Graph labels are shifted to start at 0. Node labels become one-hot
features over their range; without them a node's feature is its degree as
a source. Each graph keeps its edges in file order: one stable sort by
graph splits them, as the JAX loader's mask a graph does.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..data.graph import Graph, from_coo
from .dataset import Dataset

# registry short name → canonical TU Dortmund archive name (the upstream
# zips unpack <CANON>/<CANON>_*.txt)
CANONICAL = {
    "imdb-b": "IMDB-BINARY", "imdb-m": "IMDB-MULTI",
    "reddit-b": "REDDIT-BINARY", "reddit-multi-5k": "REDDIT-MULTI-5K",
    "reddit-multi-12k": "REDDIT-MULTI-12K", "ptc-mr": "PTC_MR",
}


def build(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    canon = CANONICAL.get(name, name.upper())
    bases = [os.path.join(raw, name.upper()), os.path.join(raw, canon),
             os.path.join(raw, canon, canon)]
    base = next((b for b in bases if os.path.exists(f"{b}_A.txt")), bases[0])
    need = [f"{base}_A.txt", f"{base}_graph_indicator.txt",
            f"{base}_graph_labels.txt"]
    missing = [p for p in need if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"TU dataset {name!r}: place the TUDataset files under {raw} "
            f"(missing {[os.path.basename(p) for p in missing]}). For "
            "offline testing use dataset='random-graphs'.")
    edges = np.loadtxt(need[0], delimiter=",", dtype=np.int64,
                       ndmin=2) - 1                       # 1-based
    indicator = np.loadtxt(need[1], dtype=np.int64) - 1
    glabels = np.loadtxt(need[2], dtype=np.int64)
    glabels = glabels - glabels.min()
    node_label_path = f"{base}_node_labels.txt"
    node_labels = (np.loadtxt(node_label_path, dtype=np.int64)
                   if os.path.exists(node_label_path) else None)

    num_graphs = int(indicator.max()) + 1
    offsets = np.zeros(num_graphs + 1, np.int64)
    np.cumsum(np.bincount(indicator, minlength=num_graphs), out=offsets[1:])
    edge_graph = indicator[edges[:, 0]]
    order = np.argsort(edge_graph, kind="stable")
    edges = edges[order]
    eptr = np.searchsorted(edge_graph[order], np.arange(num_graphs + 1))
    num_classes = int(glabels.max()) + 1
    eye = (np.eye(int(node_labels.max()) + 1, dtype=np.float32)
           if node_labels is not None else None)

    graphs: List[Graph] = []
    for gi in range(num_graphs):
        e = edges[eptr[gi]:eptr[gi + 1]] - offsets[gi]
        n = int(offsets[gi + 1] - offsets[gi])
        if node_labels is not None:
            x = eye[node_labels[offsets[gi]:offsets[gi + 1]]]
        else:
            # a node's degree as its feature
            x = np.bincount(e[:, 0], minlength=n).astype(np.float32)[:, None]
        graphs.append(from_coo(e.T, num_nodes=n, x=x,
                               meta={"num_classes": num_classes}))
    return Dataset.from_graphs(graphs, labels=glabels.astype(np.int32),
                               name=name)
