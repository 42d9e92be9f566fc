"""User data — the port of ``cogdl_tpu/datasets/customized.py``:
``NodeDataset`` (one graph from arrays or a saved ``.npz`` / ``.pkl``,
with seeded random splits where it has no masks), ``GraphDataset`` (a
list of graphs and their labels) and ``generate_random_graph``."""

from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np

from ..data.graph import Graph, from_coo
from .dataset import Dataset


def NodeDataset(path: Optional[str] = None, edge_index=None, x=None, y=None,
                train_ratio: float = 0.6, val_ratio: float = 0.2,
                seed: int = 0, name: str = "custom") -> Dataset:
    """One graph for node classification, from ``edge_index`` (``(2, E)``,
    destination first), ``x`` and ``y``, or from the file ``path`` (an
    ``.npz``, else a pickle, holding those keys and optionally
    ``train_mask`` / ``val_mask`` / ``test_mask``). Without masks and with
    labels, the nodes are split ``train_ratio`` / ``val_ratio`` / the rest
    by a numpy permutation from ``seed``. Integer labels are kept as
    int32. A pickle runs code when read: read only files you trust."""
    masks = {}
    if path is not None:
        if path.endswith(".npz"):
            data = dict(np.load(path, allow_pickle=True))
        else:
            with open(path, "rb") as f:
                data = pickle.load(f)
        edge_index = data["edge_index"]
        x = data.get("x")
        y = data.get("y")
        masks = {k: data[k] for k in ("train_mask", "val_mask", "test_mask")
                 if k in data}
    ei = np.asarray(edge_index)
    num_nodes = (np.asarray(x).shape[0] if x is not None
                 else int(ei.max()) + 1)
    if not masks and y is not None:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(num_nodes)
        n_tr = int(train_ratio * num_nodes)
        n_va = int(val_ratio * num_nodes)
        for key, sl in (("train_mask", perm[:n_tr]),
                        ("val_mask", perm[n_tr: n_tr + n_va]),
                        ("test_mask", perm[n_tr + n_va:])):
            m = np.zeros(num_nodes, bool)
            m[sl] = True
            masks[key] = m
    y_arr = None if y is None else np.asarray(y)
    if y_arr is not None and y_arr.dtype.kind in "iu":
        y_arr = y_arr.astype(np.int32)     # the graph's label type
    meta = {"name": name}
    if y_arr is not None:
        meta["num_classes"] = (int(y_arr.max()) + 1 if y_arr.ndim == 1
                               else y_arr.shape[1])
    g = from_coo(ei, num_nodes=num_nodes, x=x, y=y_arr, meta=meta, **masks)
    return Dataset.from_graph(g, name=name)


def GraphDataset(graphs: List[Graph], labels=None, name: str = "custom"
                 ) -> Dataset:
    """Graph classification from a list of graphs and their labels."""
    return Dataset.from_graphs(list(graphs), labels=None if labels is None
                               else np.asarray(labels, np.int32), name=name)


def generate_random_graph(num_nodes: int = 100, num_edges: int = 500,
                          num_feats: int = 16, seed: int = 0) -> Graph:
    """``num_edges`` uniform random edges over ``num_nodes`` nodes and
    standard normal features, from a numpy generator seeded ``seed``."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, num_nodes, size=(2, num_edges))
    x = rng.normal(size=(num_nodes, num_feats)).astype(np.float32)
    return from_coo(ei, num_nodes=num_nodes, x=x)
