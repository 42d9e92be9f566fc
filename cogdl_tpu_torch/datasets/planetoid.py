"""Planetoid loader — the port of ``cogdl_tpu/datasets/planetoid.py``:
Cora, CiteSeer and PubMed from the standard
``ind.<name>.{x,y,tx,ty,allx,ally,graph,test.index}`` pickles under
``<root>/raw``.

The test rows (``tx``, ``ty``) go to the ids of ``test.index``; CiteSeer's
isolated test nodes get zero rows over the gap in that range. Features are
row-normalised, labels are the argmax of the one-hot rows, the training
nodes are the first ``len(y)``, the validation nodes the 500 after them,
and the graph is made undirected (duplicate edges summed first, then each
pair kept once in both directions). Missing files raise
``FileNotFoundError`` naming them; nothing is downloaded.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..data.graph import from_coo, to_undirected
from .dataset import Dataset

FILES = ["x", "y", "tx", "ty", "allx", "ally", "graph", "test.index"]


def _read_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _dense(m) -> np.ndarray:
    return np.asarray(m.todense() if hasattr(m, "todense") else m,
                      dtype=np.float32)


def build(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    paths = [os.path.join(raw, f"ind.{name}.{s}") for s in FILES]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"planetoid dataset {name!r} not found. Place the standard files "
            f"ind.{name}.* (from github.com/kimiyoung/planetoid) under {raw}. "
            f"Missing: {[os.path.basename(p) for p in missing]}. "
            "For offline testing use dataset='sbm'."
        )
    x, y, tx, ty, allx, ally = (_read_pickle(p) for p in paths[:6])
    graph = _read_pickle(paths[6])
    test_idx_reorder = np.loadtxt(paths[7], dtype=np.int64)
    test_idx_range = np.sort(test_idx_reorder)

    if name == "citeseer":
        # citeseer has isolated test nodes: extend tx / ty over the range
        full = np.arange(test_idx_range[0], test_idx_range[-1] + 1)
        tx_ext = np.zeros((len(full), tx.shape[1]), dtype=np.float32)
        tx_ext[test_idx_range - test_idx_range[0]] = _dense(tx)
        ty_ext = np.zeros((len(full), ty.shape[1]), dtype=np.float32)
        ty_ext[test_idx_range - test_idx_range[0]] = np.asarray(ty)
        tx, ty = tx_ext, ty_ext

    features = np.vstack([_dense(allx), _dense(tx)])
    features[test_idx_reorder] = features[test_idx_range]
    labels_onehot = np.vstack([np.asarray(ally), np.asarray(ty)])
    labels_onehot[test_idx_reorder] = labels_onehot[test_idx_range]
    labels = labels_onehot.argmax(axis=1).astype(np.int32)

    num_nodes = features.shape[0]
    # an edge a (source, destination) entry, messages source → destination
    srcs = list(graph)
    dsts = [np.asarray(graph[s], np.int64).reshape(-1) for s in srcs]
    counts = np.asarray([d.size for d in dsts], np.int64)
    edge_index = np.stack([
        np.concatenate(dsts) if dsts else np.zeros(0, np.int64),
        np.repeat(np.asarray(srcs, np.int64), counts)])

    # row-normalised features (the reference's normalize_feature)
    rs = features.sum(axis=1, keepdims=True)
    features = features / np.maximum(rs, 1e-12)

    n_train = np.asarray(y).shape[0]
    train_mask = np.zeros(num_nodes, bool)
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    train_mask[:n_train] = True
    val_mask[n_train: n_train + 500] = True
    test_mask[test_idx_range] = True

    g = from_coo(
        edge_index, num_nodes=num_nodes, x=features, y=labels,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
        coalesce=True,
        meta={"num_classes": int(labels_onehot.shape[1]), "name": name},
    )
    return Dataset.from_graph(to_undirected(g), name=name)
