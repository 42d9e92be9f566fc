"""GraphSAINT-format loader — the port of ``cogdl_tpu/datasets/saint.py``:
flickr, reddit, yelp, ppi, ppi-large and amazon-s from ``adj_full.npz``
(a scipy sparse adjacency), ``feats.npy``, ``class_map.json`` (node id →
class, or → a multi-hot list) and ``role.json`` (``tr`` / ``va`` / ``te``
node ids) under ``<root>/raw``. The multilabel sets (:data:`MULTILABEL`)
carry ``multilabel`` in their meta and the metric ``microf1``."""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.graph import from_coo
from .dataset import Dataset

MULTILABEL = {"yelp", "ppi", "ppi-large", "amazon-s"}


def build(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    needed = ["adj_full.npz", "feats.npy", "class_map.json", "role.json"]
    missing = [f for f in needed if not os.path.exists(os.path.join(raw, f))]
    if missing:
        raise FileNotFoundError(
            f"saint dataset {name!r}: place {needed} under {raw} "
            f"(GraphSAINT format). Missing: {missing}")
    import scipy.sparse as sp

    adj = sp.load_npz(os.path.join(raw, "adj_full.npz")).tocoo()
    feats = np.load(os.path.join(raw, "feats.npy")).astype(np.float32)
    with open(os.path.join(raw, "class_map.json")) as f:
        class_map = json.load(f)
    with open(os.path.join(raw, "role.json")) as f:
        role = json.load(f)
    N = feats.shape[0]
    ids = np.fromiter((int(k) for k in class_map), np.int64, len(class_map))
    first = next(iter(class_map.values()))
    if isinstance(first, list):
        C = len(first)
        y = np.zeros((N, C), np.float32)
        y[ids] = np.asarray(list(class_map.values()), np.float32)
    else:
        y = np.zeros(N, np.int32)
        y[ids] = np.fromiter(class_map.values(), np.int64, len(class_map))
        C = int(y.max()) + 1
    train_mask = np.zeros(N, bool)
    val_mask = np.zeros(N, bool)
    test_mask = np.zeros(N, bool)
    train_mask[role["tr"]] = True
    val_mask[role["va"]] = True
    test_mask[role["te"]] = True
    g = from_coo(np.stack([adj.row, adj.col]), num_nodes=N, x=feats, y=y,
                 train_mask=train_mask, val_mask=val_mask,
                 test_mask=test_mask,
                 meta={"num_classes": C, "name": name,
                       "multilabel": name in MULTILABEL})
    return Dataset.from_graph(
        g, name=name,
        metric="microf1" if name in MULTILABEL else "accuracy")
