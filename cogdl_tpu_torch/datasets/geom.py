"""Geom-GCN heterophily datasets — the port of ``cogdl_tpu/datasets/geom.py``:
chameleon, cornell, film, squirrel, texas, wisconsin and the
``{cora,citeseer,pubmed}_geom`` re-splits.

Raw layout under ``<root>/raw``:
  out1_graph_edges.txt         ``src<TAB>dst`` a line after a header line
  out1_node_feature_label.txt  ``id<TAB>f1,f2,...<TAB>label`` after a
                               header line; for film the feature field
                               lists the active indices of a 932-wide
                               multi-hot vector
  <name>_split_0.6_0.2_<k>.npz k in 0..9: ``train_mask`` / ``val_mask`` /
                               ``test_mask``

``split`` picks one of the ten published splits. The graph stays directed:
an edge ``s → d`` is the CSR entry of row ``d`` (the destination), column
``s``.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.graph import from_coo
from .dataset import Dataset

FILM_DIM = 932


def build(name: str, root: str, split: int = 0, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    edges_path = os.path.join(raw, "out1_graph_edges.txt")
    feats_path = os.path.join(raw, "out1_node_feature_label.txt")
    base = name[:-5] if name.endswith("_geom") else name
    split_path = os.path.join(raw, f"{base}_split_0.6_0.2_{split}.npz")
    if not os.path.exists(split_path):
        split_path = os.path.join(raw, f"{name}_split_0.6_0.2_{split}.npz")
    missing = [p for p in (edges_path, feats_path, split_path)
               if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"geom dataset {name!r}: place out1_graph_edges.txt, "
            f"out1_node_feature_label.txt and the 10 "
            f"*_split_0.6_0.2_<k>.npz files under {raw}. Missing: {missing}")

    feats, labels = {}, {}
    with open(feats_path) as f:
        f.readline()
        for line in f:
            nid, feat, label = line.rstrip().split("\t")
            idx = np.array(feat.split(","), np.int64)
            if base == "film":
                vec = np.zeros(FILM_DIM, np.float32)
                vec[idx] = 1.0
            else:
                vec = idx.astype(np.float32)
            feats[int(nid)] = vec
            labels[int(nid)] = int(label)
    N = max(feats) + 1
    x = np.zeros((N, len(next(iter(feats.values())))), np.float32)
    y = np.zeros(N, np.int32)
    for nid, vec in feats.items():
        x[nid] = vec
        y[nid] = labels[nid]

    # directed s → d: the message flows source to destination, so the CSR
    # row (the destination) is d
    sd = np.loadtxt(edges_path, dtype=np.int64, skiprows=1, ndmin=2)

    with np.load(split_path) as sf:
        train_mask = sf["train_mask"].astype(bool)
        val_mask = sf["val_mask"].astype(bool)
        test_mask = sf["test_mask"].astype(bool)

    g = from_coo(np.stack([sd[:, 1], sd[:, 0]]), num_nodes=N, x=x, y=y,
                 train_mask=train_mask, val_mask=val_mask,
                 test_mask=test_mask,
                 meta={"num_classes": int(y.max()) + 1, "name": name})
    return Dataset.from_graph(g, name=name)
