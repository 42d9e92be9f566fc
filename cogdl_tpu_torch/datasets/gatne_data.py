"""GATNE's multiplex networks — the port of
``cogdl_tpu/datasets/gatne_data.py`` (reference cogdl/datasets/gatne.py):
amazon, twitter, youtube.

Raw layout under ``<root>/raw``:

* ``train.txt``: ``etype u v`` a line;
* ``valid.txt``, ``test.txt``: ``etype u v label`` (1 a positive, 0 a
  sampled negative).

Node ids are numbered in order of first appearance, train then valid then
test, edge types likewise. The Dataset's graph holds the train edges, made
undirected and typed (``edge_type``); ``Dataset.multiplex_eval`` carries
the official pairs, ``{etype: {"valid": (pos, neg), "test": (pos, neg)}}``
with ``(2, E)`` int64 arrays (empty for a type a split lacks), which
``MultiplexEmbeddingWrapper`` scores instead of a random hold-out."""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from ..data.graph import from_coo
from .dataset import Dataset


def build(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    needed = ["train.txt", "valid.txt", "test.txt"]
    missing = [f for f in needed if not os.path.exists(os.path.join(raw, f))]
    if missing:
        raise FileNotFoundError(
            f"gatne dataset {name!r}: place {needed} under {raw}. "
            f"Missing: {missing}")
    node2id, type2id = {}, {}

    def nid(v):
        if v not in node2id:
            node2id[v] = len(node2id)
        return node2id[v]

    def tid(t):
        if t not in type2id:
            type2id[t] = len(type2id)
        return type2id[t]

    rows, cols, etypes = [], [], []
    with open(os.path.join(raw, "train.txt")) as f:
        for line in f:
            t, u, v = line.split()[:3]
            t, u, v = tid(t), nid(u), nid(v)
            rows += [u, v]
            cols += [v, u]
            etypes += [t, t]
    eval_pairs = {}
    for split in ("valid", "test"):
        per_type = defaultdict(lambda: ([], []))
        with open(os.path.join(raw, f"{split}.txt")) as f:
            for line in f:
                t, u, v, lab = line.split()[:4]
                bucket = per_type[tid(t)][0 if int(lab) == 1 else 1]
                bucket.append((nid(u), nid(v)))
        eval_pairs[split] = {
            t: (np.asarray(pos, np.int64).reshape(-1, 2).T,
                np.asarray(neg, np.int64).reshape(-1, 2).T)
            for t, (pos, neg) in per_type.items()}
    g = from_coo(np.stack([np.asarray(rows, np.int64),
                           np.asarray(cols, np.int64)]),
                 num_nodes=len(node2id),
                 edge_type=np.asarray(etypes, np.int32),
                 meta={"name": name, "num_relations": len(type2id)})
    ds = Dataset.from_graph(g, name=name, metric="auc")
    empty = (np.zeros((2, 0), np.int64),) * 2
    ds.multiplex_eval = {
        t: {split: eval_pairs[split].get(t, empty)
            for split in ("valid", "test")}
        for t in range(len(type2id))}
    return ds
