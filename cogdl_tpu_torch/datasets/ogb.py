"""OGB loaders — the port of ``cogdl_tpu/datasets/ogb.py``, reading the
extracted npy / npz layouts under ``<root>/raw`` (no ``ogb`` package):

* node property (``build_node``): ``edge_index.npy`` ``(2, E)``,
  ``node_feat.npy`` ``(N, F)``, ``labels.npy`` ``(N,)`` or ``(N, k)``
  (multilabel, as ogbn-proteins: the class count is the width and the
  metric ``multilabel_f1``), ``split/{train,valid,test}.npy`` node ids; the
  graph made undirected;
* graph property (``build_graph``): ``graphs.npz`` with ``node_ptr`` and
  ``edge_ptr`` ``(G + 1,)``, graph-local ``edge_index`` ``(2, E_total)``,
  ``labels`` ``(G,)`` or ``(G, T)``, ``node_feat`` optional, and
  ``split/{train,valid,test}.npy`` graph ids as ``Dataset.split_idx``,
  which the graph classification wrapper honours;
* link property (``build_link``): ``edge_index.npy`` (the training edges),
  ``node_feat.npy`` optional, ``split/{valid,test}_{pos,neg}.npy`` pairs as
  ``Dataset.link_split``, which the link prediction wrapper takes instead
  of holding out edges itself.

Missing files raise the JAX loaders' ``FileNotFoundError`` (the text it
gives where the ``ogb`` package is absent); nothing is downloaded.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.graph import from_coo, to_undirected
from .dataset import Dataset


def _label_meta(y, name):
    """Multilabel sets (ogbn-proteins: ``[N, 112]`` binary) take the class
    count from the label width, the multilabel flag and its metric."""
    if y.ndim == 2:
        return {"num_classes": int(y.shape[1]), "multilabel": True,
                "metric": "multilabel_f1", "name": name}
    return {"num_classes": int(y.max()) + 1, "name": name}


def build_graph(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    path = os.path.join(raw, "graphs.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"OGB graph dataset {name!r}: place graphs.npz (node_ptr/"
            f"edge_ptr/edge_index/labels[/node_feat]) under {raw}, or "
            "install the ogb package with its download cache.")
    data = dict(np.load(path, allow_pickle=False))
    node_ptr = data["node_ptr"].astype(np.int64)
    edge_ptr = data["edge_ptr"].astype(np.int64)
    ei = data["edge_index"].astype(np.int64)
    labels = data["labels"]
    node_feat = data.get("node_feat")
    graphs = []
    for i in range(len(node_ptr) - 1):
        n = int(node_ptr[i + 1] - node_ptr[i])
        e = ei[:, edge_ptr[i]:edge_ptr[i + 1]]
        x = (node_feat[node_ptr[i]:node_ptr[i + 1]].astype(np.float32)
             if node_feat is not None else None)
        graphs.append(from_coo(e, num_nodes=max(n, 1), x=x))
    ds = Dataset.from_graphs(graphs, labels=labels, name=name)
    if labels.ndim == 2 and labels.shape[1] > 1:
        ds.metric = "multilabel_f1"
    split = {}
    for part in ("train", "valid", "test"):
        p = os.path.join(raw, "split", f"{part}.npy")
        if os.path.exists(p):
            split[part] = np.load(p)
    if split:
        ds.split_idx = split
    return ds


def build_link(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    ei_path = os.path.join(raw, "edge_index.npy")
    if not os.path.exists(ei_path):
        raise FileNotFoundError(
            f"OGB link dataset {name!r}: place edge_index.npy "
            f"[node_feat.npy] and split/{{valid,test}}_{{pos,neg}}.npy "
            f"under {raw}")
    ei = np.load(ei_path)
    x_path = os.path.join(raw, "node_feat.npy")
    x = np.load(x_path).astype(np.float32) if os.path.exists(x_path) else None
    N = x.shape[0] if x is not None else int(ei.max()) + 1
    g = from_coo(ei, num_nodes=N, x=x, meta={"name": name})
    ds = Dataset.from_graph(to_undirected(g), name=name, metric="auc")
    split = {}
    for part in ("valid", "test"):
        pos = os.path.join(raw, "split", f"{part}_pos.npy")
        neg = os.path.join(raw, "split", f"{part}_neg.npy")
        if os.path.exists(pos):
            split[part] = (np.load(pos),
                           np.load(neg) if os.path.exists(neg) else None)
    if split:
        ds.link_split = split
    return ds


def build_node(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    npys = ["edge_index.npy", "node_feat.npy", "labels.npy"]
    if not all(os.path.exists(os.path.join(raw, f)) for f in npys):
        raise FileNotFoundError(
            f"OGB dataset {name!r}: place edge_index.npy / node_feat.npy / "
            f"labels.npy / split/*.npy under {raw}, or install the ogb "
            "package with its download cache.")
    ei = np.load(os.path.join(raw, "edge_index.npy"))
    x = np.load(os.path.join(raw, "node_feat.npy")).astype(np.float32)
    y = np.load(os.path.join(raw, "labels.npy")).squeeze()
    N = x.shape[0]
    masks = {}
    for split in ("train", "valid", "test"):
        p = os.path.join(raw, "split", f"{split}.npy")
        m = np.zeros(N, bool)
        if os.path.exists(p):
            m[np.load(p)] = True
        masks[split] = m
    g = from_coo(ei, num_nodes=N, x=x, y=y.astype(np.int32),
                 train_mask=masks["train"], val_mask=masks["valid"],
                 test_mask=masks["test"], meta=_label_meta(y, name))
    return Dataset.from_graph(to_undirected(g), name=name)
