"""Heterogeneous GTN/HAN datasets — the port of
``cogdl_tpu/datasets/hetero.py`` (reference cogdl/datasets/gtn_data.py and
han_data.py): gtn-acm / gtn-dblp / gtn-imdb and han-acm / han-dblp /
han-imdb.

Raw layouts under ``<root>/raw``:
  GTN:  edges.pkl (list of scipy sparse per-relation adjacencies),
        labels.pkl ([train, valid, test] arrays of (node, label) pairs),
        node_features.pkl (N, F numpy)           (gtn_data.py:30-31,42-45)
  HAN:  data.mat with label/feature(+s) and the per-name metapath
        adjacency keys (PAP/PLP, net_APA/APCPA/APTPA, MAM/MDM/MYM) plus
        train/val/test_idx                        (han_data.py:49-83)

Both give the heterogeneous graph contract of
``synthetic.hetero_sbm_graph``: a typed-edge union graph whose
``extras['metapath_graphs']`` / ``extras['relation_graphs']`` hold one
graph a metapath padded to the union graph's ``n_pad`` (self loops added:
the reference appends an identity adjacency to its A list), and
``extras['node_type']``. Only local files are read; nothing is downloaded.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..data.graph import add_self_loops, from_coo, pad_to
from .dataset import Dataset


def _assemble(name, metapath_edges, x, y, train_mask, val_mask, test_mask,
              node_type):
    """Union graph + padded per-metapath graphs from [(row, col)] lists."""
    N = x.shape[0]
    rows = np.concatenate([r for r, _ in metapath_edges])
    cols = np.concatenate([c for _, c in metapath_edges])
    etype = np.concatenate([np.full(r.size, i, np.int32)
                            for i, (r, _) in enumerate(metapath_edges)])
    g = from_coo(np.stack([rows, cols]), num_nodes=N, edge_type=etype,
                 x=x, y=y, train_mask=train_mask, val_mask=val_mask,
                 test_mask=test_mask,
                 meta={"num_classes": int(y.max()) + 1,
                       "num_relations": len(metapath_edges), "name": name})
    shared_n, shared_e = g.n_pad, g.e_pad
    metas = []
    for r, c in metapath_edges:
        gm = from_coo(np.stack([r, c]), num_nodes=N, n_pad=shared_n,
                      e_pad=shared_e, bucket=False)
        metas.append(add_self_loops(gm).replace(meta=gm.meta))
    metas = tuple(pad_to(m, shared_n, max(m.e_pad, shared_e)) for m in metas)
    nt = np.zeros(shared_n, np.int32)
    nt[:N] = node_type
    return g.replace(extras={"node_type": torch.from_numpy(nt),
                             "metapath_graphs": metas,
                             "relation_graphs": metas})


def build_gtn(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    needed = ["edges.pkl", "labels.pkl", "node_features.pkl"]
    missing = [f for f in needed if not os.path.exists(os.path.join(raw, f))]
    if missing:
        raise FileNotFoundError(
            f"gtn dataset {name!r}: place {needed} under {raw}. "
            f"Missing: {missing}")
    with open(os.path.join(raw, "edges.pkl"), "rb") as f:
        edges = pickle.load(f)
    with open(os.path.join(raw, "labels.pkl"), "rb") as f:
        labels = pickle.load(f)
    with open(os.path.join(raw, "node_features.pkl"), "rb") as f:
        x = np.asarray(pickle.load(f), np.float32)
    N = x.shape[0]

    metapath_edges = []
    for a in edges:
        r, c = (a.nonzero() if hasattr(a, "nonzero") else
                (np.asarray(a[0]), np.asarray(a[1])))
        # scipy nonzero gives (row=src, col=dst) of A[src, dst]; our CSR row
        # is the destination, so flip (reference stacks src above dst:
        # gtn_data.py:70)
        metapath_edges.append((np.asarray(c, np.int64),
                               np.asarray(r, np.int64)))

    # node types from relation endpoints (reference gtn_data.py:52-63: four
    # relations 0-1 / 1-0 / 0-2 / 2-0)
    node_type = np.zeros(N, np.int32)
    if len(metapath_edges) == 4:
        (c0, r0), (c1, r1), (c2, r2), (c3, r3) = metapath_edges
        node_type[r0] = 0
        node_type[c0] = 1
        node_type[r1] = 1
        node_type[c1] = 0
        node_type[r2] = 0
        node_type[c2] = 2
        node_type[r3] = 2
        node_type[c3] = 0

    y = np.zeros(N, np.int32)
    masks = []
    for part in labels:
        part = np.asarray(part)
        m = np.zeros(N, bool)
        m[part[:, 0]] = True
        y[part[:, 0]] = part[:, 1]
        masks.append(m)
    g = _assemble(name, metapath_edges, x, y, *masks, node_type)
    return Dataset.from_graph(g, name=name)


HAN_KEYS = {
    "han-acm": ("label", "feature", ["PAP", "PLP"]),
    "han-imdb": ("label", "feature", ["MAM", "MDM", "MYM"]),
    "han-dblp": ("label", "features", ["net_APA", "net_APCPA", "net_APTPA"]),
}


def build_han(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    path = os.path.join(raw, "data.mat")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"han dataset {name!r}: place data.mat under {raw}")
    import scipy.io as sio
    import scipy.sparse as sp

    data = sio.loadmat(path)
    label_key, feat_key, net_keys = HAN_KEYS.get(
        name, ("label", "feature",
               [k for k in data if not k.startswith("__")
                and k not in ("label", "feature", "features",
                              "train_idx", "val_idx", "test_idx")]))
    y_onehot = np.asarray(data[label_key])
    x = np.asarray(
        data[feat_key].todense() if sp.issparse(data[feat_key])
        else data[feat_key], np.float32)
    N = x.shape[0]
    metapath_edges = []
    for k in net_keys:
        net = data[k]
        net = np.asarray(net.todense() if sp.issparse(net) else net)
        net = net - np.eye(N)  # reference strips the diagonal (han_data.py:57)
        src, dst = np.nonzero(net)
        metapath_edges.append((dst.astype(np.int64), src.astype(np.int64)))

    y = np.zeros(N, np.int32)
    masks = []
    for k in ("train_idx", "val_idx", "test_idx"):
        idx = np.asarray(data[k]).reshape(-1)
        m = np.zeros(N, bool)
        m[idx] = True
        y[idx] = np.argmax(y_onehot[idx], axis=1)
        masks.append(m)
    g = _assemble(name, metapath_edges, x, y, *masks,
                  np.zeros(N, np.int32))
    return Dataset.from_graph(g, name=name)
