"""GCC's pretraining and evaluation sets — the port of
``cogdl_tpu/datasets/gcc.py`` (reference cogdl/datasets/gcc_data.py). Two
raw formats under ``<root>/raw``:

* an edge list (usa-airport, h-index and the six unlabelled pretraining
  corpora gcc_academic, gcc_dblp_netrep, gcc_dblp_snap, gcc_facebook,
  gcc_imdb, gcc_livejournal): ``edgelist.txt``, ``src dst`` a line, made
  undirected, and for the labelled sets ``nodelabel.txt``, ``node label``
  a line. h-index's labels are binarised at their median;
* paired ``.graph`` / ``.dict`` files (kdd_icdm, sigir_cikm,
  sigmod_icde): each ``<part>.graph`` a header line, then ``u v t`` rows
  (the edge repeated ``t`` times, folded into ``edge_weight``), and
  ``<part>.dict`` a tab-separated author name and raw node id a line. The
  Dataset holds both graphs (``graphs``) and ``name_maps``, each name's
  node id in its graph, for the cross-graph similarity search.

Node ids are numbered in order of first appearance."""

from __future__ import annotations

import os

import numpy as np

from ..data.graph import from_coo
from .dataset import Dataset

UNLABELED = {"gcc_academic", "gcc_dblp_netrep", "gcc_dblp_snap",
             "gcc_facebook", "gcc_imdb", "gcc_livejournal"}
PAIRED = {"kdd_icdm": ("kdd", "icdm"), "sigir_cikm": ("sigir", "cikm"),
          "sigmod_icde": ("sigmod", "icde")}


def _read_edgelist(path):
    node2id = {}
    rows, cols = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            u, v = int(parts[0]), int(parts[1])
            for n in (u, v):
                if n not in node2id:
                    node2id[n] = len(node2id)
            rows += [node2id[u], node2id[v]]
            cols += [node2id[v], node2id[u]]
    return np.asarray(rows, np.int64), np.asarray(cols, np.int64), node2id


def build_edgelist(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    edge_path = os.path.join(raw, "edgelist.txt")
    if not os.path.exists(edge_path):
        needed = (["edgelist.txt"] if name in UNLABELED
                  else ["edgelist.txt", "nodelabel.txt"])
        raise FileNotFoundError(
            f"gcc dataset {name!r}: place {needed} under {raw}")
    rows, cols, node2id = _read_edgelist(edge_path)
    N = len(node2id)
    y = None
    meta = {"name": name}
    label_path = os.path.join(raw, "nodelabel.txt")
    if name not in UNLABELED and os.path.exists(label_path):
        nodes, labels, label2id = [], [], {}
        with open(label_path) as f:
            for line in f:
                n, lab = map(int, line.split())
                if lab not in label2id:
                    label2id[lab] = len(label2id)
                nodes.append(node2id[n])
                labels.append(lab if "h-index" in name else label2id[lab])
        labels = np.asarray(labels)
        if "h-index" in name:
            labels = (labels > np.median(labels)).astype(np.int64)
        y = np.zeros(N, np.int32)
        y[nodes] = labels
        meta["num_classes"] = int(labels.max()) + 1
    g = from_coo(np.stack([rows, cols]), num_nodes=N, y=y, meta=meta)
    return Dataset.from_graph(g, name=name)


def _read_gcc_graph(graph_path, dict_path):
    node2id = {}
    rows, cols, w = [], [], []
    with open(graph_path) as f:
        f.readline()
        for line in f:
            u, v, t = map(int, line.split())
            for n in (u, v):
                if n not in node2id:
                    node2id[n] = len(node2id)
            rows += [node2id[u], node2id[v]]
            cols += [node2id[v], node2id[u]]
            w += [float(t), float(t)]
    name_map = {}
    if os.path.exists(dict_path):
        with open(dict_path) as f:
            for line in f:
                nm, sid = line.rstrip("\n").split("\t")
                x = int(sid)
                if x not in node2id:
                    node2id[x] = len(node2id)
                name_map[nm] = node2id[x]
    g = from_coo(np.stack([np.asarray(rows, np.int64),
                           np.asarray(cols, np.int64)]),
                 num_nodes=len(node2id), edge_weight=np.asarray(w, np.float32),
                 meta={"name": os.path.basename(graph_path)})
    return g, name_map


def build_paired(name: str, root: str, **kwargs) -> Dataset:
    parts = PAIRED[name]
    raw = os.path.join(root, "raw")
    needed = [f"{p}{ext}" for p in parts for ext in (".graph", ".dict")]
    if not all(os.path.exists(os.path.join(raw, f"{p}.graph"))
               for p in parts):
        raise FileNotFoundError(
            f"gcc paired dataset {name!r}: place {needed} under {raw}")
    graphs, name_maps = [], []
    for p in parts:
        g, nm = _read_gcc_graph(os.path.join(raw, f"{p}.graph"),
                                os.path.join(raw, f"{p}.dict"))
        graphs.append(g)
        name_maps.append(nm)
    ds = Dataset.from_graphs(graphs, name=name)
    ds.name_maps = name_maps
    return ds
