"""MATLAB ``.mat`` networks of the embedding benchmarks — the port of
``cogdl_tpu/datasets/matlab.py``: blogcatalog, wikipedia, ppi-ne, dblp-ne,
flickr-ne and youtube-ne, each ``<root>/raw/<name without -ne>.mat`` with a
``network`` sparse adjacency and a ``group`` label matrix (multi-label,
``metric="microf1"``)."""

from __future__ import annotations

import os

import numpy as np

from ..data.graph import from_coo
from .dataset import Dataset


def build(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    fname = os.path.join(raw, f"{name.replace('-ne', '')}.mat")
    if not os.path.exists(fname):
        raise FileNotFoundError(
            f"matlab dataset {name!r}: place the .mat file at {fname} "
            "(keys: 'network' adjacency, 'group' labels).")
    from scipy.io import loadmat

    mat = loadmat(fname)
    A = mat["network"].tocoo()
    labels = np.asarray(mat["group"].todense()
                        if hasattr(mat["group"], "todense") else mat["group"])
    g = from_coo(np.stack([A.row, A.col]), num_nodes=A.shape[0],
                 edge_weight=A.data.astype(np.float32),
                 y=labels.astype(np.float32),
                 meta={"num_classes": labels.shape[1], "name": name,
                       "multilabel": True})
    return Dataset.from_graph(g, name=name, metric="microf1")
