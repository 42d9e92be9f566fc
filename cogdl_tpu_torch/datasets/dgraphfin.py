"""DGraphFin, the financial fraud-detection graph — the port of
``cogdl_tpu/datasets/dgraphfin.py``: one ``<root>/raw/dgraphfin.npz``
with ``x`` ``(N, 17)``, ``y`` ``(N,)``, ``edge_index`` ``(E, 2)`` and
``train_mask`` / ``valid_mask`` / ``test_mask`` as arrays of node ids.

The features are standardised column by column (``normalize``, a column
without spread left centred). Classes 2 and 3 are background nodes in no
split, so the class count is taken from the training nodes (the task is
binary).
"""

from __future__ import annotations

import os

import numpy as np

from ..data.graph import from_coo
from .dataset import Dataset


def build(name: str, root: str, normalize: bool = True, **kwargs) -> Dataset:
    path = os.path.join(root, "raw", "dgraphfin.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"DGraphFin: download DGraphFin.zip (https://dgraph.xinye.com) "
            f"and place dgraphfin.npz at {path}")
    items = np.load(path)
    x = items["x"].astype(np.float32)
    y = items["y"].astype(np.int32).reshape(-1)
    ei = items["edge_index"].astype(np.int64).T          # (E, 2) → (2, E)
    if normalize:
        std = x.std(0)
        x = (x - x.mean(0)) / np.where(std > 0, std, 1.0)
    n = x.shape[0]

    def idx_mask(key):
        m = np.zeros(n, bool)
        m[items[key].astype(np.int64)] = True
        return m

    n_cls = int(y[idx_mask("train_mask")].max()) + 1 if n else 2
    g = from_coo(ei, num_nodes=n, x=x, y=y,
                 train_mask=idx_mask("train_mask"),
                 val_mask=idx_mask("valid_mask"),
                 test_mask=idx_mask("test_mask"),
                 meta={"num_classes": n_cls, "name": name})
    return Dataset.from_graph(g, name=name)
