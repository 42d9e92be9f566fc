"""GRB adversarial-robustness datasets — the port of
``cogdl_tpu/datasets/grb.py``: grb-cora, grb-citeseer, grb-reddit,
grb-aminer and grb-flickr.

Raw layout under ``<root>/raw``: ``adj.npz`` (a scipy sparse adjacency
whose values are the edge weights), ``features.npz`` and ``labels.npz``
(key ``data``), ``index.npz`` with ``index_train``, ``index_val`` and
``index_test[_easy|_medium|_hard]``.

``mode`` picks the test split by difficulty (``full``: every test node);
``feat_norm`` applies one of the reference's feature normalisations
(:func:`feat_normalize`). The edge weights are the graph's, so a model's
normalisation scales them and K1 reads the result.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.graph import from_coo
from .dataset import Dataset

MODES = ("easy", "medium", "hard", "full")
FEAT_NORMS = (None, "linearize", "arctan", "tanh", "standardize")


def feat_normalize(features, norm=None, lim_min=-1.0, lim_max=1.0):
    """``linearize``: onto ``[lim_min, lim_max]``; ``standardize``: zero
    mean and unit deviation over all entries, which ``arctan``
    (``2·arctan(·)/π``) and ``tanh`` then squash; ``None``: unchanged."""
    if norm == "linearize":
        k = (lim_max - lim_min) / (features.max() - features.min())
        return lim_min + k * (features - features.min())
    if norm in ("arctan", "tanh", "standardize"):
        features = (features - features.mean()) / features.std()
        if norm == "arctan":
            return 2 * np.arctan(features) / np.pi
        if norm == "tanh":
            return np.tanh(features)
    return features


def build(name: str, root: str, mode: str = "full", feat_norm=None,
          **kwargs) -> Dataset:
    if mode not in MODES:
        raise ValueError(f"grb mode {mode!r} not in {MODES}")
    if feat_norm not in FEAT_NORMS:
        raise ValueError(f"grb feat_norm {feat_norm!r} not in {FEAT_NORMS}")
    raw = os.path.join(root, "raw")
    needed = ["adj.npz", "features.npz", "labels.npz", "index.npz"]
    missing = [f for f in needed if not os.path.exists(os.path.join(raw, f))]
    if missing:
        raise FileNotFoundError(
            f"grb dataset {name!r}: place {needed} under {raw}. "
            f"Missing: {missing}")
    import scipy.sparse as sp

    adj = sp.load_npz(os.path.join(raw, "adj.npz")).tocoo()
    feats = np.load(os.path.join(raw, "features.npz"))["data"]
    feats = feat_normalize(feats.astype(np.float32), feat_norm)
    y = np.load(os.path.join(raw, "labels.npz"))["data"].astype(np.int32)
    index = np.load(os.path.join(raw, "index.npz"))
    N = feats.shape[0]

    def mask(idx):
        m = np.zeros(N, bool)
        m[idx] = True
        return m

    test_key = "index_test" if mode == "full" else f"index_test_{mode}"
    g = from_coo(np.stack([adj.row, adj.col]), num_nodes=N,
                 edge_weight=adj.data.astype(np.float32),
                 x=feats, y=y,
                 train_mask=mask(index["index_train"]),
                 val_mask=mask(index["index_val"]),
                 test_mask=mask(index[test_key]),
                 meta={"num_classes": int(y.max()) + 1, "name": name,
                       "grb_mode": mode})
    return Dataset.from_graph(g, name=name)
