"""RD2CD node-classification collection — the port of
``cogdl_tpu/datasets/rd2cd.py``: Github, Elliptic, Film, Wiki, Clothing,
Electronics, Dblp, Yelpchi, Alpha, Weibo, bgp, ssn5, ssn7, Aids, Nba,
Pokec_z.

Raw layout under ``<root>/raw``: ``x.npy`` ``(N, F)``, ``y.npy`` ``(N,)``
(``-1``: unlabelled) and ``edge_index.npy`` ``(2, E)``. The split is 6-2-2
over the labelled nodes from the reference's seed, :data:`SPLIT_SEED`,
drawn again from the next seed until every class is in train.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.graph import from_coo
from .dataset import Dataset

SPLIT_SEED = 14530529  # the reference's fixed seed


def split_masks(y: np.ndarray, ratio=(6, 2, 2), seed: int = SPLIT_SEED):
    """The train / validation / test masks of a ``ratio`` split over the
    labelled (``y != -1``) nodes, a numpy permutation from ``seed``, then
    ``seed + 1``, ... until the train split holds every class."""
    labeled = np.nonzero(y != -1)[0]
    classes = np.unique(y[labeled])
    total = y.shape[0]
    frac = np.asarray(ratio, np.float64) / sum(ratio)
    while True:
        rng = np.random.default_rng(seed)
        perm = labeled[rng.permutation(labeled.size)]
        n_tr = int(frac[0] * labeled.size)
        n_va = int(frac[1] * labeled.size)
        masks = []
        for sel in (perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:]):
            m = np.zeros(total, bool)
            m[sel] = True
            masks.append(m)
        if np.isin(classes, y[masks[0]]).all():
            return tuple(masks)
        seed += 1


def build(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    needed = ["x.npy", "y.npy", "edge_index.npy"]
    missing = [f for f in needed if not os.path.exists(os.path.join(raw, f))]
    if missing:
        raise FileNotFoundError(
            f"rd2cd dataset {name!r}: place {needed} under {raw}. "
            f"Missing: {missing}")
    x = np.load(os.path.join(raw, "x.npy")).astype(np.float32)
    y = np.load(os.path.join(raw, "y.npy")).astype(np.int32).squeeze()
    ei = np.load(os.path.join(raw, "edge_index.npy"))
    train_mask, val_mask, test_mask = split_masks(y)
    g = from_coo(ei, num_nodes=x.shape[0], x=x, y=y,
                 train_mask=train_mask, val_mask=val_mask,
                 test_mask=test_mask,
                 meta={"num_classes": int(y.max()) + 1, "name": name})
    return Dataset.from_graph(g, name=name)
