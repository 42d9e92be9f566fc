"""Recommendation datasets — the port of ``cogdl_tpu/datasets/rec.py``:
yelp2018, ali and amazon-rec for LightGCN, parsed from local files.

Raw layout under ``<root>/raw``: ``train.txt`` and ``test.txt``, and
``valid.txt`` for ali and amazon-rec (yelp2018 takes its test set as the
validation set). yelp2018 lines are adjacency lists ``u i1 i2 ...``; ali
and amazon-rec lines are ``u i`` pairs whose item ids are offset by the
number of users.

The graph holds the TRAIN interactions only, both directions, items
numbered after the users. The official evaluation positives travel as
``Dataset.eval_user_items`` and ``Dataset.valid_user_items`` (user → array
of 0-based item ids), which ``RecommendationWrapper`` takes instead of
holding out training edges.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from ..data.graph import from_coo
from .dataset import Dataset

PAIR_FORMAT = {"ali", "amazon-rec"}


def _read_cf(path, pair_format: bool) -> np.ndarray:
    """``[n, 2]`` int64 ``(user, item)`` pairs of one file: a pair a line,
    or a user's distinct items in ascending order."""
    pairs = []
    with open(path) as f:
        for line in f:
            ids = [int(i) for i in line.split()]
            if not ids:
                continue
            if pair_format:
                pairs.append(ids[:2])
            else:
                pairs.extend([ids[0], i] for i in sorted(set(ids[1:])))
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def _user_sets(pairs) -> dict:
    """user → int64 array of its items in file order."""
    d = defaultdict(list)
    for u, i in pairs:
        d[int(u)].append(int(i))
    return {u: np.asarray(v, np.int64) for u, v in d.items()}


def build(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    pair_format = name in PAIR_FORMAT
    needed = ["train.txt", "test.txt"] + (["valid.txt"] if pair_format else [])
    missing = [f for f in needed if not os.path.exists(os.path.join(raw, f))]
    if missing:
        raise FileNotFoundError(
            f"rec dataset {name!r}: place {needed} under {raw}. "
            f"Missing: {missing}")
    train = _read_cf(os.path.join(raw, "train.txt"), pair_format)
    test = _read_cf(os.path.join(raw, "test.txt"), pair_format)
    valid = (_read_cf(os.path.join(raw, "valid.txt"), pair_format)
             if pair_format else test)
    n_users = int(max(train[:, 0].max(), valid[:, 0].max(),
                      test[:, 0].max())) + 1
    n_items = int(max(train[:, 1].max(), valid[:, 1].max(),
                      test[:, 1].max())) + 1
    if pair_format:
        # the items arrive offset by the number of users
        n_items -= n_users
        for arr in (train, valid, test):
            arr[:, 1] -= n_users
    users = train[:, 0]
    items = train[:, 1] + n_users
    g = from_coo(np.stack([np.concatenate([users, items]),
                           np.concatenate([items, users])]),
                 num_nodes=n_users + n_items,
                 meta={"num_users": n_users, "num_items": n_items,
                       "name": name})
    ds = Dataset.from_graph(g, name=name, metric="recall")
    ds.eval_user_items = _user_sets(test)
    ds.valid_user_items = _user_sets(valid)
    return ds
