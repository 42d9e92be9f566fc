"""PeMS traffic datasets — the port of
``cogdl_tpu/datasets/traffic_pems.py``: pems-stgcn and pems-stgat, parsed
from local files.

Raw layout under ``<root>/raw``: ``V_<n>.csv``, a header and then one row a
time step (a timestamp, then the ``n`` stations' speeds), and ``W_<n>.csv``,
a header and the ``n × n`` weighted adjacency.

The same graph contract as ``synthetic.traffic_graph``: the road graph from
``W``'s non-zeros (entry ``W[s, d]`` an edge from ``s`` into ``d``) with
``W``'s values as its weights, and ``extras["series"]`` ``[T, n_pad, 1]``,
the series z-scored over all its values and zero on the pad rows; the mean
and standard deviation stay as ``Dataset.series_scale``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.graph import from_coo
from .dataset import Dataset


def _read_csv(path, skip_first_col: bool = False):
    """The rows after the header as float32 (an empty field is 0), and the
    header's column count."""
    rows = []
    with open(path) as f:
        ncol = len(f.readline().rstrip("\n").split(","))
        for line in f:
            vals = line.rstrip("\n").split(",")
            if skip_first_col:
                vals = vals[1:]
            rows.append([float(v) if v else 0.0 for v in vals])
    return np.asarray(rows, np.float32), ncol


def build(name: str, root: str, num_stations: int = 228, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    v_path = os.path.join(raw, f"V_{num_stations}.csv")
    w_path = os.path.join(raw, f"W_{num_stations}.csv")
    missing = [p for p in (v_path, w_path) if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"pems dataset {name!r}: place V_{num_stations}.csv and "
            f"W_{num_stations}.csv under {raw}. Missing: {missing}")
    series, _ = _read_csv(v_path, skip_first_col=True)
    W, _ = _read_csv(w_path)
    N = W.shape[0]
    if series.shape[1] != N:
        raise ValueError(
            f"V has {series.shape[1]} stations but W is {W.shape}")
    src, dst = np.nonzero(W)
    g = from_coo(np.stack([dst.astype(np.int64), src.astype(np.int64)]),
                 num_nodes=N, edge_weight=W[src, dst],
                 meta={"name": name, "num_classes": 1})
    # z-scored over every value (the reference's StandardScaler)
    mean, std = series.mean(), series.std() + 1e-8
    series = ((series - mean) / std)[..., None]
    pad = np.zeros((series.shape[0], g.n_pad - N, 1), np.float32)
    g = g.replace(x=torch.zeros((g.n_pad, 1)), extras={
        "series": torch.from_numpy(np.concatenate([series, pad], axis=1))})
    ds = Dataset.from_graph(g, name=name, metric="mae")
    ds.series_scale = (float(mean), float(std))
    return ds
