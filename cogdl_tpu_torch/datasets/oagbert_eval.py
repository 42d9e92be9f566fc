"""OAGBert zero-shot evaluation sets — the port of
``cogdl_tpu/datasets/oagbert_eval.py``: l0fos, aff30 and arxivvenue.

Raw layout under ``<root>/raw``: ``._SUCCESS`` (a candidate label a line)
and ``*.jsonl`` paper records (a JSON object a line). Returns a dataset
without a graph carrying ``candidates`` (list of str) and ``samples``
({file name: list of dict}), which the ``oagbert`` pipeline scores.
"""

from __future__ import annotations

import json
import os

from .dataset import Dataset


def build(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    success = os.path.join(raw, "._SUCCESS")
    if not os.path.exists(success):
        raise FileNotFoundError(
            f"oagbert dataset {name!r}: place ._SUCCESS (candidate list) and "
            f"the *.jsonl sample files under {raw}")
    with open(success) as f:
        candidates = [line.strip() for line in f if line.strip()]
    samples = {}
    for fn in sorted(os.listdir(raw)):
        if not fn.endswith(".jsonl"):
            continue
        with open(os.path.join(raw, fn)) as f:
            samples[fn] = [json.loads(line) for line in f if line.strip()]
    ds = Dataset(name=name, metric="accuracy")
    ds.candidates = candidates
    ds.samples = samples
    return ds
