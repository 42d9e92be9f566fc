"""Knowledge-graph triple loader — the port of ``cogdl_tpu/datasets/kg.py``
(FB13, FB15k, FB15k-237, WN18, WN18RR): ``train.txt`` / ``valid.txt`` /
``test.txt`` of tab-separated ``head relation tail`` strings under
``<root>/raw``, with optional ``entities.dict`` / ``relations.dict``
(``id<TAB>name`` or ``name<TAB>id``). A name no dictionary holds takes
the next id in order of first appearance, over the three files in turn.
Returns KG triples (``Dataset.from_triples``), ``int32 [n, 3]`` a split.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .dataset import Dataset


def _read_dict(path: str) -> Dict[str, int]:
    d = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) == 2:
                idx, name = parts if parts[0].isdigit() else parts[::-1]
                d[name] = int(idx)
    return d


def build(name: str, root: str, **kwargs) -> Dataset:
    raw = os.path.join(root, "raw")
    files = ["train.txt", "valid.txt", "test.txt"]
    missing = [f for f in files if not os.path.exists(os.path.join(raw, f))]
    if missing:
        raise FileNotFoundError(
            f"KG dataset {name!r}: place {files} (tab-separated h r t) under "
            f"{raw}. Missing: {missing}. For offline testing use "
            "dataset='random-kg'.")
    ent2id: Dict[str, int] = {}
    rel2id: Dict[str, int] = {}
    for dict_name, target in (("entities.dict", ent2id),
                              ("relations.dict", rel2id)):
        p = os.path.join(raw, dict_name)
        if os.path.exists(p):
            target.update(_read_dict(p))

    def get_id(d: Dict[str, int], key: str) -> int:
        if key not in d:
            d[key] = len(d)
        return d[key]

    triples = {}
    for f in files:
        rows = []
        with open(os.path.join(raw, f)) as fh:
            for line in fh:
                parts = line.strip().split("\t")
                if len(parts) != 3:
                    continue
                h, r, t = parts
                rows.append((get_id(ent2id, h), get_id(rel2id, r),
                             get_id(ent2id, t)))
        triples[f.split(".")[0]] = np.asarray(rows, np.int32)
    triples["num_entities"] = len(ent2id)
    triples["num_relations"] = len(rel2id)
    return Dataset.from_triples(triples, name=name)
