"""Dataset registry — the port of ``cogdl_tpu/datasets/__init__.py`` for the
offline synthetic names. ``build_dataset(name)`` returns a
:class:`Dataset` holding one CPU graph, or for ``random-graphs`` a list of
small CPU graphs with their labels; the trainer (or, for a list, the graph
classification wrapper) moves them to the device.
"""

from __future__ import annotations

import re

from .dataset import Dataset

OFFLINE_NAMES = ("sbm | sbm-small | sbm-large | powerlaw-<N>[k|m] | "
                 "random-graphs")


def build_dataset(name: str, **kwargs) -> Dataset:
    """Resolve a synthetic dataset by name (``sbm``, ``sbm-large``,
    ``powerlaw-<N>[k|m]``, ``random-graphs``). Other names of the JAX
    registry are not yet ported and raise."""
    from . import synthetic as syn

    if name in ("sbm", "sbm-small"):
        return Dataset.from_graph(syn.sbm_graph(**kwargs), name=name)
    if name == "sbm-large":
        kwargs.setdefault("num_nodes", 4000)
        kwargs.setdefault("p_in", 0.02)
        kwargs.setdefault("p_out", 0.002)
        return Dataset.from_graph(syn.sbm_graph(**kwargs), name=name)
    m = re.fullmatch(r"powerlaw-(\d+)([km]?)", name)
    if m:
        n = int(m.group(1)) * {"": 1, "k": 1000, "m": 1000000}[m.group(2)]
        return Dataset.from_graph(syn.powerlaw_graph(n, **kwargs), name=name)
    if name == "random-graphs":
        graphs, labels = syn.random_graphs_dataset(**kwargs)
        return Dataset.from_graphs(graphs, labels=labels, name=name)
    raise ValueError(
        f"dataset {name!r} is not yet ported to cogdl_tpu_torch; offline "
        f"names: {OFFLINE_NAMES} (the rest wait in ROADMAP.md §1)")
