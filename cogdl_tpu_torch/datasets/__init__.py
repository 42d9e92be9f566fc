"""Dataset registry — the port of ``cogdl_tpu/datasets/__init__.py`` for the
offline synthetic names and the heterogeneous, recommendation, PeMS,
MATLAB ``.mat``, GATNE and GCC loaders. ``build_dataset(name)`` returns a
:class:`Dataset` holding one CPU graph, for ``random-graphs`` a list of
small CPU graphs with their labels, or for ``random-kg`` a dict of
KG triples; the trainer (or, for a list, the graph classification wrapper)
moves them to the device.

The loaders of :data:`SUPPORTED_DATASETS` read local files under
``$COGDL_TPU_DATA/<name>/raw`` (default ``~/.cogdl_tpu``), as the JAX
package's do, and raise ``FileNotFoundError`` with the files to place there;
nothing is downloaded.
"""

from __future__ import annotations

import importlib
import os
import re
from typing import Dict

from .dataset import Dataset

DATA_ROOT = os.environ.get("COGDL_TPU_DATA",
                           os.path.expanduser("~/.cogdl_tpu"))

SUPPORTED_DATASETS: Dict[str, str] = {
    # heterogeneous GTN/HAN (reference datasets/gtn_data.py, han_data.py)
    "gtn-acm": "cogdl_tpu_torch.datasets.hetero.build_gtn",
    "gtn-dblp": "cogdl_tpu_torch.datasets.hetero.build_gtn",
    "gtn-imdb": "cogdl_tpu_torch.datasets.hetero.build_gtn",
    "han-acm": "cogdl_tpu_torch.datasets.hetero.build_han",
    "han-dblp": "cogdl_tpu_torch.datasets.hetero.build_han",
    "han-imdb": "cogdl_tpu_torch.datasets.hetero.build_han",
    # recommendation (reference datasets/rec_data.py)
    "yelp2018": "cogdl_tpu_torch.datasets.rec.build",
    "ali": "cogdl_tpu_torch.datasets.rec.build",
    "amazon-rec": "cogdl_tpu_torch.datasets.rec.build",
    # PeMS traffic (reference datasets/stgcn_data.py, stgat_data.py)
    "pems-stgcn": "cogdl_tpu_torch.datasets.traffic_pems.build",
    "pems-stgat": "cogdl_tpu_torch.datasets.traffic_pems.build",
    # MATLAB .mat networks of the embedding benchmarks (reference
    # datasets/matlab_matrix.py)
    "blogcatalog": "cogdl_tpu_torch.datasets.matlab.build",
    "wikipedia": "cogdl_tpu_torch.datasets.matlab.build",
    "ppi-ne": "cogdl_tpu_torch.datasets.matlab.build",
    "dblp-ne": "cogdl_tpu_torch.datasets.matlab.build",
    "flickr-ne": "cogdl_tpu_torch.datasets.matlab.build",
    "youtube-ne": "cogdl_tpu_torch.datasets.matlab.build",
    # GATNE multiplex (reference datasets/gatne.py)
    "amazon": "cogdl_tpu_torch.datasets.gatne_data.build",
    "twitter": "cogdl_tpu_torch.datasets.gatne_data.build",
    "youtube": "cogdl_tpu_torch.datasets.gatne_data.build",
    # GCC pretraining and evaluation corpora (reference
    # datasets/gcc_data.py)
    "usa-airport": "cogdl_tpu_torch.datasets.gcc.build_edgelist",
    "h-index": "cogdl_tpu_torch.datasets.gcc.build_edgelist",
    "gcc_academic": "cogdl_tpu_torch.datasets.gcc.build_edgelist",
    "gcc_dblp_netrep": "cogdl_tpu_torch.datasets.gcc.build_edgelist",
    "gcc_dblp_snap": "cogdl_tpu_torch.datasets.gcc.build_edgelist",
    "gcc_facebook": "cogdl_tpu_torch.datasets.gcc.build_edgelist",
    "gcc_imdb": "cogdl_tpu_torch.datasets.gcc.build_edgelist",
    "gcc_livejournal": "cogdl_tpu_torch.datasets.gcc.build_edgelist",
    "kdd_icdm": "cogdl_tpu_torch.datasets.gcc.build_paired",
    "sigir_cikm": "cogdl_tpu_torch.datasets.gcc.build_paired",
    "sigmod_icde": "cogdl_tpu_torch.datasets.gcc.build_paired",
}

OFFLINE_NAMES = ("sbm | sbm-small | sbm-large | powerlaw-<N>[k|m] | "
                 "random-graphs | traffic-synthetic | hetero-sbm | "
                 "rec-synthetic | random-kg")


def build_dataset(name: str, **kwargs) -> Dataset:
    """Resolve a dataset by name: the synthetic families (``sbm``,
    ``sbm-large``, ``powerlaw-<N>[k|m]``, ``random-graphs``,
    ``traffic-synthetic`` (metric ``mae``), ``hetero-sbm``,
    ``rec-synthetic``, ``random-kg``: KG triples, no graph) or a loader of
    :data:`SUPPORTED_DATASETS`. Other names of the JAX registry are not yet
    ported and raise."""
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
    if name == "traffic-synthetic":
        return Dataset.from_graph(syn.traffic_graph(**kwargs), name=name,
                                  metric="mae")
    if name == "hetero-sbm":
        return Dataset.from_graph(syn.hetero_sbm_graph(**kwargs), name=name)
    if name == "rec-synthetic":
        return Dataset.from_graph(syn.bipartite_rec_graph(**kwargs),
                                  name=name)
    if name == "random-kg":
        return Dataset.from_triples(syn.random_triples(**kwargs), name=name)
    if name in SUPPORTED_DATASETS:
        module_path, fn_name = SUPPORTED_DATASETS[name].rsplit(".", 1)
        fn = getattr(importlib.import_module(module_path), fn_name)
        return fn(name, root=os.path.join(DATA_ROOT, name), **kwargs)
    raise ValueError(
        f"dataset {name!r} is not yet ported to cogdl_tpu_torch; offline "
        f"names: {OFFLINE_NAMES}, loaders: {sorted(SUPPORTED_DATASETS)} "
        "(the rest wait in ROADMAP.md §1)")
