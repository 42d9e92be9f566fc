"""Dataset registry — the port of ``cogdl_tpu/datasets/__init__.py``:
the offline synthetic names and every loader of the JAX registry.
``build_dataset(name)`` returns a :class:`Dataset` holding one CPU graph,
a list of small CPU graphs with their labels (``random-graphs``, the TU
and OGB graph-property sets), a dict of KG triples (``random-kg``, the KG
sets) or, for the OAGBert evaluation sets, candidates and samples without
a graph; the trainer (or, for a list, the graph classification wrapper)
moves them to the device.

The loaders of :data:`SUPPORTED_DATASETS` read local files under
``$COGDL_TPU_DATA/<name>/raw`` (default ``~/.cogdl_tpu``), as the JAX
package's do, and raise ``FileNotFoundError`` with the files to place there;
nothing is downloaded. Users' own data goes through
``datasets.customized.NodeDataset`` / ``GraphDataset``.
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
    # planetoid (reference datasets/planetoid_data.py)
    "cora": "cogdl_tpu_torch.datasets.planetoid.build",
    "citeseer": "cogdl_tpu_torch.datasets.planetoid.build",
    "pubmed": "cogdl_tpu_torch.datasets.planetoid.build",
    # ogb node (reference datasets/ogb.py): the npy layout
    "ogbn-arxiv": "cogdl_tpu_torch.datasets.ogb.build_node",
    "ogbn-products": "cogdl_tpu_torch.datasets.ogb.build_node",
    "ogbn-proteins": "cogdl_tpu_torch.datasets.ogb.build_node",
    "ogbn-papers100M": "cogdl_tpu_torch.datasets.ogb.build_node",
    # ogb graph property (reference OGBGDataset)
    "ogbg-molbace": "cogdl_tpu_torch.datasets.ogb.build_graph",
    "ogbg-molhiv": "cogdl_tpu_torch.datasets.ogb.build_graph",
    "ogbg-molpcba": "cogdl_tpu_torch.datasets.ogb.build_graph",
    "ogbg-ppa": "cogdl_tpu_torch.datasets.ogb.build_graph",
    "ogbg-code": "cogdl_tpu_torch.datasets.ogb.build_graph",
    # ogb link property (reference OGBLDataset)
    "ogbl-ppa": "cogdl_tpu_torch.datasets.ogb.build_link",
    "ogbl-ddi": "cogdl_tpu_torch.datasets.ogb.build_link",
    "ogbl-collab": "cogdl_tpu_torch.datasets.ogb.build_link",
    "ogbl-citation2": "cogdl_tpu_torch.datasets.ogb.build_link",
    # saint-format npz (reference datasets/saint_data.py)
    "flickr": "cogdl_tpu_torch.datasets.saint.build",
    "reddit": "cogdl_tpu_torch.datasets.saint.build",
    "yelp": "cogdl_tpu_torch.datasets.saint.build",
    "ppi": "cogdl_tpu_torch.datasets.saint.build",
    "ppi-large": "cogdl_tpu_torch.datasets.saint.build",
    "amazon-s": "cogdl_tpu_torch.datasets.saint.build",
    # KG triples (reference datasets/kg_data.py)
    "fb15k": "cogdl_tpu_torch.datasets.kg.build",
    "fb15k237": "cogdl_tpu_torch.datasets.kg.build",
    "wn18": "cogdl_tpu_torch.datasets.kg.build",
    "wn18rr": "cogdl_tpu_torch.datasets.kg.build",
    "fb13": "cogdl_tpu_torch.datasets.kg.build",
    "fb13s": "cogdl_tpu_torch.datasets.kg.build",
    # TU graph classification (reference datasets/tu_data.py)
    "mutag": "cogdl_tpu_torch.datasets.tu.build",
    "proteins": "cogdl_tpu_torch.datasets.tu.build",
    "nci1": "cogdl_tpu_torch.datasets.tu.build",
    "nci109": "cogdl_tpu_torch.datasets.tu.build",
    "enzymes": "cogdl_tpu_torch.datasets.tu.build",
    "imdb-b": "cogdl_tpu_torch.datasets.tu.build",
    "imdb-m": "cogdl_tpu_torch.datasets.tu.build",
    "collab": "cogdl_tpu_torch.datasets.tu.build",
    "reddit-b": "cogdl_tpu_torch.datasets.tu.build",
    "reddit-multi-5k": "cogdl_tpu_torch.datasets.tu.build",
    "reddit-multi-12k": "cogdl_tpu_torch.datasets.tu.build",
    "ptc-mr": "cogdl_tpu_torch.datasets.tu.build",
    # matlab .mat embeddings benchmarks (reference datasets/matlab_matrix.py)
    "blogcatalog": "cogdl_tpu_torch.datasets.matlab.build",
    "wikipedia": "cogdl_tpu_torch.datasets.matlab.build",
    "ppi-ne": "cogdl_tpu_torch.datasets.matlab.build",
    "dblp-ne": "cogdl_tpu_torch.datasets.matlab.build",
    "flickr-ne": "cogdl_tpu_torch.datasets.matlab.build",
    "youtube-ne": "cogdl_tpu_torch.datasets.matlab.build",
    # geom-gcn heterophily (reference datasets/geom_data.py)
    "chameleon": "cogdl_tpu_torch.datasets.geom.build",
    "cornell": "cogdl_tpu_torch.datasets.geom.build",
    "film": "cogdl_tpu_torch.datasets.geom.build",
    "squirrel": "cogdl_tpu_torch.datasets.geom.build",
    "texas": "cogdl_tpu_torch.datasets.geom.build",
    "wisconsin": "cogdl_tpu_torch.datasets.geom.build",
    "cora_geom": "cogdl_tpu_torch.datasets.geom.build",
    "citeseer_geom": "cogdl_tpu_torch.datasets.geom.build",
    "pubmed_geom": "cogdl_tpu_torch.datasets.geom.build",
    # DGraphFin finance graph (reference examples/dgraph)
    "dgraphfin": "cogdl_tpu_torch.datasets.dgraphfin.build",
    # rd2cd collection (reference datasets/rd2cd_data.py)
    "Github": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Elliptic": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Film": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Wiki": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Clothing": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Electronics": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Dblp": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Yelpchi": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Alpha": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Weibo": "cogdl_tpu_torch.datasets.rd2cd.build",
    "bgp": "cogdl_tpu_torch.datasets.rd2cd.build",
    "ssn5": "cogdl_tpu_torch.datasets.rd2cd.build",
    "ssn7": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Aids": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Nba": "cogdl_tpu_torch.datasets.rd2cd.build",
    "Pokec_z": "cogdl_tpu_torch.datasets.rd2cd.build",
    # GRB robustness benchmark (reference datasets/grb_data.py)
    "grb-cora": "cogdl_tpu_torch.datasets.grb.build",
    "grb-citeseer": "cogdl_tpu_torch.datasets.grb.build",
    "grb-reddit": "cogdl_tpu_torch.datasets.grb.build",
    "grb-aminer": "cogdl_tpu_torch.datasets.grb.build",
    "grb-flickr": "cogdl_tpu_torch.datasets.grb.build",
    # heterogeneous GTN/HAN (reference datasets/gtn_data.py, han_data.py)
    "gtn-acm": "cogdl_tpu_torch.datasets.hetero.build_gtn",
    "gtn-dblp": "cogdl_tpu_torch.datasets.hetero.build_gtn",
    "gtn-imdb": "cogdl_tpu_torch.datasets.hetero.build_gtn",
    "han-acm": "cogdl_tpu_torch.datasets.hetero.build_han",
    "han-dblp": "cogdl_tpu_torch.datasets.hetero.build_han",
    "han-imdb": "cogdl_tpu_torch.datasets.hetero.build_han",
    # GCC pretraining/eval corpora (reference datasets/gcc_data.py)
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
    # recommendation (reference datasets/rec_data.py)
    "yelp2018": "cogdl_tpu_torch.datasets.rec.build",
    "ali": "cogdl_tpu_torch.datasets.rec.build",
    "amazon-rec": "cogdl_tpu_torch.datasets.rec.build",
    # PeMS traffic (reference datasets/stgcn_data.py, stgat_data.py)
    "pems-stgcn": "cogdl_tpu_torch.datasets.traffic_pems.build",
    "pems-stgat": "cogdl_tpu_torch.datasets.traffic_pems.build",
    # GATNE multiplex (reference datasets/gatne.py)
    "amazon": "cogdl_tpu_torch.datasets.gatne_data.build",
    "twitter": "cogdl_tpu_torch.datasets.gatne_data.build",
    "youtube": "cogdl_tpu_torch.datasets.gatne_data.build",
    # OAGBert zero-shot eval (reference datasets/oagbert_data.py)
    "l0fos": "cogdl_tpu_torch.datasets.oagbert_eval.build",
    "aff30": "cogdl_tpu_torch.datasets.oagbert_eval.build",
    "arxivvenue": "cogdl_tpu_torch.datasets.oagbert_eval.build",
}

OFFLINE_NAMES = ("sbm | sbm-small | sbm-large | powerlaw-<N>[k|m] | "
                 "random-graphs | traffic-synthetic | hetero-sbm | "
                 "rec-synthetic | random-kg")


def build_dataset(name: str, **kwargs) -> Dataset:
    """Resolve a dataset by name: the synthetic families (``sbm``,
    ``sbm-large``, ``powerlaw-<N>[k|m]``, ``random-graphs``,
    ``traffic-synthetic`` (metric ``mae``), ``hetero-sbm``,
    ``rec-synthetic``, ``random-kg``: KG triples, no graph) or a loader of
    :data:`SUPPORTED_DATASETS`; another name raises ``ValueError`` listing
    both."""
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
    try:
        path = SUPPORTED_DATASETS[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; registry: "
            f"{sorted(SUPPORTED_DATASETS)}, synthetic: {OFFLINE_NAMES}"
        ) from None
    module_path, fn_name = path.rsplit(".", 1)
    fn = getattr(importlib.import_module(module_path), fn_name)
    return fn(name, root=os.path.join(DATA_ROOT, name), **kwargs)
