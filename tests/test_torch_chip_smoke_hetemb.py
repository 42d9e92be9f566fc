"""CPU rehearsal of chip_smoke.py's phases for the heterogeneous and
graph-level embeddings and GCC (hetemb-kernel, hetemb-main, hetemb-parity,
hetemb-quality) at a tiny size, the generator of the Amazon-scale
multiplex network, and the K1 launches the phases expect against the
products the same runs make over the kernel's structure on the CPU.

Run as a script, it computes the JAX package's reference for
``chip_smoke.HETEMB_JAX_SCORE``: the mean score of ``MODEL`` over seeds
``FIRST`` (0 by default) to ``FIRST + SEEDS - 1`` through the JAX
package's ``train`` on the CPU, on the phase's set, at the phase's
settings (GCC on its numpy branch)::

    PYTHONPATH=. python tests/test_torch_chip_smoke_hetemb.py MODEL SEEDS [FIRST]
"""

import sys
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "device_ms"}
# the phases' sets cut to a tiny size
TINY_HETERO = dict(cs.HETERO_SET, num_nodes=150, feat_dim=8)
TINY_GRAPHS = dict(cs.GRAPH_SET, num_graphs=60, max_nodes=20, feat_dim=5)
TINY_AMAZON = {"num_nodes": 300, "num_edges": 1500, "num_types": 2}
TINY_NODES = 600
TINY_PROBE = {"num_nodes": 120, "num_edges": 360}
TINY_GCC = {"batch_size": 4, "subgraph_size": 8, "rw_hops": 16,
            "queue_size": 16, "batches_per_epoch": 2, "probe_nodes": 40}
TINY_KW = {"metapath2vec": {"walk_num": 2, "walk_length": 8},
           "hin2vec": {"walk_num": 1, "walk_length": 6, "batch_size": 512},
           "pte": {"num_samples": 4000},
           "gatne": {"walk_num": 2, "walk_length": 6},
           "graph2vec": {"dim_buckets": 128},
           "dgk": {"dim_buckets": 128}}


def test_the_multiplex_network_is_amazon_scale():
    """The counts of GATNE's Amazon, two edge types, 5 / 10% of the edges
    held out with as many negatives, and the same network from the
    seed."""
    net = cs.multiplex_network(**cs.GATNE_AMAZON)
    edges = sum((net[s][:, -1] == 1).sum() if s != "train" else len(net[s])
                for s in net)
    assert edges == cs.GATNE_AMAZON["num_edges"]
    for split, share in zip(("valid", "test"), cs.GATNE_HELD_OUT):
        pos = (net[split][:, 3] == 1).sum()
        assert (net[split][:, 3] == 0).sum() == pos
        assert abs(pos / edges - share) < 0.01
    assert set(np.unique(net["train"][:, 0])) == {0, 1}
    nodes = np.unique(net["train"][:, 1:])
    assert nodes.max() < cs.GATNE_AMAZON["num_nodes"]
    assert len(nodes) > 0.9 * cs.GATNE_AMAZON["num_nodes"]
    again = cs.multiplex_network(**cs.GATNE_AMAZON)
    for split in net:
        np.testing.assert_array_equal(net[split], again[split])


def test_the_written_files_read_back_through_the_loader():
    net = cs.multiplex_network(**TINY_AMAZON)
    with cs.gatne_dataset("amazon", TINY_AMAZON):
        ds = cs.build_dataset("amazon")
    assert ds.graph.num_edges == 2 * len(net["train"])
    pos, neg = ds.multiplex_eval[0]["test"]
    assert pos.shape[0] == 2 and pos.shape == neg.shape


def test_the_degree_quartile_network():
    """Four classes of equal size whose degrees rise class by class, a
    30 / 20 / 50% split, the edges in both directions, the same graph from
    the seed."""
    net = cs.degree_quartile_network(**cs.GCC_PROBE_SET)
    n = cs.GCC_PROBE_SET["num_nodes"]
    deg = np.bincount(net["edge_index"][0], minlength=n)
    y = net["y"]
    sizes = np.bincount(y)
    assert len(sizes) == 4 and sizes.max() - sizes.min() <= 1
    for c in range(3):
        assert deg[y == c].max() <= deg[y == c + 1].min()
    ei = net["edge_index"]
    assert ei.shape == (2, 2 * cs.GCC_PROBE_SET["num_edges"])
    assert set(zip(*ei.tolist())) == set(zip(*ei[::-1].tolist()))
    masks = [net[k] for k in ("train_mask", "val_mask", "test_mask")]
    assert (sum(m.astype(int) for m in masks) == 1).all()
    assert [m.sum() for m in masks[:2]] == [int(0.3 * n), int(0.2 * n)]
    again = cs.degree_quartile_network(**cs.GCC_PROBE_SET)
    np.testing.assert_array_equal(net["edge_index"], again["edge_index"])
    np.testing.assert_array_equal(net["y"], again["y"])


def test_gcc_launches_expected():
    """A step: the query encoder's five CSR sums and four CSC (its first
    layer's input carries no gradient), the key encoder's five CSR; an
    evaluation chunk five CSR."""
    assert cs._gcc_expected(12, 4, 8, True) == {"spmm_csr": {
        ("csr", 18): 2 * 12 + 4 * 8, ("csr", 64): 4 * (2 * 12 + 4 * 8),
        ("csc", 64): 4 * 12}}
    assert cs._gcc_expected(12, 4, 8, False) == {}


def test_hetemb_kernel_check_phase_rehearsal():
    entries = cs.phase_hetemb_kernel_check(CPU, num_nodes=TINY_NODES,
                                           iters=1)
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=18,GCC union]", "spmm_csr[csr,F=64,GCC union]",
        "spmm_csr[csc,F=18,GCC union]", "spmm_csr[csc,F=64,GCC union]"]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["err_over_tol"] == 0.0
        assert e["rows"] == 2 * 32 * 32 + 8
        assert e["union_edges"] == e["nnz"] > 0


def test_hetemb_main_phase_rehearsal(monkeypatch):
    """Every model through experiment() at tiny settings; GCC's products
    over the unions' K1 structure number as the phase expects on the card
    (the forwards a step and an evaluation chunk; the backward's CSC where
    the input takes a gradient)."""
    calls = []
    from cogdl_tpu_torch.layers import gin_layer

    agg = gin_layer.aggregate

    def counted(graph, x, how):
        calls.append(("spmm_fw_ptr" in (graph.extras or {}), x.shape[1],
                      x.requires_grad))
        return agg(graph, x, how)

    monkeypatch.setattr(gin_layer, "aggregate", counted)
    info = cs.phase_hetemb_main(CPU, hetero_set=TINY_HETERO,
                                graph_set=TINY_GRAPHS, amazon=TINY_AMAZON,
                                num_nodes=TINY_NODES, gcc_epochs=2,
                                model_kw=TINY_KW, gcc_kw=TINY_GCC)
    assert set(cs.HETEMB_MODELS) <= set(info)
    assert info["launches_by"] == {}
    for m in cs.HETEMB_HIN:
        assert 0 <= info[m]["test_acc"] <= 1 and info[m]["probe_ms"] > 0
    assert 0 <= info["gatne"]["test_auc"] <= 1
    assert info["gatne"]["stats"]["sgns_steps"] > 0
    for m in cs.HETEMB_GRAPH:
        assert {"wl_s", "factorize_s"} <= set(info[m]["stats"])
    g = info["gcc"]
    assert g["steps"] == 4 and g["evaluations"] == 3
    assert g["chunks_per_evaluation"] == 5
    assert g["profile"]["busy_ms"] is None
    # the GIN sums all read the structure; the card's launch count is one
    # a forward, plus a CSC backward where the input takes a gradient
    assert all(c[0] for c in calls)
    fwd = forwards_by_width(calls)
    exp = cs._gcc_expected(g["steps"], g["evaluations"],
                           g["chunks_per_evaluation"], True)["spmm_csr"]
    # the profiled step's two warm-up steps (on the CPU the profiler runs
    # no third)
    prof_steps = 2
    assert fwd[18] == exp[("csr", 18)] + 2 * prof_steps
    assert fwd[64] == exp[("csr", 64)] + 8 * prof_steps
    assert fwd["grad64"] == exp[("csc", 64)] + 4 * prof_steps
    assert set(info["scores"]) >= set(cs.HETEMB_MODELS) - {"gcc"}


def forwards_by_width(calls):
    """Forwards by width, and the forwards whose input takes a gradient
    at the hidden width (each a CSC backward on the card)."""
    out = {18: 0, 64: 0, "grad64": 0}
    for _, f, grad in calls:
        out[f] += 1
        if grad and f == 64:
            out["grad64"] += 1
    return out


def test_hetemb_parity_phase_rehearsal():
    errs = cs.phase_hetemb_parity(CPU, hetero_set=TINY_HETERO,
                                  graph_set=TINY_GRAPHS, amazon=TINY_AMAZON,
                                  num_nodes=TINY_NODES, graphs=40,
                                  gcc_kw=TINY_GCC,
                                  gcc_probe_set=TINY_PROBE)
    assert set(errs) == set(cs.HETEMB_MODELS) - {"gcc"} | {
        "gcc_loss", "gcc_queue", "gcc_embed", "gcc_probe"}
    assert all(v == 0.0 for v in errs.values()), errs


def test_hetemb_quality_phase_rehearsal(monkeypatch):
    models = ("pte", "dgk", "gcc")
    monkeypatch.setattr(cs, "HETEMB_JAX_SCORE", {m: 0.0 for m in models})
    kw = {"epochs": 1, "eval_step": 1, "probe_nodes": 30, **{
        k: v for k, v in TINY_GCC.items() if k != "probe_nodes"}}
    scores = cs.phase_hetemb_quality(
        CPU, hetero_set=TINY_HETERO, graph_set=TINY_GRAPHS,
        amazon=TINY_AMAZON, models=models, seeds=2, model_kw=TINY_KW,
        gcc_sbm={"num_nodes": 60}, gcc_kw=kw, first={"pte": 0.5})
    assert set(scores) == set(models)
    monkeypatch.setattr(cs, "HETEMB_JAX_SCORE", {m: 1.5 for m in models})
    with pytest.raises(AssertionError, match="below the JAX"):
        cs.phase_hetemb_quality(
            CPU, hetero_set=TINY_HETERO, graph_set=TINY_GRAPHS,
            amazon=TINY_AMAZON, models=("dgk",), model_kw=TINY_KW)


def test_every_model_has_a_quality_reference():
    assert set(cs.HETEMB_JAX_SCORE) == set(cs.HETEMB_MODELS)
    assert all(0 < v <= 1 for v in cs.HETEMB_JAX_SCORE.values())


def test_smoke_phases_reads_phase_specs_and_needs_a_card():
    """The phase timer's specs: a name, then tuple-valued keywords; with
    no card it runs nothing and exits 1."""
    from cogdl_tpu_torch.scripts import smoke_phases as sp

    assert sp.parse("emb_parity") == ("emb_parity", {})
    assert sp.parse("link_quality:runs=gae,kge-rotate;seeds=1") == (
        "link_quality", {"runs": ("gae", "kge-rotate"), "seeds": ("1",)})
    if not torch.cuda.is_available():
        assert sp.main([".", "emb_parity"]) == 1
    assert sp.main(["."]) == 2


def quality_reference(model: str, seeds: int, first: int = 0) -> float:
    """The JAX package's mean score of ``model`` over seeds ``first`` to
    ``first + seeds - 1`` on the CPU, on hetemb-quality's set and at its
    settings."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import cogdl_tpu.datasets as jdatasets
    import cogdl_tpu.native as jnative
    from cogdl_tpu.datasets.dataset import Dataset as JDataset
    from cogdl_tpu.datasets.synthetic import hetero_sbm_graph
    from cogdl_tpu.datasets.synthetic import random_graphs_dataset
    from cogdl_tpu.experiments import train

    kw, key = {"use_best_config": True}, "test_acc"
    with tempfile.TemporaryDirectory() as root:
        if model in cs.HETEMB_HIN:
            ds = JDataset.from_graph(hetero_sbm_graph(**cs.HETERO_SET),
                                     name="hetero-sbm")
        elif model in cs.HETEMB_GRAPH:
            graphs, labels = random_graphs_dataset(**cs.GRAPH_SET)
            ds = JDataset.from_graphs(graphs, labels=labels,
                                      name="random-graphs")
        elif model == "gatne":
            cs.write_multiplex(root, "amazon",
                               cs.multiplex_network(**cs.GATNE_AMAZON))
            jdatasets.DATA_ROOT = root
            ds, key = "amazon", "test_auc"
        else:
            jnative.available = lambda: False
            ds = jdatasets.build_dataset("sbm", **cs.GCC_QUALITY_SBM)
            kw.update(cs.GCC_QUALITY_KW)
        scores = [train(ds, model, seed=s, **kw)[key]
                  for s in range(first, first + seeds)]
    print(f"{model} seeds {first}-{first + seeds - 1}: {scores}; mean "
          f"{float(np.mean(scores)):.6f}")
    return float(np.mean(scores))


if __name__ == "__main__":
    quality_reference(sys.argv[1], int(sys.argv[2]),
                      int(sys.argv[3]) if len(sys.argv) > 3 else 0)
