"""CPU rehearsal of chip_smoke.py's phases for the file loaders, the
registry and ``pipeline()`` (loaders-main, loaders-kernel,
loaders-parity, loaders-quality) at a tiny size: the sets' writers at
their published scales, the round trip from the writer's files through
both packages' loaders, the launches the phases expect against the calls
K1's and K3's wrappers get on the CPU, and each phase's checks.

Run as a script, it computes the JAX package's reference for
``chip_smoke.LOADER_JAX_ACC``: the mean test accuracy over seeds 0 to
``SEEDS - 1`` of the run of ``LOADER_QUALITY_RUNS[SET]`` through the JAX
package's ``train`` on the CPU, the JAX loader reading the files the
script writes::

    PYTHONPATH=. python tests/test_torch_chip_smoke_loaders.py SET SEEDS
"""

import collections
import sys
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)
from test_torch_loaders import assert_same_dataset

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "device_ms"}
TINY = {"ogbn-arxiv": {"num_nodes": 600, "num_edges": 3000, "feat_dim": 16,
                       "num_classes": 5, "split": (300, 100, 200)},
        "flickr": {"num_nodes": 500, "num_edges": 3000, "feat_dim": 20,
                   "num_classes": 4, "split": (0.5, 0.25, 0.25)},
        "pubmed": {"num_nodes": 700, "num_edges": 1500, "feat_dim": 30,
                   "num_classes": 3, "split": (12, 500, 150),
                   "active_feats": 6},
        "chameleon": {"num_nodes": 300, "num_edges": 2000, "feat_dim": 40,
                      "num_classes": 5, "active_feats": 6},
        "nci1": {"num_graphs": 80, "avg_nodes": 12, "avg_edges": 13,
                 "node_labels": 10},
        "fb15k237": {"num_entities": 200, "num_relations": 10,
                     "splits": (1000, 100, 100)}}
TINY_REC = {"num_users": 60, "num_items": 80, "avg_interactions": 5}
TINY_BATCH = 16


def _arrays(name, scale):
    return cs.loader_arrays(name, tuple(sorted(scale.items())))


@pytest.fixture
def fresh_arrays():
    """The generated sets are dropped after the test: at their published
    scales they hold about half a gigabyte."""
    yield
    cs.loader_arrays.cache_clear()


def test_the_sets_are_at_their_published_scales(fresh_arrays):
    """The counts of ogbn-arxiv, Flickr, PubMed, chameleon, NCI1 and
    FB15k-237, the same arrays again from the seed."""
    s = cs.LOADER_SETS
    arxiv = _arrays("ogbn-arxiv", s["ogbn-arxiv"])
    ei = arxiv["edge_index"]
    n = s["ogbn-arxiv"]["num_nodes"]
    assert ei.shape == (2, 1166243) and arxiv["x"].shape == (n, 128)
    assert np.unique(ei[0] * n + ei[1]).size == 1166243
    assert [ids.size for ids in arxiv["split"]] == [90941, 29799, 48603]
    assert np.unique(arxiv["y"]).size == 40
    flickr = _arrays("flickr", s["flickr"])
    assert flickr["expect_keys"].size == 899756
    assert flickr["x"].shape == (89250, 500)
    assert [ids.size for ids in flickr["split"]] == [44625, 22312, 22313]
    pubmed = _arrays("pubmed", s["pubmed"])
    assert pubmed["a"].size == 44338 and (pubmed["a"] < pubmed["b"]).all()
    assert pubmed["x"].shape == (19717, 500)
    assert pubmed["test_index"].size == 1000
    assert [int(m.sum()) for m in pubmed["expect_masks"]] == [60, 500, 1000]
    cham = _arrays("chameleon", s["chameleon"])
    assert cham["a"].size == 36101 and cham["x"].shape == (2277, 2325)
    assert set(np.unique(cham["x"])) == {0.0, 1.0}
    nci1 = _arrays("nci1", s["nci1"])
    assert nci1["sizes"].size == 4110
    assert abs(nci1["sizes"].mean() - 29.87) < 0.3
    assert abs(nci1["edge_counts"].mean() / 2 - 32.30) < 0.5
    assert np.unique(nci1["node_labels"]).size == 37
    assert 0.3 < nci1["glabels"].mean() < 0.7
    kg = _arrays("fb15k237", s["fb15k237"])
    assert kg["h"].size == 272115 + 17535 + 20466
    assert np.unique(np.r_[kg["h"], kg["t"]]).size == 14541
    assert np.unique(kg["r"]).size == 237
    again = cs.loader_arrays.__wrapped__(
        "chameleon", tuple(sorted(s["chameleon"].items())))
    np.testing.assert_array_equal(again["x"], cham["x"])
    np.testing.assert_array_equal(again["a"], cham["a"])


def test_the_written_files_read_back_through_both_loaders(monkeypatch):
    """Each set at a tiny scale read by the port's loader equals the
    writer's arrays after the loader's transforms (``check_loaded``), the
    JAX package's loader reads the same dataset from the files, and the
    files are written and read once a process."""
    import cogdl_tpu.datasets as jds
    from cogdl_tpu_torch import datasets as tds

    root = tds.DATA_ROOT
    for name, (ds, arrays, write_s, parse_s) in cs._loaded(TINY).items():
        assert write_s > 0 and parse_s > 0
        assert cs.check_loaded(name, ds, arrays, TINY[name])
        files = cs.written_set(name, tuple(sorted(TINY[name].items())))[0]
        monkeypatch.setattr(jds, "DATA_ROOT", files)
        assert_same_dataset(jds.build_dataset(name), ds)
        assert cs._loaded({name: TINY[name]})[name][0] is ds
    assert tds.DATA_ROOT == root


def test_check_loaded_catches_a_changed_array():
    ds, arrays, _, _ = cs._loaded({"chameleon": TINY["chameleon"]})[
        "chameleon"]
    bad = dict(arrays, y=arrays["y"] + 1)
    with pytest.raises(AssertionError, match="chameleon: y differs"):
        cs.check_loaded("chameleon", ds, bad, TINY["chameleon"])


def test_loader_expected_counts():
    """GCN: CSR and CSC at 64 and the class count a step, the CSRs an
    evaluation; GAT: K3's three modes at (8, 8) and (1, classes) a step,
    fwd an evaluation; GIN: graph-main's formula; none on the CPU."""
    assert cs._loader_expected("gcn", 40, 128, 1, 2, True) == {
        "spmm_csr": {("csr", 64): 3, ("csr", 40): 3, ("csc", 64): 1,
                     ("csc", 40): 1}}
    assert cs._loader_expected("gat", 5, 2325, 1, 2, True) == {
        "gat_pass": {("fwd", 8, 8): 3, ("dsd", 8, 8): 1, ("dsrc", 8, 8): 1,
                     ("fwd", 1, 5): 3, ("dsd", 1, 5): 1, ("dsrc", 1, 5): 1}}
    assert cs._loader_expected("gin", 2, 37, 2, 3, True) == \
        cs._graph_expected("gin", cs.GRAPH_KW["gin"], 2, 3, True, 37)
    assert cs._loader_expected("gcn", 40, 128, 5, 6, False) == {}
    assert cs._rec_pipeline_expected(3, True) == {"spmm_csr": {
        ("csr", 64): 2 * 8, ("csc", 64): 2 * 3}}
    assert cs._rec_pipeline_expected(3, False) == {}


def _count_calls(monkeypatch):
    calls = collections.Counter()
    real_spmm, real_gat = cs.sk.spmm_csr, cs.sk.gat_pass

    def spmm_csr(ptr, col, w, x, structure="csr", **kw):
        calls[("spmm_csr", structure, x.shape[1])] += 1
        return real_spmm(ptr, col, w, x, structure=structure, **kw)

    def gat_pass(mode, ptr, idx, orig, sd, ss, smax, h2, *a, **kw):
        H = sd.shape[1]
        calls[("gat_pass", mode, H, h2.shape[1] // H)] += 1
        return real_gat(mode, ptr, idx, orig, sd, ss, smax, h2, *a, **kw)

    monkeypatch.setattr(cs.sk, "spmm_csr", spmm_csr)
    monkeypatch.setattr(cs.sk, "gat_pass", gat_pass)
    monkeypatch.setattr(NodeClfWrapper, "with_structure",
                        staticmethod(prepare_spmm))
    return calls


def _by_kernel(calls):
    got = collections.defaultdict(dict)
    for (kernel, *case), v in calls.items():
        got[kernel][tuple(case)] = v
    return dict(got)


@pytest.mark.parametrize("name,model", [("ogbn-arxiv", "gcn"),
                                        ("chameleon", "gat"),
                                        ("nci1", "gin")])
def test_loader_expected_counts_are_the_plain_versions_calls(
        monkeypatch, name, model):
    """One epoch through ``experiment()`` on the CPU, the wrappers building
    the structures as on the card: the calls K1's and K3's wrappers get,
    by case, are :func:`_loader_expected`'s launches for the epoch's steps
    and two evaluations."""
    calls = _count_calls(monkeypatch)
    ds = cs._loaded({name: TINY[name]})[name][0]
    kw = {"batch_size": TINY_BATCH} if model == "gin" else {}
    cs.experiment(dataset=ds, model=model, use_best_config=True, epochs=1,
                  patience=2, seed=0, device="cpu", **kw)
    if model == "gin":
        n_tr, n_va, n_te = cs._graph_batches(len(ds), TINY_BATCH)
        steps, evals = n_tr, 2 * (n_tr + n_va + n_te)
    else:
        steps, evals = 1, 2
    assert _by_kernel(calls) == cs._loader_expected(
        model, ds.num_classes, ds.num_features, steps, evals, True)


def test_pipeline_expected_counts_are_the_plain_versions_calls(monkeypatch):
    """``recommendation`` for two epochs and one ``recommend`` call, and
    ProNE under ``generate-emb``: the K1 calls the phase expects on the
    card."""
    from cogdl_tpu_torch.pipelines import pipeline

    calls = _count_calls(monkeypatch)
    rec = pipeline("recommendation", device="cpu")(
        cs.rec_dataset(TINY_REC), epochs=2,
        num_layers=cs.LOADER_REC_LAYERS)
    rec(np.arange(10))
    assert _by_kernel(calls) == cs._rec_pipeline_expected(2, True)
    calls.clear()
    arrays = _arrays("ogbn-arxiv", TINY["ogbn-arxiv"])
    emb = pipeline("generate-emb", device="cpu")(
        edge_index=arrays["edge_index"], model="prone")
    assert emb.shape == (600, cs.LOADER_PRONE_FEAT)
    assert _by_kernel(calls) == {"spmm_csr": {
        ("csr", cs.LOADER_PRONE_FEAT): cs.LOADER_PRONE_STEP + 1}}


def test_loaders_main_phase_rehearsal():
    info = cs.phase_loaders_main(CPU, sets=TINY, epochs=1, rec_epochs=1,
                                 rec_set=TINY_REC, batch_size=TINY_BATCH)
    assert info.pop("launches_by") == {}
    for name, model in cs.LOADER_RUNS:
        run = info[name]
        assert run["model"] == model and run["launches"] == {}
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0
        assert run["parse_s"] > 0 and run["peak_hbm_bytes"] is None
    assert info["fb15k237"]["arrays"]["triples"] == 1200
    rows = info["dataset_stats"]["rows"]
    assert [r["dataset"] for r in rows] == [n for n in TINY
                                            if n != "fb15k237"]
    assert info["generate_emb"]["shape"] == [600, cs.LOADER_PRONE_FEAT]
    assert info["recommendation"]["top_shape"] == [100, 10]
    assert info["dataset_visual"]["frontier"] > 0


def test_loaders_main_catches_a_launch_count_off(monkeypatch):
    real = NodeClfWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 64)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(NodeClfWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="gcn on pubmed"):
        cs.phase_loaders_main(CPU, sets={"pubmed": TINY["pubmed"]},
                              epochs=1)
    cs.sk.reset_launch_counts()


def test_loaders_kernel_phase_rehearsal():
    entries = cs.phase_loaders_kernel(
        CPU, sets={k: TINY[k] for k in ("ogbn-arxiv", "flickr",
                                        "chameleon")}, iters=1)
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=64,ogbn-arxiv]", "spmm_csr[csc,F=64,ogbn-arxiv]",
        "spmm_csr[csr,F=64,flickr]", "spmm_csr[csc,F=64,flickr]",
        "gat_pass[fwd,H=8,D=8,chameleon]", "gat_pass[dsd,H=8,D=8,chameleon]",
        "gat_pass[dsrc,H=8,D=8,chameleon]"]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["err_over_tol"] == 0.0
        assert e["bound_by"] in ("bytes", "operations")
    # GCN's structure: the undirected edges and a self loop a node
    keys = _arrays("ogbn-arxiv", TINY["ogbn-arxiv"])["expect_keys"]
    assert entries[0]["nnz"] == entries[1]["nnz"] == keys.size + 600


def test_loaders_parity_phase_rehearsal(monkeypatch):
    sets = {k: TINY[k] for k in ("pubmed", "chameleon")}
    errs = cs.phase_loaders_parity(CPU, sets=sets, epochs=1)
    assert errs == {"gcn on pubmed": 0.0, "gat on chameleon": 0.0}
    from cogdl_tpu_torch.datasets import planetoid

    real = planetoid.build

    def off(*a, **kw):
        ds = real(*a, **kw)
        ds.graph.x[0, 0] += 1.0
        return ds

    monkeypatch.setattr(planetoid, "build", off)
    cs.loader_dataset.cache_clear()
    try:
        with pytest.raises(AssertionError, match="pubmed: x differs"):
            cs.phase_loaders_parity(CPU, sets=sets, epochs=1)
    finally:
        cs.loader_dataset.cache_clear()


def test_loaders_quality_phase_rehearsal(monkeypatch):
    runs = {"pubmed": ("gcn", {"epochs": 3}),
            "nci1": ("gin", {"epochs": 1, "batch_size": TINY_BATCH})}
    sets = {k: TINY[k] for k in runs}
    monkeypatch.setattr(cs, "LOADER_JAX_ACC", {k: 0.0 for k in runs})
    accs = cs.phase_loaders_quality(CPU, sets=sets, seeds=2, runs=runs)
    assert set(accs) == set(runs) and all(0 <= a <= 1 for a in accs.values())
    monkeypatch.setattr(cs, "LOADER_JAX_ACC", {k: 1.5 for k in runs})
    with pytest.raises(AssertionError, match="below the JAX"):
        cs.phase_loaders_quality(CPU, sets=sets, seeds=1, runs=runs)


def test_every_quality_run_has_a_reference():
    assert set(cs.LOADER_JAX_ACC) == set(cs.LOADER_QUALITY_RUNS)
    assert all(0 < v <= 1 for v in cs.LOADER_JAX_ACC.values())


def quality_reference(name: str, seeds: int) -> float:
    """The JAX package's mean test accuracy of loaders-quality's run on
    ``name`` over seeds 0 to ``seeds - 1`` on the CPU, its loader reading
    the files the phase writes."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import cogdl_tpu.datasets as jds
    from cogdl_tpu.experiments import train

    model, kw = cs.LOADER_QUALITY_RUNS[name]
    with tempfile.TemporaryDirectory() as root:
        scale = cs.LOADER_SETS[name]
        items = tuple(sorted(scale.items()))
        cs.write_loader_set(root, name, cs.loader_arrays(name, items), items)
        jds.DATA_ROOT = root
        ds = jds.build_dataset(name)
        scores = [train(ds, model, seed=s, **kw)["test_acc"]
                  for s in range(seeds)]
    print(f"{model} on {name} seeds 0-{seeds - 1}: {scores}; mean "
          f"{float(np.mean(scores)):.6f}")
    return float(np.mean(scores))


if __name__ == "__main__":
    quality_reference(sys.argv[1], int(sys.argv[2]))
