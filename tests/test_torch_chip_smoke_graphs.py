"""CPU rehearsal of chip_smoke.py's phases for DisenGCN and SRGCN and for
graph classification (K1 over a union batch, GIN, SortPool and DiffPool
through ``experiment()``, parity and quality) at a tiny size, and a check
of the expected launch counts against the calls the same runs make to
K1's plain version on the CPU over the batches' structure."""

import collections

import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.configs import BEST_CONFIGS
from cogdl_tpu_torch.models import build_model
from cogdl_tpu_torch.wrappers.graph_classification import GraphClfWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}
# the NCI1-scale set cut to 40 graphs, in batches of 8
TINY_SET = dict(cs.GRAPH_SET, num_graphs=40)
TINY_BATCH = 8


def test_graph_kernel_check_phase_rehearsal():
    entries = cs.phase_graph_kernel_check(CPU, graph_set=TINY_SET,
                                          batch_size=TINY_BATCH, iters=1,
                                          feats=(8, 37))
    assert [e["name"] for e in entries] == [
        f"spmm_csr[{d},F={f},union batch]" for d in ("csr", "csc")
        for f in (8, 37)]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["bound_by"] == "bytes"
        assert e["err_over_tol"] == 0.0 and e["library_ms"] > 0
        assert e["case"][0] == "spmm_csr" and e["nnz"] > 0


def test_graph_batches_count_the_wrappers_batches():
    ds = cs.graph_dataset(tuple(sorted(TINY_SET.items())))
    w = GraphClfWrapper(build_model("gin", in_features=37, out_features=2),
                        ds, batch_size=TINY_BATCH)
    assert cs._graph_batches(len(ds), TINY_BATCH) == tuple(
        len(w._batches[s]) for s in ("train", "val", "test")) == (4, 1, 1)
    assert cs._graph_batches(4110, 128) == (23, 4, 7)


def test_graph_launches_expected_per_step_and_evaluation():
    """GIN at 5 layers: its first GIN layer sums the input (F=37, CSR
    only), three more at F=32; SortPool 3 at F=32; DiffPool F=64 and two
    at F=8 (assignment and A·S), each with its CSC on a step."""
    def one(model, steps, evals):
        return cs._graph_expected(model, cs.GRAPH_KW[model], steps, evals,
                                  True)

    assert one("gin", 1, 0) == {"spmm_csr": {
        ("csr", 37): 1, ("csr", 32): 3, ("csc", 32): 3}}
    assert one("gin", 0, 1) == {"spmm_csr": {("csr", 37): 1,
                                             ("csr", 32): 3}}
    assert one("sortpool", 1, 0) == {"spmm_csr": {("csr", 32): 3,
                                                  ("csc", 32): 3}}
    assert one("diffpool", 1, 0) == {"spmm_csr": {
        ("csr", 64): 1, ("csc", 64): 1, ("csr", 8): 2, ("csc", 8): 2}}
    assert one("diffpool", 0, 1) == {"spmm_csr": {("csr", 64): 1,
                                                  ("csr", 8): 2}}
    assert cs._graph_expected("gin", cs.GRAPH_KW["gin"], 5, 6, False) == {}


@pytest.mark.parametrize("model", sorted(cs.GRAPH_KW))
def test_graph_expected_counts_are_the_plain_versions_calls(monkeypatch,
                                                            model):
    """A run through ``experiment()`` on the CPU, where the wrapper builds
    every batch's structure as on the card, counting the calls K1's
    wrapper gets, by case: :func:`_graph_expected`'s launches for the
    run's train batches and evaluated batches."""
    calls = collections.Counter()
    real = cs.sk.spmm_csr

    def spmm_csr(ptr, col, w, x, structure="csr", **kw):
        calls[(structure, x.shape[1])] += 1
        return real(ptr, col, w, x, structure=structure, **kw)

    monkeypatch.setattr(cs.sk, "spmm_csr", spmm_csr)
    ds = cs.graph_dataset(tuple(sorted(TINY_SET.items())))
    cs.experiment(dataset=ds, model=model, use_best_config=True, epochs=1,
                  patience=2, batch_size=TINY_BATCH, seed=0, device="cpu",
                  **cs.GRAPH_KW[model])
    n_tr, n_va, n_te = cs._graph_batches(len(ds), TINY_BATCH)
    assert {"spmm_csr": dict(calls)} == cs._graph_expected(
        model, cs.GRAPH_KW[model], n_tr, 2 * (n_tr + n_va + n_te), True)


def test_graph_main_path_phase_rehearsal():
    info = cs.phase_graph_main_path(CPU, graph_set=TINY_SET,
                                    batch_size=TINY_BATCH, epochs=1,
                                    models=("gin", "diffpool"))
    assert info.pop("launches_by") == {"spmm_csr": {}}
    assert list(info) == ["gin", "diffpool"]
    for run in info.values():
        assert run["launches"] == {} and run["peak_hbm_bytes"] is None
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0
        assert (run["train_batches"], run["evaluated_batches"]) == (4, 6)
        # no card: the profiler window runs nothing
        assert run["profile"]["busy_ms"] is None
        assert run["profile"]["steps"] == 0


def test_graph_main_path_catches_a_launch_count_off(monkeypatch):
    real = GraphClfWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 32)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(GraphClfWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="graph-main sortpool"):
        cs.phase_graph_main_path(CPU, graph_set=TINY_SET,
                                 batch_size=TINY_BATCH, epochs=1,
                                 models=("sortpool",))
    cs.sk.reset_launch_counts()


def test_last_main_path_phase_rehearsal():
    info = cs.phase_last_main_path(CPU, num_nodes=200, epochs=1)
    assert info.pop("launches_by") == {}
    assert list(info) == ["disengcn", "srgcn"]
    for run in info.values():
        assert run["launches"] == {} and run["train_step_ms"] > 0


def test_graph_parity_phase_rehearsal():
    out = cs.phase_graph_parity(CPU, graph_set=TINY_SET,
                                batch_size=TINY_BATCH, num_nodes=200)
    assert out == {m: 0.0 for m in ("gin", "sortpool", "diffpool",
                                    "disengcn", "srgcn")}


def test_graph_quality_phase_rehearsal(monkeypatch):
    """SRGCN on sbm at the phase's own settings and bar; GIN's run on the
    tiny set over one seed at 3 epochs, its bar lowered to 0: the graph
    runs' bars hold only at the full settings, on the card."""
    accs = cs.phase_graph_quality(CPU, models=(), node_models=("srgcn",))
    assert accs["srgcn"] >= cs.LAST_JAX_SBM_ACC["srgcn"] - \
        cs.ZOO_QUALITY_MARGIN
    monkeypatch.setitem(cs.GRAPH_QUALITY_SEEDS, "gin", 1)
    monkeypatch.setitem(cs.GRAPH_JAX_ACC, "gin", 0.0)
    accs = cs.phase_graph_quality(CPU, models=("gin",), node_models=(),
                                  epochs=3, graph_set=TINY_SET,
                                  batch_size=TINY_BATCH)
    assert set(accs) == {"gin"} and 0.0 <= accs["gin"] <= 1.0


def test_graph_quality_holds_each_model_to_the_jax_packages_accuracy(
        monkeypatch):
    monkeypatch.setitem(cs.LAST_JAX_SBM_ACC, "srgcn", 1.03)
    with pytest.raises(AssertionError, match="srgcn"):
        cs.phase_graph_quality(CPU, models=(), node_models=("srgcn",),
                               epochs=5)


def test_graph_constants_name_every_model_of_the_slice():
    assert set(cs.GRAPH_JAX_ACC) == set(cs.GRAPH_KW) == set(
        cs.GRAPH_QUALITY_SEEDS) == {"gin", "sortpool", "diffpool"}
    assert set(cs.LAST_JAX_SBM_ACC) == {label for label, _, _ in
                                        cs.LAST_RUNS} == {"disengcn", "srgcn"}
    best = BEST_CONFIGS["gin"]["general"]
    assert {k: cs.GRAPH_KW["gin"][k] for k in ("hidden_size", "num_layers")
            } == {k: best[k] for k in ("hidden_size", "num_layers")}
    assert set(cs.GRAPH_FEATS) == {cs.GRAPH_SET["feat_dim"]} | {
        kw.get("hidden_size") for kw in cs.GRAPH_KW.values()} | {
        cs.GRAPH_KW["diffpool"]["num_clusters"]}
