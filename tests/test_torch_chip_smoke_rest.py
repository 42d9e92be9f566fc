"""CPU rehearsal of chip_smoke.py's phases for the rest of the full-batch
zoo at a tiny size, and a check of their expected launch counts against
the calls the same runs make to K1's and K3's plain versions on the CPU
over the kernels' structure."""

import collections

import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.ops import cuda as ops_cuda
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}
# shallower versions of the runs, for the CPU
SHALLOW = {"revgcn": {"num_layers": 2}, "revgat": {"num_layers": 2},
           "revgen": {"num_layers": 2}, "grand": {"order": 3}}


def _shallow_runs(labels=None):
    return tuple((label, m, dict(kw, **SHALLOW.get(label, {})))
                 for label, m, kw in cs.REST_RUNS
                 if labels is None or label in labels)


def test_rest_kernel_check_phase_rehearsal():
    entries = cs.phase_rest_kernel_check(CPU, num_nodes=300, iters=1)
    assert [e["name"] for e in entries] == [
        f"gat_pass[{m},H=2,D=32]" for m in ("fwd", "dsd", "dsrc")] + [
        "spmm_csr[csr,F=64,live weights]"]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["bound_by"] == "bytes"
    live = entries[-1]
    assert live["case"] == ["spmm_csr", "csr", 64]
    assert live["library_ms"] > 0 and live["reweight_ms"] > 0
    assert max(live["err_over_tol"].values()) <= 1.0


def test_rest_kernel_check_catches_k1_reading_stale_weights(monkeypatch):
    """With the structure's weights left as ``prepare_spmm`` built them (the
    fault the live-weights check exists for), the phase fails."""
    monkeypatch.setattr(ops_cuda, "reweighted_structure",
                        lambda graph: graph.extras)
    with pytest.raises(AssertionError, match="live weights"):
        cs.phase_rest_kernel_check(CPU, num_nodes=300, iters=1,
                                   gat_shapes=())


def test_rest_launches_expected_per_step_and_evaluation():
    """Per train step and evaluation at the runs' widths (F_in 100, 47
    classes): SIGN 3 CSR at F=100; GRAND 8; DropEdge CSR and CSC at F=64
    x3 and F=47; RevGCN 32 CSR and 16 CSC at F=64 (the checkpoint's
    recompute), 16 CSR an evaluation; RevGAT K3 fwd 32, dsd 16, dsrc 16 at
    (2, 32); PPRGo CSR and CSC at F=47; RobustGCN 2 and 2 at each width;
    AutoGNN-GAT K3 at (8, 8) and (1, 47); RevGEN nothing."""
    def one(label, steps, evals):
        (model, kw), = [(m, kw) for lb, m, kw in cs.REST_RUNS if lb == label]
        return cs._rest_expected(model, kw, steps, evals, True)

    assert one("sign", 1, 0) == one("sign", 0, 1) == {
        "spmm_csr": {("csr", 100): 3}}
    assert one("grand", 1, 0) == {"spmm_csr": {("csr", 100): 8}}
    assert one("dropedge_gcn", 1, 0) == {"spmm_csr": {
        ("csr", 64): 3, ("csc", 64): 3, ("csr", 47): 1, ("csc", 47): 1}}
    assert one("revgcn", 1, 0) == {"spmm_csr": {("csr", 64): 32,
                                                ("csc", 64): 16}}
    assert one("revgcn", 0, 1) == {"spmm_csr": {("csr", 64): 16}}
    assert one("revgat", 1, 0) == {"gat_pass": {
        ("fwd", 2, 32): 32, ("dsd", 2, 32): 16, ("dsrc", 2, 32): 16}}
    assert one("revgat", 0, 1) == {"gat_pass": {("fwd", 2, 32): 16}}
    assert one("pprgo", 1, 0) == {"spmm_csr": {("csr", 47): 1,
                                               ("csc", 47): 1}}
    assert one("robustgcn", 1, 0) == {"spmm_csr": {
        ("csr", 64): 2, ("csc", 64): 2, ("csr", 47): 2, ("csc", 47): 2}}
    for label in ("moe_gcn", "gnnguard_gcn", "gdc_gcn", "actgcn", "autognn"):
        assert one(label, 1, 0) == {"spmm_csr": {
            ("csr", 64): 1, ("csc", 64): 1, ("csr", 47): 1,
            ("csc", 47): 1}}, label
        assert one(label, 0, 1) == {"spmm_csr": {("csr", 64): 1,
                                                 ("csr", 47): 1}}, label
    assert one("autognn-gat", 1, 0) == {"gat_pass": {
        (m, h, d): 1 for m in ("fwd", "dsd", "dsrc")
        for h, d in ((8, 8), (1, 47))}}
    assert one("revgen", 1, 1) == {}
    assert cs._rest_expected("revgcn", cs.REST_KW["revgcn"], 5, 6,
                             False) == {}


def test_rest_expected_counts_are_the_plain_versions_calls(monkeypatch):
    """The runs through ``experiment()`` on the CPU over the kernels'
    structure (which the card's wrapper builds), counting the calls K1's
    and K3's wrappers get, by case: they are :func:`_rest_expected`'s
    launches for one step and two evaluations, the checkpoint's recompute
    and the in-forward reweights included."""
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
    g = powerlaw_graph(120, avg_degree=6, feat_dim=cs.FEAT_DIM,
                       num_classes=cs.NUM_CLASSES, seed=0)
    ds = Dataset.from_graph(g, name="powerlaw-120")
    for label, model, kw in _shallow_runs():
        calls.clear()
        experiment(dataset=ds, model=model, use_best_config=True, epochs=1,
                   patience=2, seed=0, device="cpu", **kw)
        got = collections.defaultdict(dict)
        for (kernel, *case), v in calls.items():
            got[kernel][tuple(case)] = v
        assert dict(got) == cs._rest_expected(model, kw, 1, 2, True), label


def test_rest_main_path_phase_rehearsal():
    runs = _shallow_runs(("sign", "revgcn", "robustgcn", "autognn-gat"))
    info = cs.phase_rest_main_path(CPU, num_nodes=200, epochs=1, runs=runs)
    assert info.pop("launches_by") == {}
    assert list(info) == [label for label, _, _ in runs]
    for run in info.values():
        assert run["launches"] == {} and run["peak_hbm_bytes"] is None
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0


def test_rest_main_path_catches_a_launch_count_off(monkeypatch):
    real = NodeClfWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 64)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(NodeClfWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="rest-main sign"):
        cs.phase_rest_main_path(CPU, num_nodes=200, epochs=1,
                                runs=_shallow_runs(("sign",)))
    cs.sk.reset_launch_counts()


def test_rest_parity_and_quality_phase_rehearsal():
    runs = _shallow_runs(("dropedge_gcn", "gnnguard_gcn", "revgat"))
    assert set(cs.phase_rest_parity(CPU, num_nodes=200,
                                    runs=runs).values()) == {0.0}
    accs = cs.phase_rest_quality(CPU, models=("pprgo",))
    assert all(a >= cs.REST_JAX_SBM_ACC[m] - cs.ZOO_QUALITY_MARGIN
               for m, a in accs.items())


def test_rest_quality_holds_each_model_to_the_jax_packages_accuracy(
        monkeypatch):
    monkeypatch.setitem(cs.REST_JAX_SBM_ACC, "sign", 1.03)
    with pytest.raises(AssertionError, match="sign"):
        cs.phase_rest_quality(CPU, models=("sign",), epochs=5)


def test_rest_constants_name_every_model_of_the_slice():
    assert set(cs.REST_JAX_SBM_ACC) == set(cs.REST_KW)
    assert set(cs.REST_QUALITY_KW) <= set(cs.REST_KW)
    assert set(cs.REST_QUALITY_SEEDS) <= set(cs.REST_KW)
    assert [m for _, m, _ in cs.REST_RUNS] == list(cs.REST_KW) + ["autognn"]
