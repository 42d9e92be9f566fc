"""CPU rehearsal of chip_smoke.py's phases for the heterogeneous family
(K1 and K3 over a metapath graph's structure, HAN, GTN, RGCN, CompGCN and
Simple-HGN through ``experiment()``, parity and quality) at a tiny size,
and a check of the expected launch counts against the calls the same runs
make to K1's and K3's plain versions on the CPU over the structure the
wrapper builds on the card."""

import collections

import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.configs import BEST_CONFIGS
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.wrappers.heterogeneous import HeterogeneousGNNWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "device_ms"}
# the ACM-scale set cut to 120 nodes and 12 features
TINY_SET = dict(cs.HETERO_SET, num_nodes=120, feat_dim=12)
TINY_COMPGCN = 100


def test_hetero_kernel_check_phase_rehearsal():
    entries = cs.phase_hetero_kernel_check(CPU, hetero_set=TINY_SET, iters=1)
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=12,metapath]", "spmm_csr[csc,F=12,metapath]"] + [
        f"gat_pass[{m},H=8,D=8,metapath]" for m in ("fwd", "dsd", "dsrc")]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["bound_by"] == "bytes"
        assert e["err_over_tol"] == 0.0 and e["nnz"] > 0
        assert (e["library_ms"] is None) == (e["case"][0] == "gat_pass")
    # the structure holds the real edges only: its longest row is no sink
    assert entries[0]["max_row_nnz"] < 40
    assert [e["case"] for e in entries] == [
        ["spmm_csr", "csr", 12], ["spmm_csr", "csc", 12]] + [
        ["gat_pass", m, 8, 8] for m in ("fwd", "dsd", "dsrc")]


def test_hetero_launches_expected_per_step_and_evaluation():
    """At the card's widths: HAN K3 fwd, dsd and dsrc at (8, 8) over each
    of the two metapath graphs a step, fwd over each an evaluation; GTN 8
    K1 over the CSR at F=1870 (2 channels x 2 layers x 2 relations) and 4
    over the CSC (the second layer's) a step, 8 over the CSR an
    evaluation; RGCN, CompGCN and Simple-HGN nothing."""
    def one(model, steps, evals):
        return cs._hetero_expected(model, cs.HETERO_KW[model], steps, evals,
                                   True)

    assert one("han", 1, 0) == {"gat_pass": {
        (m, 8, 8): 2 for m in ("fwd", "dsd", "dsrc")}}
    assert one("han", 0, 1) == {"gat_pass": {("fwd", 8, 8): 2}}
    assert one("gtn", 1, 0) == {"spmm_csr": {("csr", 1870): 8,
                                             ("csc", 1870): 4}}
    assert one("gtn", 0, 1) == {"spmm_csr": {("csr", 1870): 8}}
    for m in ("rgcn", "compgcn", "simple_hgn"):
        assert one(m, 1, 1) == {}
    assert one("han", 5, 6)["gat_pass"][("fwd", 8, 8)] == 22
    assert cs._hetero_expected("gtn", cs.HETERO_KW["gtn"], 5, 6,
                               False) == {}


@pytest.mark.parametrize("model", sorted(cs.HETERO_KW))
def test_hetero_expected_counts_are_the_plain_versions_calls(monkeypatch,
                                                             model):
    """A run through ``experiment()`` on the CPU, its wrapper building the
    metapath graphs' structure as on the card, counting the calls K1's and
    K3's wrappers get, by case: :func:`_hetero_expected`'s launches for one
    step and two evaluations."""
    calls = collections.defaultdict(collections.Counter)
    real_spmm, real_gat = cs.sk.spmm_csr, cs.sk.gat_pass

    def spmm_csr(ptr, col, w, x, structure="csr", **kw):
        calls["spmm_csr"][(structure, x.shape[1])] += 1
        return real_spmm(ptr, col, w, x, structure=structure, **kw)

    def gat_pass(mode, ptr, idx, orig, sd, ss, smax, h2, *a, **kw):
        calls["gat_pass"][(mode, sd.shape[1], h2.shape[1] // sd.shape[1])] \
            += 1
        return real_gat(mode, ptr, idx, orig, sd, ss, smax, h2, *a, **kw)

    monkeypatch.setattr(cs.sk, "spmm_csr", spmm_csr)
    monkeypatch.setattr(cs.sk, "gat_pass", gat_pass)
    monkeypatch.setattr(HeterogeneousGNNWrapper, "with_structure",
                        staticmethod(prepare_spmm))
    ds = cs.hetero_dataset(cs._hetero_items(TINY_SET))
    cs.experiment(dataset=ds, model=model, use_best_config=True, epochs=1,
                  patience=2, seed=0, device="cpu", **cs.HETERO_KW[model])
    assert {k: dict(v) for k, v in calls.items()} == cs._hetero_expected(
        model, cs.HETERO_KW[model], 1, 2, True, TINY_SET["feat_dim"],
        TINY_SET["num_metapaths"])


def test_hetero_main_path_phase_rehearsal():
    info = cs.phase_hetero_main_path(CPU, hetero_set=TINY_SET,
                                     compgcn_nodes=TINY_COMPGCN, epochs=1)
    assert info.pop("launches_by") == {}
    assert list(info) == list(cs.HETERO_KW)
    for model, run in info.items():
        assert run["launches"] == {} and run["peak_hbm_bytes"] is None
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0
        assert run["nodes"] == (TINY_COMPGCN if model == "compgcn" else 120)
        # no card: the profiler window runs nothing
        assert run["profile"]["busy_ms"] is None


def test_hetero_main_path_catches_a_launch_count_off(monkeypatch):
    real = HeterogeneousGNNWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 12)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(HeterogeneousGNNWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="hetero-main rgcn"):
        cs.phase_hetero_main_path(CPU, hetero_set=TINY_SET, epochs=1,
                                  models=("rgcn",))
    cs.sk.reset_launch_counts()


def test_hetero_parity_phase_rehearsal():
    out = cs.phase_hetero_parity(CPU, hetero_set=TINY_SET, num_nodes=90)
    assert list(out) == list(cs.HETERO_KW)
    for run in out.values():
        assert run["max_abs_diff"] == 0.0 and run["max_abs_logit"] > 0


def test_hetero_quality_phase_rehearsal(monkeypatch):
    """RGCN at the phase's own settings and bar; GTN over one seed at 3
    epochs, its bar lowered to 0: the bars hold at the full settings."""
    accs = cs.phase_hetero_quality(CPU, models=("rgcn",))
    assert accs["rgcn"] >= cs.HETERO_JAX_ACC["rgcn"] - cs.ZOO_QUALITY_MARGIN
    monkeypatch.setitem(cs.HETERO_JAX_ACC, "gtn", 0.0)
    accs = cs.phase_hetero_quality(CPU, models=("gtn",), seeds=1, epochs=3)
    assert set(accs) == {"gtn"} and 0.0 <= accs["gtn"] <= 1.0


def test_hetero_quality_holds_each_model_to_the_jax_packages_accuracy(
        monkeypatch):
    monkeypatch.setitem(cs.HETERO_JAX_ACC, "compgcn", 1.03)
    with pytest.raises(AssertionError, match="compgcn"):
        cs.phase_hetero_quality(CPU, models=("compgcn",), seeds=1, epochs=5)


def test_hetero_constants_name_every_model_of_the_slice():
    names = {"han", "gtn", "rgcn", "compgcn", "simple_hgn"}
    assert set(cs.HETERO_KW) == set(cs.HETERO_JAX_ACC) == names
    for m in ("han", "gtn", "simple_hgn"):
        best = BEST_CONFIGS[m]["general"]
        assert {k: v for k, v in cs.HETERO_KW[m].items() if k in best} == {
            k: best[k] for k in cs.HETERO_KW[m] if k in best}
    assert cs.HETERO_GAT_SHAPES == ((cs.HETERO_KW["han"]["nhead"],
                                     cs.HETERO_KW["han"]["hidden_size"]),)



def test_hetero_parity_holds_the_difference_to_the_largest_logit(
        monkeypatch):
    """The second forward (the card's on the card) over features scaled by
    1 + 1e-2 is off by about 1e-2 of the largest logit, beyond
    ``LOGIT_ATOL + LOGIT_RTOL·max|logits|``: the phase fails."""
    real = HeterogeneousGNNWrapper.prepare_graph
    calls = []

    def prepare(self, graph):
        calls.append(graph)
        if len(calls) % 2 == 0:
            graph = graph.replace(x=graph.x * (1.0 + 1e-2))
        return real(self, graph)

    monkeypatch.setattr(HeterogeneousGNNWrapper, "prepare_graph", prepare)
    with pytest.raises(AssertionError, match="rgcn logits differ"):
        cs.phase_hetero_parity(CPU, hetero_set=TINY_SET, num_nodes=90,
                               models=("rgcn",))
