"""CPU rehearsal of chip_smoke.py's recommendation and traffic phases
(rec-traffic-kernel, rec-main, traffic-main, rec-traffic-parity,
rec-traffic-quality) at a tiny size, and a check of the expected K1 and K3
launch counts against the calls the same runs make to the kernels' plain
versions on the CPU over the structures the wrappers build on the card."""

import collections

import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.models.nn.stgcn import TrafficModel
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from cogdl_tpu_torch.wrappers.traffic_prediction import (
    TrafficPredictionWrapper,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "device_ms"}
# the yelp2018-scale graph cut to 60 users and 40 items, the
# PeMSD7(M)-scale series to 10 stations and 80 steps in batches of 4
TINY_REC = {"num_users": 60, "num_items": 40, "avg_interactions": 6}
TINY_TRAFFIC = {"num_nodes": 10, "num_steps": 80}
TINY_WRAPPER = dict(cs.TRAFFIC_WRAPPER_KW, batch_size=4)


def test_the_cells_are_yelp2018_and_pemsd7_scale():
    """The rec graph of REC_SET has the node and edge counts the phases'
    records name; the series of TRAFFIC_SET gives 177 training batches
    of 50 and 75 evaluation batches."""
    g = cs.bipartite_rec_graph(**cs.REC_SET)
    assert (g.num_nodes, g.num_edges, g.n_pad, g.e_pad) == (
        69716, 2474230, 81920, 2621440)
    assert cs._traffic_batches(cs.TRAFFIC_SET["num_steps"],
                               **cs.TRAFFIC_WRAPPER_KW) == (177, 75)


def test_rec_traffic_kernel_check_phase_rehearsal():
    entries = cs.phase_rec_traffic_kernel_check(
        CPU, rec_set=TINY_REC, traffic_set=TINY_TRAFFIC, batch_size=4,
        iters=1)
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=64,rec]", "spmm_csr[csc,F=64,rec]",
        "spmm_csr[csr,F=16,stgcn]", "spmm_csr[csc,F=16,stgcn]"] + [
        f"gat_pass[{m},H=4,D=8,stgat]" for m in ("fwd", "dsd", "dsrc")]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["err_over_tol"] == 0.0
        assert (e["library_ms"] is None) == (e["case"][0] == "gat_pass")
        assert e["bound_ms"] > 0 and e["bound_by"] in ("bytes", "operations")
    # STGCN's first block's union: 4 × 10 copies of the padded road graph
    n_pad = cs.traffic_graph(**TINY_TRAFFIC).n_pad
    assert entries[2]["rows"] == entries[-1]["rows"] == 4 * 10 * n_pad
    assert entries[-1]["attn_drop"] == 0.0


def test_rec_traffic_launches_expected_per_step_and_evaluation():
    """At the card's widths: LightGCN three CSR and three CSC at 64 a
    step, three CSR an evaluation; STGCN two CSR and two CSC at 16 a step,
    two CSR an evaluation batch; STGAT K3's fwd, dsd and dsrc at (4, 8) a
    step, fwd an evaluation batch."""
    rec = cs.BEST_CONFIGS["lightgcn"]["general"]
    (_, gcn), (_, gat) = cs.TRAFFIC_RUNS
    assert cs._rec_traffic_expected("lightgcn", rec, 1, 1, True) == {
        "spmm_csr": {("csr", 64): 6, ("csc", 64): 3}}
    assert cs._rec_traffic_expected("stgcn", gcn, 1, 0, True) == {
        "spmm_csr": {("csr", 16): 2, ("csc", 16): 2}}
    assert cs._rec_traffic_expected("stgcn", gcn, 0, 1, True) == {
        "spmm_csr": {("csr", 16): 2}}
    assert cs._rec_traffic_expected("stgat", gat, 1, 1, True) == {
        "gat_pass": {("fwd", 4, 8): 2, ("dsd", 4, 8): 1, ("dsrc", 4, 8): 1}}
    assert cs._rec_traffic_expected("stgat", gat, 5, 6, False) == {}


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

    real_union = TrafficModel.build_union
    monkeypatch.setattr(cs.sk, "spmm_csr", spmm_csr)
    monkeypatch.setattr(cs.sk, "gat_pass", gat_pass)
    monkeypatch.setattr(NodeClfWrapper, "with_structure",
                        staticmethod(prepare_spmm))
    monkeypatch.setattr(TrafficModel, "build_union",
                        lambda self, graph, copies, structure=None:
                        real_union(self, graph, copies, True))
    return calls


@pytest.mark.parametrize("model", ["lightgcn", "stgcn", "stgat"])
def test_rec_traffic_expected_counts_are_the_plain_versions_calls(
        monkeypatch, model):
    """One epoch through ``experiment()`` on the CPU, the wrappers
    building the structures as on the card (LightGCN's over its graph, the
    traffic models' over their unions): the calls K1's and K3's wrappers
    get, by case, are :func:`_rec_traffic_expected`'s launches for the
    epoch's steps and two evaluations."""
    calls = _count_calls(monkeypatch)
    if model == "lightgcn":
        kw = cs.BEST_CONFIGS["lightgcn"]["general"]
        cs.experiment(dataset=cs.rec_dataset(TINY_REC), model=model,
                      use_best_config=True, epochs=1, patience=2, seed=0,
                      device="cpu")
        expected = cs._rec_traffic_expected(model, kw, 1, 2, True)
    else:
        kw = dict(cs.TRAFFIC_RUNS)[model]
        cs.experiment(dataset=cs.traffic_dataset(TINY_TRAFFIC), model=model,
                      use_best_config=True, epochs=1, patience=2, seed=0,
                      device="cpu", **TINY_WRAPPER, **kw)
        steps, evals = cs._traffic_batches(TINY_TRAFFIC["num_steps"],
                                           **TINY_WRAPPER)
        expected = cs._rec_traffic_expected(model, kw, steps, 2 * evals,
                                            True)
    got = collections.defaultdict(dict)
    for (kernel, *case), v in calls.items():
        got[kernel][tuple(case)] = v
    assert dict(got) == expected


def test_rec_main_phase_rehearsal():
    info = cs.phase_rec_main(CPU, rec_set=TINY_REC, epochs=1)
    assert info.pop("launches_by") == {}
    run = info["lightgcn"]
    assert run["launches"] == {} and run["peak_hbm_bytes"] is None
    assert run["train_step_ms"] > 0 and run["eval_ms"] > 0
    assert 0.0 <= run["test_recall"] <= 1.0 and 0.0 <= run["test_ndcg"] <= 1
    assert run["profile"]["busy_ms"] is None


def test_traffic_main_phase_rehearsal():
    info = cs.phase_traffic_main(CPU, traffic_set=TINY_TRAFFIC, epochs=1,
                                 wrapper_kw=TINY_WRAPPER)
    assert info.pop("launches_by") == {}
    assert list(info) == ["stgcn", "stgat"]
    steps, evals = cs._traffic_batches(TINY_TRAFFIC["num_steps"],
                                       **TINY_WRAPPER)
    for run in info.values():
        assert run["launches"] == {} and run["peak_hbm_bytes"] is None
        assert run["steps"] == steps and run["eval_batches"] == evals
        assert run["train_step_ms"] > 0 and run["test_mae"] > 0


@pytest.mark.parametrize("phase", ["rec", "traffic"])
def test_rec_traffic_main_catch_a_launch_count_off(monkeypatch, phase):
    from cogdl_tpu_torch.wrappers.recommendation import RecommendationWrapper
    from cogdl_tpu_torch.wrappers.traffic_prediction import (
        TrafficPredictionWrapper,
    )

    cls = RecommendationWrapper if phase == "rec" else TrafficPredictionWrapper
    real = cls.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 16)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(cls, "loss", loss_and_count)
    with pytest.raises(AssertionError, match=f"{phase}-main .* launched"):
        if phase == "rec":
            cs.phase_rec_main(CPU, rec_set=TINY_REC, epochs=1)
        else:
            cs.phase_traffic_main(CPU, traffic_set=TINY_TRAFFIC, epochs=1,
                                  wrapper_kw=TINY_WRAPPER)
    cs.sk.reset_launch_counts()


def test_rec_traffic_parity_phase_rehearsal():
    out = cs.phase_rec_traffic_parity(CPU)
    assert set(out) == {"lightgcn", "stgcn", "stgat"}
    for rec in out.values():
        assert rec["max_abs_diff"] == 0.0 and rec["max_abs"] > 0
        assert rec["loss_diff"] == 0.0
        assert all(d == 0.0 for d in rec["metric_diff"].values())
    assert out["lightgcn"]["users_differing"] == 0
    assert set(out["stgcn"]["metric_diff"]) == {"val_mae", "val_rmse",
                                                "test_mae", "test_rmse"}


def test_rec_traffic_parity_catches_a_second_device_off(monkeypatch):
    """The check fails when the second run's embeddings move off the
    first's by more than the bound."""
    calls = collections.Counter()
    real = cs._rec_view

    def off_on_second(ds, device, kw):
        out = real(ds, device, kw)
        calls["n"] += 1
        if calls["n"] == 2:
            out = (out[0] + 1e-2,) + out[1:]
        return out

    monkeypatch.setattr(cs, "_rec_view", off_on_second)
    with pytest.raises(AssertionError, match="lightgcn"):
        cs.phase_rec_traffic_parity(CPU, runs=())


def test_rec_traffic_quality_phase_rehearsal(monkeypatch):
    """A short run of each on the CPU against bars that cannot fail; the
    phase raises when a recall falls below, or an MAE rises above, the
    JAX package's by more than the margin."""
    kw = dict(seeds=1, override={"epochs": 1, "eval_step": 1})
    # this torch's initial weights: the card's reference holds torch
    # 2.11.0's, whose truncated normal draws other numbers
    monkeypatch.setattr(cs, "REC_TRAFFIC_INIT_SUMSQ", {
        label: cs.initial_sum_of_squares(label)
        for label in cs.REC_TRAFFIC_INIT_SUMSQ})
    monkeypatch.setattr(cs, "REC_TRAFFIC_JAX_SCORE",
                        {"lightgcn": 0.0, "stgcn": 10.0, "stgat": 10.0})
    scores = cs.phase_rec_traffic_quality(CPU, **kw)
    assert set(scores) == {"lightgcn", "stgcn", "stgat"}
    assert 0.0 <= scores["lightgcn"] <= 1.0
    assert 0.0 < scores["stgcn"] < 10.0 and 0.0 < scores["stgat"] < 10.0
    for label, bar in (("lightgcn", 2.0), ("stgcn", 0.0)):
        monkeypatch.setattr(cs, "REC_TRAFFIC_JAX_SCORE",
                            {"lightgcn": 0.0, "stgcn": 10.0, "stgat": 10.0,
                             label: bar})
        with pytest.raises(AssertionError, match=label):
            cs.phase_rec_traffic_quality(CPU, runs=(label,), **kw)


def test_rec_traffic_quality_bar_names_every_run():
    assert set(cs.REC_TRAFFIC_JAX_SCORE) == set(cs.REC_TRAFFIC_QUALITY_RUNS)


def test_rec_traffic_quality_refuses_other_initial_weights(monkeypatch):
    """A traffic run whose initial weights are not those its JAX reference
    started from raises before it trains."""
    monkeypatch.setattr(cs, "REC_TRAFFIC_INIT_SUMSQ", {
        "stgat": cs.initial_sum_of_squares("stgat") * (1 + 1e-5)})
    with pytest.raises(AssertionError, match="compute the reference again"):
        cs.phase_rec_traffic_quality(CPU, runs=("stgat",), seeds=1)


@pytest.mark.parametrize("label", ["stgcn", "stgat"])
def test_quality_initial_weights_are_the_trainers(monkeypatch, label):
    """``quality_initial_weights`` gives the weights ``experiment()``
    starts the quality run's seed from, exactly."""
    dataset, model, kw, *_ = cs.REC_TRAFFIC_QUALITY_RUNS[label]
    seen = []
    real = TrafficPredictionWrapper.init

    def record(self, generator, graph):
        real(self, generator, graph)
        seen.append({k: p.detach().clone()
                     for k, p in self.model.named_parameters()})

    monkeypatch.setattr(TrafficPredictionWrapper, "init", record)
    cs.experiment(dataset=dataset, model=model, seed=3, device="cpu",
                  **dict(kw, epochs=1, eval_step=1))
    (want,) = seen
    got = cs.quality_initial_weights(label, [3])[3]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(torch.from_numpy(got[k]), want[k]), k

