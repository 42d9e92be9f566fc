"""CPU rehearsal of chip_smoke.py's link-prediction, clustering and
knowledge-graph phases (link-kernel, link-main, kg-main, link-parity,
link-quality) at a tiny size, and a check of the expected K1 and K3 launch
counts against the calls the same runs make to the kernels' plain versions
on the CPU over the structure the wrappers build on the card."""

import collections

import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.configs import BEST_CONFIGS
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "device_ms"}
TINY_NODES = 300
# the FB15k-237-scale KG cut to 60 entities, 5 relations and 600 triples
TINY_KG = dict(cs.KG_SET, num_entities=60, num_relations=5, num_triples=600)
TINY_GNN = {"hidden_size": 16, "batch_size": 64}
TINY_KGE = {"hidden_size": 16, "gamma": 12.0, "negative_size": 8,
            "batch_size": 64}


def test_link_kernel_check_phase_rehearsal():
    entries = cs.phase_link_kernel_check(CPU, num_nodes=TINY_NODES, iters=1)
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=32]", "spmm_csr[csc,F=32]", "spmm_csr[csr,F=16]",
        "spmm_csr[csc,F=16]"] + [
        f"gat_pass[{m},H=1,D={d}]" for d in (256, 16)
        for m in ("fwd", "dsd", "dsrc")]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["err_over_tol"] == 0.0
        assert (e["library_ms"] is None) == (e["case"][0] == "gat_pass")
        assert e["bound_ms"] > 0 and e["bound_by"] in ("bytes", "operations")


def test_link_launches_expected_per_step_and_evaluation():
    """At the card's widths: GCN on link_prediction one CSR and one CSC at
    64 and at 47 a step, one CSR at each an evaluation; GAE at 32 and 16;
    VGAE 2 CSR and 2 CSC at 32, 4 and 4 at 16 a step (the KL's second
    encode), an evaluation both heads; AGC 8 CSR at F=100 a step and an
    evaluation, no CSC; DAEGC K3's three modes at (1, 256) and (1, 16) a
    step, fwd an evaluation."""
    def one(model, steps, evals):
        kw = dict(BEST_CONFIGS.get(model, {}).get("general", {}))
        return cs._link_expected(model, kw, steps, evals, True)

    assert one("gcn", 1, 1) == {"spmm_csr": {
        ("csr", 64): 2, ("csc", 64): 1, ("csr", 47): 2, ("csc", 47): 1}}
    assert one("gae", 1, 0) == {"spmm_csr": {
        ("csr", 32): 1, ("csc", 32): 1, ("csr", 16): 1, ("csc", 16): 1}}
    assert one("vgae", 1, 0) == {"spmm_csr": {
        ("csr", 32): 2, ("csc", 32): 2, ("csr", 16): 4, ("csc", 16): 4}}
    assert one("vgae", 0, 1) == {"spmm_csr": {("csr", 32): 1,
                                              ("csr", 16): 2}}
    assert one("agc", 1, 1) == {"spmm_csr": {("csr", 100): 16}}
    assert one("daegc", 1, 0) == {"gat_pass": {
        (m, 1, d): 1 for m in ("fwd", "dsd", "dsrc") for d in (256, 16)}}
    assert one("daegc", 0, 1) == {"gat_pass": {("fwd", 1, 256): 1,
                                               ("fwd", 1, 16): 1}}
    assert cs._link_expected("gae", {}, 5, 6, False) == {}


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


@pytest.mark.parametrize("label,model,kw", cs.LINK_RUNS,
                         ids=[r[0] for r in cs.LINK_RUNS])
def test_link_expected_counts_are_the_plain_versions_calls(
        monkeypatch, label, model, kw):
    """One epoch through ``experiment()`` on the CPU, the wrapper building
    the structure as on the card (on the link split's training graph for
    GCN): the calls K1's and K3's wrappers get, by case, are
    :func:`_link_expected`'s launches for one step and two
    evaluations."""
    calls = _count_calls(monkeypatch)
    g = cs.powerlaw_graph(TINY_NODES, avg_degree=5, feat_dim=cs.FEAT_DIM,
                          num_classes=cs.NUM_CLASSES, seed=0)
    cs.experiment(dataset=cs.Dataset.from_graph(g), model=model,
                  use_best_config=True, epochs=1, patience=2, seed=0,
                  device="cpu", **kw)
    got = collections.defaultdict(dict)
    for (kernel, *case), v in calls.items():
        got[kernel][tuple(case)] = v
    best = dict(BEST_CONFIGS.get(model, {}).get("general", {}), **kw)
    assert dict(got) == cs._link_expected(model, best, 1, 2, True)


def test_link_main_phase_rehearsal():
    info = cs.phase_link_main(CPU, num_nodes=TINY_NODES, epochs=1)
    assert info.pop("launches_by") == {}
    assert list(info) == [label for label, _, _ in cs.LINK_RUNS]
    for label, run in info.items():
        assert run["launches"] == {} and run["peak_hbm_bytes"] is None
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0
        assert run["profile"]["busy_ms"] is None
        score = run["test_auc" if label == "gcn-link" else "test_nmi"]
        assert 0.0 <= score <= 1.0


def test_link_main_catches_a_launch_count_off(monkeypatch):
    from cogdl_tpu_torch.wrappers.clustering import ClusteringWrapper

    real = ClusteringWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 16)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(ClusteringWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="link-main gae"):
        cs.phase_link_main(CPU, num_nodes=TINY_NODES, epochs=1,
                           runs=[r for r in cs.LINK_RUNS if r[0] == "gae"])
    cs.sk.reset_launch_counts()


def test_kg_set_is_fb15k237_scale():
    """The KG set's split sizes after the dedupe (the numbers the phase's
    records name)."""
    t = cs.random_triples(**cs.KG_SET)
    assert [len(t[k]) for k in ("train", "valid", "test")] == [
        241184, 30148, 30148]


def test_kg_main_phase_rehearsal():
    info = cs.phase_kg_main(CPU, kg_set=TINY_KG, epochs=1, gnn_kw=TINY_GNN,
                            kge_epochs=1, kge_kw=TINY_KGE)
    n = info.pop("triples")
    assert sum(n.values()) <= TINY_KG["num_triples"]
    assert list(info) == ["rgcn", "compgcn"] + list(cs.KGE_NAMES)
    for name, rec in info.items():
        assert rec["train_step_ms"] > 0 and rec["eval_ms"] > 0
        assert 0.0 < rec["test_mrr"] <= 1.0 and rec["peak_hbm_bytes"] is None
    assert info["rgcn"]["encodes_per_eval"] == sum(
        -(-2 * n[s] // 512) for s in ("valid", "test"))
    assert info["transe"]["steps"] == max(n["train"] // 64, 1)


def test_kg_main_catches_a_launch(monkeypatch):
    from cogdl_tpu_torch.wrappers.kg_link_prediction import (
        KGLinkPredictionWrapper,
    )

    real = KGLinkPredictionWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 16)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(KGLinkPredictionWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="kg-main rgcn launched"):
        cs.phase_kg_main(CPU, kg_set=TINY_KG, epochs=1, gnn_kw=TINY_GNN,
                         kge_epochs=1, kge_kw=TINY_KGE)
    cs.sk.reset_launch_counts()


def test_link_parity_phase_rehearsal():
    out = cs.phase_link_parity(CPU, num_nodes=TINY_NODES, kg_set=TINY_KG,
                               gnn_kw=TINY_GNN, kge_kw=TINY_KGE, kge_rows=8)
    assert set(out) == ({label for label, _, _ in cs.LINK_RUNS}
                        | {"kg-rgcn", "kg-compgcn"}
                        | {f"kge-{n}" for n in cs.KGE_NAMES})
    for rec in out.values():
        assert rec["max_abs_diff"] == 0.0 and rec["max_abs"] > 0
    assert out["gcn-link"]["auc_diff"] == 0.0
    for name in cs.KGE_NAMES:
        rec = out[f"kge-{name}"]
        assert rec["ok"] and rec["steps"] == cs.KGE_PARITY_STEPS
        assert rec["ranks"] == 16 and rec["ranks_unequal"] == 0
        assert rec["mrr"] == {"cpu": rec["mrr"]["cpu"]} and rec["moved"] > 0


@pytest.mark.parametrize("fault", ["tables", "ranks"])
def test_kge_parity_catches_a_second_device_off(monkeypatch, fault):
    """The triple embeddings' card-against-CPU check fails when the second
    run's trained tables move off the first's by more than the tolerance,
    or when a rank moves with no contender near the target's score."""
    from cogdl_tpu_torch.models.emb.knowledge_base import KGEModel

    calls = collections.Counter()
    real = getattr(KGEModel, {"tables": "train_triples",
                              "ranks": "ranks"}[fault])

    def off_on_second(self, *a, **kw):
        out = real(self, *a, **kw)
        calls[fault] += 1
        if calls[fault] == 2:
            if fault == "tables":
                self.params["ent"] = self.params["ent"] + 1e-2
            else:
                out = out.copy()
                out[3] += 5.0
        return out

    monkeypatch.setattr(KGEModel, {"tables": "train_triples",
                                   "ranks": "ranks"}[fault], off_on_second)
    t = cs.random_triples(**TINY_KG)
    rec = cs._kge_parity("distmult", t, TINY_KGE, 3, 8, CPU)
    assert not rec["ok"]
    if fault == "ranks":
        assert rec["ranks_unequal"] == 1 and rec["unexplained"] == [3]
    else:
        assert rec["max_abs_diff"] > 1e-3


def test_link_quality_phase_rehearsal(monkeypatch):
    """A short run of each kind on the CPU against a bar of 0; the phase
    raises when a score falls below the JAX package's less the margin."""
    kw = dict(runs=("gcn-link", "agc", "kg-rgcn", "kge-distmult"), seeds=1,
              override={"epochs": 2, "hidden_size": 8})
    monkeypatch.setattr(cs, "LINK_JAX_SCORE",
                        collections.defaultdict(float))
    scores = cs.phase_link_quality(CPU, **kw)
    assert set(scores) == {"gcn-link", "agc", "kg-rgcn", "kge-distmult"}
    assert all(0.0 < v <= 1.0 for v in scores.values())
    monkeypatch.setattr(cs, "LINK_JAX_SCORE",
                        collections.defaultdict(lambda: 2.0))
    with pytest.raises(AssertionError, match="link-quality"):
        cs.phase_link_quality(CPU, **kw)


def test_link_quality_bar_names_every_run():
    assert set(cs.LINK_JAX_SCORE) == set(cs.LINK_QUALITY_RUNS)
