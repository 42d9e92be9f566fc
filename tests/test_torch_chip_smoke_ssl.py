"""CPU rehearsal of chip_smoke.py's self-supervised phases (ssl-main,
ssl-parity, ssl-quality) at a tiny size, and a check of the expected K1
launch counts against the calls the same runs make to K1's plain version
on the CPU over the structure the wrappers build on the card."""

import collections

import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
TINY_NODES = 300
TINY_GRAPH_SET = dict(cs.GRAPH_SET, num_graphs=40, max_nodes=20)


def test_ssl_launches_expected_per_step_and_evaluation():
    """At the card's widths: DGI 2 K1 over the CSR and 2 over the CSC at
    F=512 a step, 1 an evaluation; MVGRL twice that; GRACE 4 and 4 at
    F=128, 2 an evaluation; GraphMAE 2 and 2 at F=256 and its decoder at
    F=100; GraphMAE2 4 CSR (2 of them the teacher's) and 2 CSC at F=256
    and 3 decodes at F=100; BGRL 8 CSR (4 the teacher's) and 4 CSC;
    self-auxiliary GCN the supervised forward and ``embed`` again;
    InfoGraph a batch: the input sum at F=37 without a CSC, two layers at
    F=32; unsupervised GraphSAGE none."""
    def one(model, kw, steps, evals, feat=cs.FEAT_DIM):
        return cs._ssl_expected(model, kw, steps, evals, True, feat)

    h512, h256 = {"hidden_size": 512}, {"hidden_size": 256}
    assert one("dgi", h512, 1, 0) == {"spmm_csr": {("csr", 512): 2,
                                                   ("csc", 512): 2}}
    assert one("dgi", h512, 0, 1) == {"spmm_csr": {("csr", 512): 1}}
    assert one("mvgrl", h512, 1, 1) == {"spmm_csr": {("csr", 512): 6,
                                                     ("csc", 512): 4}}
    assert one("grace", cs.SSL_GRACE_KW, 1, 1) == {
        "spmm_csr": {("csr", 128): 6, ("csc", 128): 4}}
    assert one("graphmae", h256, 1, 0) == {"spmm_csr": {
        ("csr", 256): 2, ("csc", 256): 2, ("csr", 100): 1, ("csc", 100): 1}}
    assert one("graphmae2", h256, 1, 0) == {"spmm_csr": {
        ("csr", 256): 4, ("csc", 256): 2, ("csr", 100): 3, ("csc", 100): 3}}
    assert one("graphmae2", h256, 0, 1) == {"spmm_csr": {("csr", 256): 2}}
    assert one("bgrl", h256, 1, 0) == {"spmm_csr": {("csr", 256): 8,
                                                    ("csc", 256): 4}}
    assert one("gcn", {"hidden_size": 64}, 1, 1) == {"spmm_csr": {
        ("csr", 64): 3, ("csc", 64): 2, ("csr", 47): 2, ("csc", 47): 1}}
    assert one("infograph", cs.SSL_INFOGRAPH_KW, 1, 1, 37) == {
        "spmm_csr": {("csr", 37): 2, ("csr", 32): 4, ("csc", 32): 2}}
    assert one("unsup_graphsage", {"hidden_size": 64}, 5, 6) == {}
    assert cs._ssl_expected("dgi", h512, 5, 6, False) == {}


RUNS = list(cs.SSL_RUNS) + [("grace", "grace", cs.SSL_GRACE_KW)]
# the phases' runs at hidden 16: at the card's 512 the probe's fit over
# the tiny graph's 30 train nodes takes a thousand LBFGS iterations
SMALL_RUNS = [(label, model, dict(kw, hidden_size=16))
              for label, model, kw in cs.SSL_RUNS]


@pytest.mark.parametrize("label,model,kw", RUNS, ids=[r[0] for r in RUNS])
def test_ssl_expected_counts_are_the_plain_versions_calls(
        monkeypatch, label, model, kw):
    """One epoch through ``experiment()`` on the CPU, the wrapper building
    the structure as on the card: the calls K1's wrapper gets, by case,
    are :func:`_ssl_expected`'s launches for one step and two
    evaluations."""
    calls = _count_calls(monkeypatch)
    g = cs.powerlaw_graph(TINY_NODES, avg_degree=5, feat_dim=cs.FEAT_DIM,
                          num_classes=cs.NUM_CLASSES, seed=0)
    cs.experiment(dataset=cs.Dataset.from_graph(g), model=model,
                  use_best_config=True, epochs=1, patience=2, seed=0,
                  device="cpu", **kw)
    assert {k: dict(v) for k, v in calls.items()} == cs._ssl_expected(
        model, cs._ssl_model_kw(kw), 1, 2, True)


def _count_calls(monkeypatch):
    calls = collections.defaultdict(collections.Counter)
    real = cs.sk.spmm_csr

    def spmm_csr(ptr, col, w, x, structure="csr", **k):
        calls["spmm_csr"][(structure, x.shape[1])] += 1
        return real(ptr, col, w, x, structure=structure, **k)

    monkeypatch.setattr(cs.sk, "spmm_csr", spmm_csr)
    monkeypatch.setattr(NodeClfWrapper, "with_structure",
                        staticmethod(prepare_spmm))
    return calls


def test_infograph_expected_counts_are_the_plain_versions_calls(monkeypatch):
    """The wrapper builds each batch's structure on the host on every
    device, so the CPU run calls K1's plain version as the card's launches
    K1."""
    calls = _count_calls(monkeypatch)
    ds = cs.graph_dataset(tuple(sorted(TINY_GRAPH_SET.items())))
    n_tr, n_va, n_te = cs._graph_batches(len(ds), 8)
    cs.experiment(dataset=ds, model="infograph", epochs=1, patience=2,
                  seed=0, device="cpu", batch_size=8, **cs.SSL_INFOGRAPH_KW)
    assert {k: dict(v) for k, v in calls.items()} == cs._ssl_expected(
        "infograph", cs.SSL_INFOGRAPH_KW, n_tr, 2 * (n_tr + n_va + n_te),
        True, ds.num_features)


def test_ssl_main_phase_rehearsal():
    info = cs.phase_ssl_main(CPU, num_nodes=TINY_NODES, epochs=1,
                             runs=SMALL_RUNS, grace_nodes=200,
                             graph_set=TINY_GRAPH_SET, batch_size=16,
                             graph_epochs=1, iters=1)
    assert info.pop("launches_by") == {"spmm_csr": {}}
    entries = info.pop("entries")
    assert [e["case"] for e in entries] == [
        ["spmm_csr", "csr", 512], ["spmm_csr", "csc", 512],
        ["spmm_csr", "csc", 256]]
    assert all(e["err_over_tol"] == 0.0 for e in entries)
    probe = info.pop("probe_profile")
    assert probe["busy_ms"] is None and probe["probe_iters"] > 0
    assert probe["probe_ms"] > 0 and probe["width"] == 512
    assert list(info) == [r[0] for r in RUNS] + ["infograph"]
    for label, run in info.items():
        assert run["launches"] == {} and run["peak_hbm_bytes"] is None
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0
        assert run["probe_ms"] is not None or label == "self_auxiliary"
        assert run["profile"]["busy_ms"] is None
    assert info["dgi"]["probe_iters"] > 0
    assert info["infograph"]["graphs"] == 40


def test_ssl_main_catches_a_launch_count_off(monkeypatch):
    from cogdl_tpu_torch.wrappers.self_supervised import DGIWrapper

    real = DGIWrapper.loss_at

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 16)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(DGIWrapper, "loss_at", loss_and_count)
    with pytest.raises(AssertionError, match="ssl-main dgi"):
        cs.phase_ssl_main(CPU, num_nodes=TINY_NODES, epochs=1,
                          runs=SMALL_RUNS[:1], grace_nodes=200,
                          graph_set=TINY_GRAPH_SET, batch_size=16,
                          graph_epochs=1, iters=1)
    cs.sk.reset_launch_counts()


def test_ssl_parity_phase_rehearsal():
    out = cs.phase_ssl_parity(CPU, num_nodes=TINY_NODES, runs=SMALL_RUNS,
                              graph_set=TINY_GRAPH_SET, batch_size=16)
    assert list(out) == [r[0] for r in RUNS] + ["infograph"]
    for label, rec in out.items():
        assert rec["max_abs_diff"] == 0.0, label
        if label != "infograph":
            assert rec["loss_diff"] == 0.0 and rec["acc_diff"] == 0.0
    assert out["infograph"]["fold_acc"][0] == out["infograph"]["fold_acc"][1]


def test_ssl_parity_holds_the_card_to_the_cpu(monkeypatch):
    """The second view (the card's on the card) with features scaled by
    1 + 1e-2: the embeddings differ by about 1e-2 of their largest, the
    phase fails."""
    real = cs._ssl_views
    calls = []

    def views(model, kw, net, g, device):
        calls.append(device)
        if len(calls) % 2 == 0:
            g = g.replace(x=g.x * (1.0 + 1e-2))
        return real(model, kw, net, g, device)

    monkeypatch.setattr(cs, "_ssl_views", views)
    with pytest.raises(AssertionError, match="dgi"):
        cs.phase_ssl_parity(CPU, num_nodes=TINY_NODES, runs=SMALL_RUNS[:1],
                            graph_set=TINY_GRAPH_SET, batch_size=16)


def test_ssl_quality_phase_rehearsal(monkeypatch):
    """DGI and BGRL at the phase's own settings against their bars; the self-auxiliary edge mask and InfoGraph at 3 epochs and one
    seed, their bars lowered to 0: the bars hold at the full settings."""
    accs = cs.phase_ssl_quality(CPU, runs=("dgi", "bgrl"))
    for m in ("dgi", "bgrl"):
        assert accs[m] >= cs.SSL_JAX_ACC[m] - cs.ZOO_QUALITY_MARGIN
    for m in ("self_auxiliary-edgemask", "infograph"):
        monkeypatch.setitem(cs.SSL_JAX_ACC, m, 0.0)
    accs = cs.phase_ssl_quality(CPU, runs=("self_auxiliary-edgemask",
                                           "infograph"), epochs=3, seeds=1)
    assert all(0.0 <= a <= 1.0 for a in accs.values())


def test_ssl_quality_holds_each_run_to_the_jax_packages_accuracy(
        monkeypatch):
    monkeypatch.setitem(cs.SSL_JAX_ACC, "graphmae", 1.03)
    with pytest.raises(AssertionError, match="graphmae"):
        cs.phase_ssl_quality(CPU, runs=("graphmae",), epochs=2, seeds=1)


def test_ssl_constants_name_every_run_of_the_slice():
    names = {"dgi", "mvgrl", "grace", "graphmae", "graphmae2", "bgrl",
             "unsup_graphsage", "infograph"}
    assert {m for _, m, _ in RUNS} | {"infograph"} == names | {"gcn"}
    assert set(cs.SSL_JAX_ACC) == set(cs.SSL_QUALITY_RUNS) == set(
        cs.SSL_QUALITY_SEEDS)
    assert {m for m, _ in cs.SSL_QUALITY_RUNS.values()} == names | {"gcn"}
    assert all(0.5 < a <= 1.0 for a in cs.SSL_JAX_ACC.values())
    from cogdl_tpu_torch.configs import BEST_CONFIGS

    for _, m, kw in RUNS:
        best = BEST_CONFIGS.get(m, {}).get("general", {})
        if "hidden_size" in best:
            assert kw["hidden_size"] == best["hidden_size"], m
