"""CPU rehearsal of chip_smoke.py's phases for the node-classification
stragglers (Graph U-Net, GCNMix, SAGN, M3S, Correct & Smooth and
PATCHY-SAN through ``experiment()``, card-against-CPU parity and quality)
at a tiny size, and a check of the expected launch counts against the
calls the same runs make to K1's plain version on the CPU over the
structure the wrapper builds on the card."""

import collections

import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.configs import BEST_CONFIGS
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
TINY_NODES = 300
# graph-main's set cut to 40 graphs of at most 20 nodes
TINY_GRAPH_SET = dict(cs.GRAPH_SET, num_graphs=40, max_nodes=20)


def test_straggler_launches_expected_per_step_and_evaluation():
    """At the card's widths: Graph U-Net 5 K1 over the CSR and 5 over the
    CSC at F=64 a step, 5 over the CSR an evaluation; GCNMix one each at
    F=64 and F=47; SAGN 3 over the CSR at F=100 a step and an evaluation,
    no CSC, 3 more at stage 1's ``pre_stage``; M3S GCN's, and ``embed``'s
    one at F=64 at stage 1; C&S none a step and 100 at F=47 an
    evaluation; PATCHY-SAN none."""
    def one(model, steps, evals, stages=1):
        return cs._straggler_expected(model, cs.STRAGGLER_KW.get(
            model, cs.STRAGGLER_KW["graph_unet"]), steps, evals, True,
            stages)

    assert one("graph_unet", 1, 0) == {"spmm_csr": {("csr", 64): 5,
                                                    ("csc", 64): 5}}
    assert one("graph_unet", 0, 1) == one("unet", 0, 1) == {
        "spmm_csr": {("csr", 64): 5}}
    assert one("gcnmix", 1, 0) == {"spmm_csr": {
        ("csr", 64): 1, ("csc", 64): 1, ("csr", 47): 1, ("csc", 47): 1}}
    assert one("gcnmix", 0, 1) == {"spmm_csr": {("csr", 64): 1,
                                                ("csr", 47): 1}}
    assert one("sagn", 1, 0) == one("sagn", 0, 1) == {
        "spmm_csr": {("csr", 100): 3}}
    assert one("sagn", 0, 0, stages=2) == {"spmm_csr": {("csr", 100): 3}}
    assert one("m3s", 0, 0, stages=2) == {"spmm_csr": {("csr", 64): 1}}
    assert one("m3s", 1, 1) == {"spmm_csr": {
        ("csr", 64): 2, ("csc", 64): 1, ("csr", 47): 2, ("csc", 47): 1}}
    assert one("correct_smooth_mlp", 1, 0) == {}
    assert one("correct_smooth_mlp", 5, 6) == {"spmm_csr": {
        ("csr", 47): 600}}
    assert one("patchy_san", 3, 4) == {}
    # two stages of 5 epochs: 10 steps, 11 evaluations, one pre_stage
    assert one("sagn", 10, 11, stages=2)["spmm_csr"] == {("csr", 100): 66}
    assert cs._straggler_expected("gcnmix", cs.STRAGGLER_KW["gcnmix"], 5, 6,
                                  False) == {}


RUNS = [r for r in cs.STRAGGLER_RUNS if r[0] != "unet"]


@pytest.mark.parametrize("label,model,kw", RUNS, ids=[r[0] for r in RUNS])
def test_straggler_expected_counts_are_the_plain_versions_calls(
        monkeypatch, label, model, kw):
    """A run through ``experiment()`` on the CPU, the wrapper building the
    structure as on the card, counting the calls K1's wrapper gets, by
    case: :func:`_straggler_expected`'s launches for one epoch a stage
    (two stages for SAGN and M3S) and an evaluation each and at the
    end."""
    calls = collections.defaultdict(collections.Counter)
    real = cs.sk.spmm_csr

    def spmm_csr(ptr, col, w, x, structure="csr", **k):
        calls["spmm_csr"][(structure, x.shape[1])] += 1
        return real(ptr, col, w, x, structure=structure, **k)

    monkeypatch.setattr(cs.sk, "spmm_csr", spmm_csr)
    monkeypatch.setattr(NodeClfWrapper, "with_structure",
                        staticmethod(prepare_spmm))
    g = cs.powerlaw_graph(TINY_NODES, avg_degree=5, feat_dim=cs.FEAT_DIM,
                          num_classes=cs.NUM_CLASSES, seed=0)
    stages = cs.STRAGGLER_STAGES if model in cs.STAGED else 1
    extra = {"num_stages": stages} if stages > 1 else {}
    cs.experiment(dataset=cs.Dataset.from_graph(cs.held_out_split(g)),
                  model=model, use_best_config=True, epochs=1, patience=2,
                  seed=0, device="cpu", **kw, **extra)
    assert {k: dict(v) for k, v in calls.items()} == cs._straggler_expected(
        model, kw, stages, stages + 1, True, stages)


def test_held_out_split_leaves_a_third_of_the_rest_in_no_split():
    g = cs.powerlaw_graph(TINY_NODES, avg_degree=5, feat_dim=8, seed=0)
    h = cs.held_out_split(g)
    assert torch.equal(h.train_mask, g.train_mask)
    rest = int((~g.train_mask & g.node_mask()).sum())
    assert int(h.val_mask.sum()) == int(h.test_mask.sum()) == rest // 3
    none = ~(h.train_mask | h.val_mask | h.test_mask) & g.node_mask()
    assert int(none.sum()) == rest - 2 * (rest // 3)
    assert not (h.val_mask & h.test_mask).any()
    assert torch.equal(cs.held_out_split(g).val_mask, h.val_mask)


@pytest.fixture
def low_threshold(monkeypatch):
    """SAGN's threshold at 0 at this size: after one epoch over 300 nodes
    and 47 classes no softmax maximum reaches the card's 0.06."""
    monkeypatch.setattr(cs, "STRAGGLER_SAGN_THRESHOLD", 0.0)


def test_straggler_main_phase_rehearsal(low_threshold):
    info = cs.phase_straggler_main(CPU, num_nodes=TINY_NODES, epochs=1,
                                   graph_set=TINY_GRAPH_SET, patchy_epochs=1,
                                   iters=1)
    assert info.pop("launches_by") == {}
    (entry,) = info.pop("entries")
    assert entry["case"] == ["spmm_csr", "csr", cs.FEAT_DIM]
    assert entry["err_over_tol"] == 0.0 and entry["bound_by"] == "bytes"
    assert list(info) == [r[0] for r in cs.STRAGGLER_RUNS] + ["patchy_san"]
    for label, run in info.items():
        assert run["launches"] == {} and run["peak_hbm_bytes"] is None
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0
        # no card: the profiler window runs nothing
        assert run["profile"]["busy_ms"] is None
    assert info["unet"]["epochs"] == 1
    for m in cs.STAGED:
        assert info[m]["stages"] == 2 and set(info[m]["stage_record"]) == {1}
    assert info["sagn"]["stage_record"][1]["pseudo_labels"] > 0
    assert info["m3s"]["stage_record"][1]["new_labels"] > 0
    assert info["m3s"]["stage_record"][1]["kmeans_s"] > 0
    assert len(info["graph_unet"]["kept"]) == 2
    assert info["graph_unet"]["kept"][0] == TINY_NODES // 2
    assert info["correct_smooth_mlp"]["eval_launches"] == 0
    assert info["patchy_san"]["train_batch"][1:] == [16, 8, 37]


def test_straggler_main_catches_a_launch_count_off(monkeypatch):
    real = NodeClfWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 64)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(NodeClfWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="straggler-main graph_unet"):
        cs.phase_straggler_main(CPU, num_nodes=TINY_NODES, epochs=1,
                                runs=cs.STRAGGLER_RUNS[:1])
    cs.sk.reset_launch_counts()


def test_straggler_main_needs_a_later_stage_to_add_labels(monkeypatch):
    """SAGN at a threshold no softmax maximum exceeds takes no
    pseudo-label: the phase fails rather than time a stage that did
    nothing."""
    monkeypatch.setattr(cs, "STRAGGLER_SAGN_THRESHOLD", 1.0)
    with pytest.raises(AssertionError, match="sagn: a later stage added"):
        cs.phase_straggler_main(CPU, num_nodes=TINY_NODES, epochs=1,
                                runs=[r for r in cs.STRAGGLER_RUNS
                                      if r[0] == "sagn"])


def test_straggler_parity_phase_rehearsal():
    out = cs.phase_straggler_parity(CPU, num_nodes=TINY_NODES,
                                    graph_set=TINY_GRAPH_SET,
                                    patchy_graphs=16)
    assert list(out) == list(cs.STRAGGLER_KW) + ["patchy_san"]
    for run in out.values():
        assert run["max_abs_diff"] == 0.0 and run["max_abs_out"] > 0
    unet = out["graph_unet"]
    assert unet["keep_equal"] == [True, True]
    assert unet["kept"][0] == TINY_NODES // 2 and unet["min_margin"] > 0
    assert unet["max_score_diff"] == 0.0
    assert out["patchy_san"]["graphs"] == 16


def test_keep_margin_is_the_gap_below_the_threshold():
    score = torch.tensor([3.0, 1.0, 2.0, 0.5, -1e30])
    assert cs._keep_margin(score, 2.0, 4) == 1.0
    assert cs._keep_margin(score, 0.5, 4) == float("inf")


def test_straggler_parity_holds_the_difference_to_the_largest_output(
        monkeypatch):
    """The second forward (the card's on the card) over features scaled by
    1 + 1e-2: C&S's smoothed output off by about 1e-2 of its largest, the
    phase fails."""
    real = NodeClfWrapper.prepare_graph
    calls = []

    def prepare(self, graph):
        calls.append(graph)
        if len(calls) % 2 == 0:
            graph = graph.replace(x=graph.x * (1.0 + 1e-2))
        return real(self, graph)

    monkeypatch.setattr(NodeClfWrapper, "prepare_graph", prepare)
    with pytest.raises(AssertionError, match="correct_smooth_mlp"):
        cs.phase_straggler_parity(CPU, num_nodes=TINY_NODES,
                                  models=("correct_smooth_mlp",),
                                  graph_set=TINY_GRAPH_SET, patchy_graphs=4)


def test_straggler_quality_phase_rehearsal(monkeypatch):
    """Graph U-Net at the phase's own settings and bar; GCNMix, SAGN and
    PATCHY-SAN over one seed at 3 epochs, their bars lowered to 0: the
    bars hold at the full settings."""
    accs = cs.phase_straggler_quality(CPU, models=("graph_unet",))
    assert accs["graph_unet"] >= (cs.STRAGGLER_JAX_ACC["graph_unet"]
                                  - cs.ZOO_QUALITY_MARGIN)
    for m in ("gcnmix", "sagn", "patchy_san"):
        monkeypatch.setitem(cs.STRAGGLER_JAX_ACC, m, 0.0)
    accs = cs.phase_straggler_quality(CPU, models=("gcnmix", "sagn",
                                                   "patchy_san"),
                                      epochs=3, seeds=1)
    assert all(0.0 <= a <= 1.0 for a in accs.values())


def test_straggler_quality_holds_each_model_to_the_jax_packages_accuracy(
        monkeypatch):
    monkeypatch.setitem(cs.STRAGGLER_JAX_ACC, "m3s", 1.03)
    with pytest.raises(AssertionError, match="m3s"):
        cs.phase_straggler_quality(CPU, models=("m3s",), epochs=5, seeds=1)


def test_straggler_constants_name_every_model_of_the_slice():
    names = {"graph_unet", "gcnmix", "sagn", "m3s", "correct_smooth_mlp"}
    assert set(cs.STRAGGLER_KW) == names
    assert set(cs.STRAGGLER_JAX_ACC) == set(cs.STRAGGLER_QUALITY_SEEDS) == \
        names | {"patchy_san"}
    assert all(0.5 < a <= 1.0 for a in cs.STRAGGLER_JAX_ACC.values())
    for m in ("sagn", "gcnmix"):
        best = BEST_CONFIGS[m]["general"]
        assert {k: v for k, v in cs.STRAGGLER_KW[m].items() if k in best} \
            == {k: best[k] for k in cs.STRAGGLER_KW[m] if k in best}
    assert set(cs.STAGED) == {"sagn", "m3s"}
