"""CPU rehearsal of chip_smoke.py's phases of full-batch GraphSAGE and the
mini-batch paths (device-sampled, host-sampled, ClusterGCN and
GraphSAINT) at a tiny size."""

import pytest
import torch

import chip_smoke as cs
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def test_sage_main_path_phase_rehearsal():
    info = cs.phase_sage_main_path(CPU, num_nodes=300, epochs=3, sum_epochs=2)
    assert set(info) == {"mean", "sum"}
    for run in info.values():
        assert run["launches"] == 0   # CPU tensors never launch the kernel
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0
    assert info["mean"]["epochs"] == 3 and info["sum"]["epochs"] == 2


def test_sage_parity_and_quality_phase_rehearsal():
    assert cs.phase_sage_parity(CPU, num_nodes=300) == {
        "mean": 0.0, "sum": 0.0, "max": 0.0, "gcn": 0.0}
    assert cs.phase_sage_quality(CPU) >= cs.SBM_MIN_TEST_ACC


SAMPLED_TINY = dict(batch_size=8, fanouts=(2, 2))


def test_sampled_main_path_phase_rehearsal():
    info = cs.phase_sampled_main_path(CPU, num_nodes=300, epochs=3,
                                      **SAMPLED_TINY)
    assert list(info) == ["sage-mean", "sage-sum", "gat"]
    for run in info.values():
        assert run["launches"] == {}   # CPU tensors never launch a kernel
        assert run["losses"][1] < run["losses"][0] and run["epochs"] == 3
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0


def test_sampled_launches_expected_are_the_evaluations_only():
    assert cs._sampled_expected("graphsage", "mean", 6, True) == {}
    assert cs._sampled_expected("graphsage", "sum", 6, True) == {
        "spmm_csr": {("csr", 100): 6, ("csr", 128): 6}}
    assert cs._sampled_expected("gat", None, 6, True) == {
        "gat_pass": {("fwd", 8, 16): 6, ("fwd", 1, 47): 6}}
    assert cs._sampled_expected("gat", None, 6, False) == {}


def test_sampled_main_path_catches_a_launch_on_a_train_step(monkeypatch):
    from cogdl_tpu_torch.wrappers import sampled_node_classification as snc

    real = snc.DeviceSampledNodeClfWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 8)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(snc.DeviceSampledNodeClfWrapper, "loss",
                        loss_and_count)
    with pytest.raises(AssertionError, match="none on a train step"):
        cs.phase_sampled_main_path(CPU, num_nodes=300, epochs=2,
                                   models=cs.SAMPLED_MODELS[:1],
                                   **SAMPLED_TINY)
    cs.sk.reset_launch_counts()


def test_sampled_check_phase_rehearsal():
    info = cs.phase_sampled_check(CPU, num_nodes=300, **SAMPLED_TINY)
    assert info["live_slots"] > 0 and info["dead_slots"] > 0
    assert info["max_abs_diff"] == {
        "sage-mean": 0.0, "sage-sum": 0.0, "sage-max": 0.0, "sage-gcn": 0.0,
        "gat": 0.0}


def _sampled_batch():
    g = cs._holed_graph(300, CPU)
    seeds = torch.from_numpy(cs.DeviceNeighborSampler(
        g, (2, 2), batch_size=8).epoch_seeds()[0])
    blocks, frame = cs.sample_blocks_device(
        g, seeds, torch.Generator().manual_seed(0), (2, 2))
    return g, blocks, frame, seeds


def test_check_blocks_catches_what_the_sampler_must_not_do():
    g, blocks, frame, seeds = _sampled_batch()
    live, dead = cs.check_blocks(g, blocks, frame, seeds)
    assert live + dead == 24 * 2 + 8 * 2
    # a live slot of the seed hop whose frame row is no neighbour
    b = blocks[-1]
    e = int(torch.nonzero(b.edge_weight[:16] > 0)[0])
    u = int(frame[e // 2])
    E = g.num_edges
    nbrs = set(g.col[:E][g.row[:E] == u].tolist())
    v = next(i for i in range(g.num_nodes) if i not in nbrs)
    bad = frame.clone()
    bad[8 + e] = v
    with pytest.raises(AssertionError, match="not an edge"):
        cs.check_blocks(g, blocks, bad, seeds)
    with pytest.raises(AssertionError, match="seeds"):
        cs.check_blocks(g, blocks, frame, seeds.flip(0))
    # a dead slot made live
    if dead:
        b0 = blocks[0]
        w = b0.edge_weight.clone()
        w[int(torch.nonzero(w[: b0.num_edges] == 0)[0])] = 1.0
        blocks2 = (b0.replace(edge_weight=w),) + tuple(blocks[1:])
        with pytest.raises(AssertionError, match="without an edge"):
            cs.check_blocks(g, blocks2, frame, seeds)


def test_sampled_bench_phase_rehearsal():
    records = cs.phase_sampled_bench(
        CPU, scales=((2000, 10, False), (3000, 10, True)), steps=2,
        warmup=1, repeats=1, **SAMPLED_TINY)
    assert [(r["model"], r["products"]) for r in records] == [
        ("sage", False), ("gat", False), ("sage", True), ("gat", True)]
    for r in records:
        assert r["step_ms"] > 0 and r["value"] > 0 and r["seeds_per_sec"] > 0
        assert r["edge_slots_per_step"] == 64 and r["graph_s"] > 0
        assert r["profile"]["busy_ms"] is None      # no card
        assert "peak_hbm_bytes" not in r
    # the products route: the device generator's undirected graph
    assert records[2]["edges"] == 3000 * 10 + 3000


def test_host_library_phase_rehearsal():
    info = cs.phase_host_library(CPU, num_nodes=300, **SAMPLED_TINY)
    assert info["threads_checked"] == sorted({1, cs.native.max_threads()})
    assert [h["seeds"] for h in info["hops"]][0] == 8
    assert sum(h["dead"] for h in info["hops"]) > 0
    for h in info["hops"]:
        assert h["live"] + h["dead"] == h["seeds"] * h["fanout"]


def test_host_library_phase_catches_draws_off_the_replay(monkeypatch):
    real = cs.native.sample_neighbors

    def one_slot_off(*a, **kw):
        src, mask = real(*a, **kw)
        src[0] += 1
        return src, mask

    monkeypatch.setattr(cs.native, "sample_neighbors", one_slot_off)
    with pytest.raises(AssertionError, match="numpy replay"):
        cs.phase_host_library(CPU, num_nodes=300, **SAMPLED_TINY)


def test_host_sampled_launches_expected_per_step_and_evaluation():
    """Per step: GraphSAGE-sum 2 K1 over the CSR (F=100, 128) and 1 over the
    CSC (F=128); GAT 2 each of K3 fwd, dsd, dsrc. Each evaluation adds the
    full-batch model's."""
    assert cs._host_sampled_expected("graphsage", "mean", 10, 6, True) == {}
    assert cs._host_sampled_expected("graphsage", "sum", 10, 6, True) == {
        "spmm_csr": {("csr", 100): 16, ("csr", 128): 16, ("csc", 128): 10}}
    assert cs._host_sampled_expected("gat", None, 10, 6, True) == {
        "gat_pass": {("fwd", 8, 16): 16, ("fwd", 1, 47): 16,
                     ("dsd", 8, 16): 10, ("dsd", 1, 47): 10,
                     ("dsrc", 8, 16): 10, ("dsrc", 1, 47): 10}}
    assert cs._host_sampled_expected("gat", None, 10, 6, False) == {}


def test_host_sampled_main_path_phase_rehearsal():
    info = cs.phase_host_sampled_main_path(CPU, num_nodes=300, epochs=3,
                                           **SAMPLED_TINY)
    assert info.pop("launches_by") == {}
    assert list(info) == ["sage-mean", "sage-sum", "gat"]
    for run in info.values():
        assert run["launches"] == {}   # CPU tensors never launch a kernel
        assert run["losses"][1] < run["losses"][0] and run["epochs"] == 3
        assert run["train_step_ms"] > 0 and run["steps_per_epoch"] >= 2


def test_host_sampled_main_path_catches_a_launch_count_off(monkeypatch):
    from cogdl_tpu_torch.wrappers import sampled_node_classification as snc

    real = snc.SampledNodeClfWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 8)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(snc.SampledNodeClfWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="host-sampled sage-mean"):
        cs.phase_host_sampled_main_path(CPU, num_nodes=300, epochs=2,
                                        models=cs.SAMPLED_MODELS[:1],
                                        **SAMPLED_TINY)
    cs.sk.reset_launch_counts()


def test_host_sampled_check_phase_rehearsal():
    info = cs.phase_host_sampled_check(CPU, num_nodes=300, timing_batches=2,
                                       **SAMPLED_TINY)
    assert list(info["blocks"]) == ["block0", "block1", "no_live_edge"]
    assert info["blocks"]["no_live_edge"]["edges"] == 0
    for rec in info["blocks"].values():
        assert rec["k1"] == rec["k3"] == 0.0     # the plain version twice
    assert set(info["max_abs_diff"].values()) == {0.0}
    assert info["host_ms"]["sage-mean"]["structure_ms"] is None
    for label in ("sage-sum", "gat"):
        assert info["host_ms"][label]["structure_ms"] > 0
    assert info["frame_rows"] == 80               # _bucket(72 + 1)
    prof = info["host_profile_ms"]
    assert len(prof) == 10 and min(prof.values()) >= 0


def test_host_sampled_bench_phase_rehearsal():
    records = cs.phase_host_sampled_bench(
        CPU, scales=((2000, 10, False), (3000, 10, True)), steps=2,
        warmup=2, **SAMPLED_TINY)
    assert [r["products"] for r in records] == [False, True]
    for r in records:
        assert r["step_ms"] > 0 and r["value"] > 0 and r["seeds_per_sec"] > 0
        assert r["edge_slots_per_step"] == 64 and r["timed_steps"] == 2
        assert r["host_sample_ms"] > 0 and r["host_structure_ms"] is None
        # no card: the profiler window runs nothing
        assert r["profile"]["busy_ms"] is None and r["profile"]["steps"] == 0
        assert "peak_hbm_bytes" not in r
    assert records[1]["edges"] == 3000 * 10 + 3000


# the subgraph phases at a tiny size: a powerlaw graph of 2000 nodes,
# GraphSAINT's walks from 100 roots and its estimator over 8 draws
SUBGRAPH_TINY_NODES = 2000
SAINT_TINY = dict(cs.SAINT_KW, walk_roots=100, est_samples=8)


def test_subgraph_launches_expected_per_step_and_evaluation():
    """ClusterGCN with GCN: 4 K1 a step (CSR and CSC at F=128 and 47), 2
    an evaluation; GraphSAINT 1-1-0: CSR F=100, CSR F=256 and CSC F=256 a
    step, the two CSR an evaluation; a CPU run none."""
    assert cs._subgraph_expected("gcn", 12, 4, True) == {"spmm_csr": {
        ("csr", 128): 16, ("csr", 47): 16, ("csc", 128): 12,
        ("csc", 47): 12}}
    assert cs._subgraph_expected("graphsaint", 24, 4, True) == {
        "spmm_csr": {("csr", 100): 28, ("csr", 256): 28,
                     ("csc", 256): 24}}
    assert cs._subgraph_expected("graphsaint", 24, 4, False) == {}


def test_cluster_main_path_phase_rehearsal():
    info = cs.phase_cluster_main_path(CPU, num_nodes=SUBGRAPH_TINY_NODES)
    assert info.pop("launches_by") == {}
    run = info["gcn"]
    assert run["launches"] == {} and run["steps_per_epoch"] == 4
    assert run["epochs"] == [1, cs.SUBGRAPH_EPOCHS]
    assert run["losses"][1] < run["losses"][0]
    assert run["train_step_ms"] > 0 and run["eval_ms"] > 0


def test_saint_main_path_phase_rehearsal():
    info = cs.phase_saint_main_path(CPU, num_nodes=SUBGRAPH_TINY_NODES,
                                    saint_kw=SAINT_TINY)
    assert info.pop("launches_by") == {}
    assert list(info) == ["graphsaint", "gcn"]
    assert info["graphsaint"]["losses"][1] < info["graphsaint"]["losses"][0]
    assert info["gcn"]["epochs"] == [1]
    for run in info.values():
        assert run["launches"] == {} and run["steps_per_epoch"] == 8


def test_subgraph_main_path_catches_a_launch_count_off(monkeypatch):
    from cogdl_tpu_torch.wrappers import sampled_node_classification as snc

    real = snc.ClusterNodeClfWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.spmm_csr.launches += 1
        cs.sk.spmm_csr.launches_by[("csr", 128)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(snc.ClusterNodeClfWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="cluster-main gcn"):
        cs.phase_cluster_main_path(CPU, num_nodes=SUBGRAPH_TINY_NODES)
    cs.sk.reset_launch_counts()


def test_cluster_saint_check_phase_rehearsal():
    info = cs.phase_cluster_saint_check(CPU, num_nodes=SUBGRAPH_TINY_NODES,
                                        saint_kw=SAINT_TINY, iters=1)
    assert info["bfs_partition_s"] > 0
    for label in ("cluster", "saint"):
        rec = info[label]
        assert rec["k1"] == 0.0                   # the plain version twice
        assert set(rec["max_abs_diff"].values()) == {0.0}
        assert rec["edges"] > 0 and rec["nodes"] < SUBGRAPH_TINY_NODES
        assert rec["host_ms"]["batches"] >= 4
        assert rec["host_ms"]["subgraph_ms"] > 0
        assert rec["host_ms"]["structure_ms"] > 0
        # no card: the profiler window runs nothing
        assert rec["profile"]["busy_ms"] is None
    entries = info["entries"]
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=256] saint batch", "spmm_csr[csc,F=256] saint batch",
        "spmm_csr[csr,F=256] full graph"]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["err_over_tol"] == 0.0
        assert e["case"][2] == 256 and e["bound_by"] == "bytes"
    assert entries[2]["rows"] > entries[0]["rows"]


def test_cluster_saint_check_catches_a_kernel_that_disagrees(monkeypatch):
    real = cs.sk.spmm_csr

    def off(ptr, col, w, x, *a, **kw):
        return real(ptr, col, w, x, *a, **kw) + 1e-3

    monkeypatch.setattr(cs.sk, "spmm_csr", off)
    with pytest.raises(AssertionError, match="cluster batch"):
        cs.phase_cluster_saint_check(CPU, num_nodes=SUBGRAPH_TINY_NODES,
                                     saint_kw=SAINT_TINY, iters=1)


