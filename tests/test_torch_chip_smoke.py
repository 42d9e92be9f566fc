"""CPU rehearsal of chip_smoke.py's phases at a tiny size, and its refusal
to run without a card. (On the card, ``python3 chip_smoke.py`` runs them at
full size.)"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.utils import timing
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def one_cpu_thread():
    """Run a test's torch CPU ops on one thread, a measure of time only,
    for the rehearsals that ran longest under six test workers on eight
    cores: their thousands of small ops each wait at an OpenMP barrier for
    descheduled threads when they run on eight
    (``test_adversarial_phase_rehearsal`` took 13 minutes so,
    ``test_gat_parity_and_quality_phase_rehearsal`` almost 5)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_kernel_check_phase_rehearsal():
    entries = cs.phase_kernel_check(CPU, num_nodes=300, iters=1)
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=128]", "spmm_csr[csr,F=47]",
        "spmm_csr[csc,F=128]", "spmm_csr[csc,F=47]"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert keys | SCHEDULE_KEYS | {"kernel", "kernel_ran", "ms_rows",
                                       "ms_chunks"} <= set(e)
        # no kernel runs on the CPU: what the wrapper ran last, if anything
        assert e["kernel_ran"] in (None, "rows", "chunks")
        assert os.path.exists(os.path.join(REPO, e["source"]))
        path, line = e["replaces"].split(":")
        src = open(os.path.join(REPO, path)).read().splitlines()
        assert src[int(line) - 1].startswith("def sorted_segment_matmul(")
        assert e["chunk_edges"] == 128 and e["chunks"] >= e["nnz"] / 256
        assert e["ms_over_library"] == pytest.approx(e["ms"] / e["library_ms"])
        assert e["share_of_bound"] == pytest.approx(e["bound_ms"] / e["ms"])
        # the wrapper's choice: the chunk kernel where a row is cut
        assert e["kernel"] == ("chunks" if e["cross_rows"] else "rows")
        assert (e["max_row_nnz"] > 128) == (e["cross_rows"] > 0)


# what every K1/K2 entry says of its schedule
SCHEDULE_KEYS = {"chunk_edges", "chunks", "cross_rows", "scratch_rows",
                 "cuda_kernels_per_call", "ms_over_library",
                 "share_of_bound", "structure_s"}


@pytest.mark.usefixtures("one_cpu_thread")
def test_adversarial_phase_rehearsal():
    # one width, the one with two columns a lane
    report = cs.phase_adversarial(CPU, feats=(47,))   # K3 at every shape
    assert list(report) == ["star", "mixed_rows", "no_edge",
                            "middle_third_unnamed", "powerlaw", "host_block"]
    assert set(report.values()) == {0.0}   # the plain version on both sides


def test_adversarial_structures_are_what_their_names_say():
    t = 16
    found = {n: rest for n, *rest in cs.adversarial_structures(CPU, chunk=t)}
    row, col, n = found["star"]
    assert row.unique().numel() == 1 and row.numel() == 20 * t + 7
    row, _, _ = found["mixed_rows"]
    lens = torch.bincount(row, minlength=14).tolist()
    assert lens == [0, 0, t - 1, t, t + 1, 0, 2 * t, t, 0, 3, 2 * t + 5, 1,
                    0, 0]
    assert sum(lens[:8]) == 6 * t          # row 7 ends on a chunk boundary
    assert found["no_edge"][0].numel() == 0
    _, col, n = found["middle_third_unnamed"]
    assert not ((col >= n // 3) & (col < 2 * (n // 3))).any()
    assert (col < n // 3).any() and (col >= 2 * (n // 3)).any()
    row, col, n = found["host_block"]
    lens = torch.bincount(row, minlength=n)
    assert lens[:24].tolist() == [15] * 8 + [10] * 16
    assert not lens[24:].any()                 # the sink row among them
    assert int(torch.bincount(col, minlength=n).max()) > t  # a cut CSC row
    # built from the seed: the same lists every time
    again = {n: rest for n, *rest in cs.adversarial_structures(CPU, chunk=t)}
    assert all(torch.equal(found[k][1], again[k][1]) for k in found)


def test_adversarial_phase_catches_a_kernel_that_disagrees(monkeypatch):
    real = cs.sk.spmm_csr

    def off_by_a_little(*a, **kw):
        return real(*a, **kw) * 1.001

    monkeypatch.setattr(cs.sk, "spmm_csr", off_by_a_little)
    with pytest.raises(AssertionError, match="adversarial structure"):
        cs.phase_adversarial(CPU, feats=(8,), gat_shapes=())


def test_chunk_sweep_phase_rehearsal():
    rows = cs.phase_chunk_sweep(CPU, num_nodes=300, iters=1)
    assert [(r["structure"], r["F"], r["chunk_edges"]) for r in rows] == [
        (s, f, t) for s in ("csr", "csc") for f in (128, 47)
        for t in (32, 64, 128, 256)]
    for r in rows:
        assert r["err_over_tol"] == 0.0 and r["ms"] > 0
        assert r["chunks"] >= r["cross_rows"] >= 0
    # fewer edges a chunk: more chunks and more rows cut
    csc = [r for r in rows if r["structure"] == "csc" and r["F"] == 47]
    assert [r["chunks"] for r in csc] == sorted(
        (r["chunks"] for r in csc), reverse=True)
    assert csc[0]["cross_rows"] > csc[-1]["cross_rows"] > 0


def test_schedule_stats_leave_the_padding_out():
    ptr = torch.tensor([[0, 40, 40, 44], [44, 45, 46, 47]], dtype=torch.int32)
    sched = cs.build_spmm_schedule(ptr, 16)
    # panel 0: a row of 40 edges cut into 3 chunks and a row of 4; panel 1:
    # one chunk, no row cut, padded to panel 0's sizes
    assert sched.chunk_start.shape == (2, 4) and sched.cross.shape == (2, 1, 3)
    assert cs.schedule_stats(sched) == (4, 1)
    assert cs.schedule_stats(sched.panel(1)) == (1, 0)


def test_tail_report_reads_the_ratios_off_the_entries():
    def k1(structure, feat, ms, lib):
        return {"name": f"spmm_csr[{structure},F={feat}]", "ms": ms,
                "ms_over_library": ms / lib}

    entries = [k1("csr", 128, 0.2, 0.3), k1("csc", 128, 0.3, 0.4),
               k1("csr", 47, 0.1, 0.2), k1("csc", 47, 0.2, 0.25),
               {"name": "spmm_csr_accum[F=128]", "ms_over_library": 0.3},
               {"name": "spmm_csr_accum[F=47]", "ms_over_library": 0.5},
               {"name": "gat_pass[fwd,H=8,D=16]"}]
    report = cs.tail_report(entries)
    assert report["F=128"] == {
        "k1_csc_over_csr": pytest.approx(1.5),
        "k1_csr_over_library": pytest.approx(2 / 3),
        "k1_csc_over_library": pytest.approx(0.75),
        "k2_sweep_over_library": 0.3}
    assert report["F=47"]["k1_csc_over_csr"] == pytest.approx(2.0)


def test_main_path_phase_rehearsal():
    info = cs.phase_main_path(CPU, num_nodes=300, epochs=3)
    assert info["launches"] == 0  # CPU tensors never launch the kernel
    assert set(info["launches_by_case"].values()) == {0}
    assert info["train_step_ms"] > 0 and info["eval_ms"] > 0


def test_parity_and_quality_phase_rehearsal():
    assert cs.phase_parity(CPU, num_nodes=300) == 0.0
    assert cs.phase_quality(CPU) >= cs.SBM_MIN_TEST_ACC


@pytest.mark.usefixtures("one_cpu_thread")
def test_gat_kernel_check_phase_rehearsal():
    entries = cs.phase_gat_kernel_check(CPU, num_nodes=300, iters=1)
    assert [e["name"] for e in entries] == [
        f"gat_pass[{m},H={h},D={d}]" for h, d in ((8, 16), (1, 47))
        for m in ("fwd", "dsd", "dsrc")]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert keys <= set(e)
        assert e["err_over_tol"] == 0.0   # the plain version on both sides
        assert e["library_ms"] is None and e["bound_by"] == "bytes"
        assert e["source"] == "cogdl_tpu_torch/csrc/gat_fused.cu"
        assert os.path.exists(os.path.join(REPO, e["source"]))
        path, line = e["replaces"].split(":")
        src = open(os.path.join(REPO, path)).read().splitlines()
        assert src[int(line) - 1].startswith("def _gat_pass(")
        # K3 is cut on K1/K2's schedule: the same fields, and both kernels
        # timed (the row-a-warp one takes these heads)
        assert SCHEDULE_KEYS - {"ms_over_library", "structure_s"} | {
            "kernel", "kernel_ran", "ms_rows", "ms_chunks"} <= set(e)
        assert e["share_of_bound"] == pytest.approx(e["bound_ms"] / e["ms"])
        assert e["kernel"] == ("chunks" if e["cross_rows"] else "rows")
        assert (e["max_row_nnz"] > 128) == (e["cross_rows"] > 0)
        # no kernel runs on the CPU: what the wrapper ran last, if anything
        assert e["kernel_ran"] in (None, "rows", "chunks")


def test_gat_single_check_catches_a_kernel_that_disagrees(monkeypatch):
    real = cs.sk.gat_pass

    def drops_a_head(*a, **kw):
        *outs, keep = real(*a, **kw)
        return tuple(outs) + (keep * (keep.new_tensor(
            [0.0] + [1.0] * (keep.shape[1] - 1))),)

    drops_a_head.cuda_kernels, drops_a_head.kernel = 0, None
    monkeypatch.setattr(cs.sk, "gat_pass", drops_a_head)
    with pytest.raises(AssertionError, match="keep mask differs"):
        cs.phase_adversarial(CPU, feats=(8,), gat_shapes=((2, 3),))


def test_gat_panel_sweep_phase_rehearsal():
    rows = cs.phase_gat_panel_sweep(CPU, nodes=2000, avg_degree=10,
                                    panels=(1, 2, 8), steps=1)
    assert [(r["panels"], r["kernel"]) for r in rows] == [
        (1, "K3"), (2, "K3 accumulating"), (8, "K3 accumulating")]
    assert rows[0]["panel_rows"] == 0 and rows[1]["panel_rows"] == 1024
    assert all(r["step_ms"] > 0 and r["structure_s"] > 0 for r in rows)


def test_gat_autograd_phase_rehearsal():
    report = cs.phase_gat_autograd(CPU, num_nodes=300)
    assert set(report) == {"H=8,D=16", "H=1,D=47"}
    assert max(max(r.values()) for r in report.values()) <= 1.0


def test_gat_main_path_phase_rehearsal():
    info = cs.phase_gat_main_path(CPU, num_nodes=300, epochs=2)
    assert info["launches"] == 0  # CPU tensors never launch the kernel
    assert len(info["launches_by_case"]) == 6
    assert set(info["launches_by_case"].values()) == {0}
    assert info["train_step_ms"] > 0 and info["eval_ms"] > 0


@pytest.mark.usefixtures("one_cpu_thread")
def test_gat_parity_and_quality_phase_rehearsal():
    assert cs.phase_gat_parity(CPU, num_nodes=300) == 0.0
    assert cs.phase_gat_quality(CPU) >= cs.SBM_MIN_TEST_ACC


def test_gat_bound_counts_each_byte_once():
    # 1000 rows written, 900 of them with edges, 800 neighbours named;
    # H=2, D=4 (H·D=8), dropout on: orig ids read beside the indices
    H, HD = 2, 8
    rows = {"fwd": (HD + H, H, HD + H), "dsd": (HD + H, HD + 2 * H, H),
            "dsrc": (HD + 2 * H, HD + H, HD + H)}
    for mode, (nbr_w, own_w, out_w) in rows.items():
        ms, by = cs.gat_bound_ms(mode, n_rows=1000, nnz=10_000, x_rows=800,
                                 own_rows=900, heads=H, head_dim=4, drop=True)
        nbytes = (4 * 1001 + 2 * 4 * 10_000 + 4 * 800 * nbr_w
                  + 4 * 900 * own_w + 4 * H + 4 * 1000 * out_w)
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    # without dropout the orig ids are not read
    ms, _ = cs.gat_bound_ms("fwd", 1000, 10_000, 800, 900, H, 4, drop=False)
    assert ms == pytest.approx((4 * 1001 + 4 * 10_000 + 4 * 800 * (HD + H)
                                + 4 * 900 * H + 4 * H + 4 * 1000 * (HD + H))
                               / 3.35e12 * 1e3)


def test_bound_counts_each_byte_once():
    # 1000 output rows written; only the 900 x rows that col names are read
    ms, by = cs.bound_ms(n_rows=1000, nnz=10_000, feat=128, x_rows=900)
    nbytes = 4 * 1001 + 8 * 10_000 + 4 * 900 * 128 + 4 * 1000 * 128
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def test_accum_kernel_check_phase_rehearsal():
    report = cs.phase_accum_kernel_check(CPU, num_nodes=300)
    assert set(report) == {f"{s},F={f}" for s in ("csr", "csc")
                           for f in (128, 47)}
    for r in report.values():
        assert r["vs_plain"] == 0.0       # the plain version on both sides
        assert r["vs_one_k1_call"] <= 1.0


def test_panel_autograd_phase_rehearsal():
    errs = cs.phase_panel_autograd(CPU, num_nodes=300)
    assert set(errs) == {"y", "dx", "dw"} and max(errs.values()) <= 1.0


def test_gat_accum_check_phase_rehearsal():
    report = cs.phase_gat_accum_check(CPU, num_nodes=300)
    assert set(report) == {f"{m},H={h},D={d}" for h, d in ((8, 16), (1, 47))
                           for m in ("fwd", "dsd", "dsrc")}
    assert set(report.values()) == {0.0}


def test_gat_panel_autograd_phase_rehearsal():
    report = cs.phase_gat_autograd(CPU, num_nodes=300,
                                   n_panels=cs.CHECK_PANELS)
    assert set(report) == {"H=8,D=16", "H=1,D=47"}
    assert max(max(r.values()) for r in report.values()) <= 1.0


def test_panel_parity_phase_rehearsal():
    assert cs.phase_panel_parity(CPU, num_nodes=500) == {"gcn": 0.0,
                                                         "gat": 0.0}


def test_panel_sweep_phase_rehearsal():
    rows = cs.phase_panel_sweep(CPU, nodes=2000, avg_degree=10,
                                panels=(1, 2, 4), steps=1, split_at=4)
    assert [(r["panels"], r["kernel"]) for r in rows] == [
        (1, "K1"), (2, "K2"), (4, "K2")]
    assert rows[0]["panel_rows"] == 0 and rows[2]["panel_rows"] == 512
    assert all(r["step_ms_no_cache"] > 0 for r in rows)
    # what a panel's time is made of, at the panel count asked for only
    assert [("hub_split" in r) for r in rows] == [False, False, True]
    split = rows[2]["hub_split"]
    assert split["panel"] == 2 and split["rows"] == 2048
    assert 0 < split["hub_row_nnz"] <= split["nnz"]
    assert {f"{c},F={f},{k}_ms" for f in (128, 47) for c, k in (
        ("panel", "rows"), ("panel", "chunks"),
        ("panel_without_hub_row", "rows"), ("panel_without_hub_row", "chunks"),
        ("rows_without_edges", "rows"))} <= set(split)


def _replaces(entry, prefix):
    path, line = entry["replaces"].split(":")
    src = open(os.path.join(REPO, path)).read().splitlines()
    assert src[int(line) - 1].startswith(prefix)
    assert os.path.exists(os.path.join(REPO, entry["source"]))


def test_products_gcn_phase_rehearsal():
    info, entries = cs.phase_products(CPU, "gcn", nodes=2000, avg_degree=10,
                                      panel_rows=512, steps=3, iters=1)
    assert info["panels"] == 4 and info["panel_rows"] == 512
    assert info["edges"] == 22_000
    # CPU tensors never launch a kernel
    assert info["cached_launches_per_step"] == 0
    assert info["uncached_launches_per_step"] == 0
    assert info["cached_losses"][-1] < info["cached_losses"][0]
    assert info["uncached_step_ms"] > 0 and "peak_hbm_bytes" not in info
    assert [e["name"] for e in entries] == ["spmm_csr_accum[F=128]",
                                            "spmm_csr_accum[F=47]"]
    for e in entries:
        assert KERNEL_KEYS <= set(e)
        assert e["err_over_tol"] == 0.0 and e["launches"] == 0
        assert e["bound_by"] == "bytes" and e["library_ms"] > 0
        assert e["source"] == "cogdl_tpu_torch/csrc/spmm_csr_accum.cu"
        assert e["sweep_ms"] == pytest.approx(e["ms"] * e["panels"])
        _replaces(e, "def sorted_segment_matmul_accum(")
        assert SCHEDULE_KEYS | {"cuda_kernels_sweep"} <= set(e)
        assert e["ms_over_library"] == pytest.approx(
            e["sweep_ms"] / e["library_sweep_ms"])
    # recorded beside them: K2's sweep at each chunk size
    assert [(r["F"], r["chunk_edges"]) for r in info["chunk_sweep"]] == [
        (f, t) for f in (128, 47) for t in (32, 64, 128, 256)]
    assert all(r["sweep_ms"] > 0 and r["panels"] == 4
               for r in info["chunk_sweep"])


def test_products_gat_phase_rehearsal():
    info, entries = cs.phase_products(CPU, "gat", nodes=2000, avg_degree=10,
                                      panel_rows=512, steps=3, iters=1)
    assert info["panels"] == 4 and info["launches_per_step"] == 0
    assert info["losses"][-1] < info["losses"][0]
    assert [e["name"] for e in entries] == [
        f"gat_pass_accum[{m},H={h},D={d}]" for h, d in ((8, 16), (1, 47))
        for m in ("fwd", "dsd", "dsrc")]
    for e in entries:
        assert KERNEL_KEYS <= set(e)
        assert e["err_over_tol"] <= 1.0   # float32 against the float64 run
        assert e["library_ms"] is None and e["launches"] == 0
        assert e["source"] == "cogdl_tpu_torch/csrc/gat_fused.cu"
        _replaces(e, "def _gat_pass(")


def test_products_phase_refuses_a_structure_without_panels():
    with pytest.raises(AssertionError, match="no panel structure"):
        cs.phase_products(CPU, "gcn", nodes=2000, avg_degree=10,
                          panel_rows=0, steps=1, iters=1)


def test_accum_bound_counts_each_byte_once():
    # a panel of 10,000 edges over 1000 rows: 700 rows have an edge (read
    # and written), 800 rows of x are named
    ms, by = cs.accum_bound_ms(n_rows=1000, nnz=10_000, feat=128, x_rows=800,
                               own_rows=700)
    nbytes = 4 * 1001 + 8 * 10_000 + 4 * 128 * (800 + 2 * 700)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    # the accumulating K3 pass: outputs read and written for rows with edges
    ms, _ = cs.gat_bound_ms("fwd", 1000, 10_000, 800, 700, 2, 4, drop=False,
                            accum=True)
    assert ms == pytest.approx((4 * 1001 + 4 * 10_000 + 4 * 800 * (8 + 2)
                                + 4 * 700 * 2 + 4 * 2
                                + 4 * 2 * 700 * (8 + 2)) / 3.35e12 * 1e3)


def test_gather_kernel_check_phase_rehearsal():
    # what K4's and K5's wrappers ran last, if anything (a card test in the
    # same process may have run them); no kernel runs on the CPU
    wrappers = {"B": cs.gk.gather_block_sum, "C": cs.gk.gather_window_sum,
                "D": cs.gk.gather_rows_sum}
    before = {k: (fn.kernel, fn.cuda_kernels) for k, fn in wrappers.items()}
    rows_plan = cs.gk.gather_rows_sum.plan
    entries = cs.phase_gather_kernel_check(CPU, rows=4096, gathered=4096,
                                           iters=1)
    assert [(e["name"], e["stage"]) for e in entries] == [
        ("gather_block_sum[T=1024]", "B"),
        ("gather_window_sum[W=256]", "C256"),
        ("gather_window_sum[W=512]", "C512"),
        ("gather_window_sum[W=1024]", "C1024"),
        ("gather_rows_sum[outstanding=8]", "D")]
    for e in entries:
        assert KERNEL_KEYS | {"ns_per_row", "gathered_bytes_per_s",
                              "ms_cold", "device_ms", "host_us_per_call",
                              "share_of_bound", "cuda_kernels_per_call",
                              "kernel_ran", "segments"} <= set(e)
        # no card: the host clock stands in for the device's, and says so
        assert e["device_ms_by"] == "host clock (CPU rehearsal)"
        assert e["device_ms"] > 0 and e["host_us_per_call"] > 0
        assert len(e["device_ms_tables"]) == cs.GATHER_TIMING_TABLES
        assert e["device_ms"] == sorted(e["device_ms_tables"])[
            len(e["device_ms_tables"]) // 2]
        assert e["profiler_ms"] is None and e["smi_at_start"]
        # the share of the bound is the device time's, for every probe
        assert e["share_of_bound"] == pytest.approx(e["bound_ms"]
                                                    / e["device_ms"])
        assert (e["kernel_ran"], e["cuda_kernels_per_call"]) == before[
            e["stage"][0]]
        assert e["err_over_tol"] == 0.0   # the plain version on both sides
        assert e["total_err_over_tol"] <= 1.0
        assert e["bound_by"] == "bytes" and e["library_ms"] > 0
        assert e["ms_cold"] > 0
        # the median over copies of the table, each timed on its own
        assert len(e["ms_tables"]) == cs.GATHER_TIMING_TABLES
        assert e["ms"] == sorted(e["ms_tables"])[len(e["ms_tables"]) // 2]
        assert e["rows_gathered"] == (1024 if e["stage"] == "D" else 4096)
        assert e["ns_per_row"] == pytest.approx(
            e["ms"] * 1e6 / e["rows_gathered"])
        _replaces(e, "        parts = pl.pallas_call(")
        if e["stage"] == "D":
            # K6's cut is what its last call on a card used (none here)
            assert (e["grid"], e["segments"]) == (rows_plan or (None, None))
            assert "onchip_bound_ms" not in e
            continue
        # K4 and K5: the on-chip bound too
        assert e["onchip_bound_ms"] == pytest.approx(
            512 * 4096 / (132 * 128 * 1.98e9) * 1e3)
    # 4096 rows, 4 chunks: one block a window up to W = 1024
    assert [(e["tile_cols"], e["segments"]) for e in entries[:4]] == [
        (32, 32), (32, 16), (32, 16), (32, 16)]
    # each names its own source and the call site of its own Pallas probe
    assert [e["replaces"].split(":")[1] for e in entries] == [
        "82", "111", "111", "111", "165"]
    assert len({e["source"] for e in entries}) == 3


def test_gather_adversarial_phase_rehearsal():
    report = cs.phase_gather_adversarial(CPU, windows=(1, 32, 256),
                                         chunks=(1, 31),
                                         rows_chunks=(1, 31, 1024), n_sms=4)
    assert set(report) == {"window,W=1", "window,W=32", "window,W=256",
                           "block,W=1", "block,W=31", "rows,T=1",
                           "rows,T=31", "rows,T=1024"}
    assert set(report.values()) == {0.0}   # the plain version on both sides


def test_gather_adversarial_cases_are_what_the_checks_say():
    cases = cs.gather_adversarial_cases()
    windows = {(w, t) for k, w, t, _, _ in cases if k == "window"}
    assert windows == {(w, t) for w in (1, 32, 256, 1024, 4096)
                       for t in (1, 31, 1024, 4096)}
    assert {w for k, w, t, _, _ in cases if k == "block"} == {1, 31, 1024,
                                                              4096}
    # K6: every chunk size, fewer chunks than SMs, as many, and 3 x SMs + 7
    # (a multiple of neither the SM count nor a grid of whole SMs)
    rows = [(t, n_chunks) for k, w, t, n_rows, n_chunks in cases
            if k == "rows"]
    assert rows == [(t, n) for t in (1, 31, 1024, 4096)
                    for n in (66, 132, 403)]
    assert all(403 % (132 * b) for b in range(1, 9))
    for kernel, window, chunk, n_rows, n_chunks in cases:
        if kernel == "rows":
            assert window == n_rows == cs.GATHER_ADV_ROWS
            continue
        assert n_rows == 3 * window + 77
        assert kernel == "window" or window == chunk
    # fewer chunks than windows, as many, and 3x + 1, for every window
    by_window = {}
    for k, w, t, n_rows, n_chunks in cases:
        if k == "rows":
            continue
        by_window.setdefault((k, w, t, n_rows // w), []).append(n_chunks)
    for (_, w, _, n_windows), got in by_window.items():
        assert got == [max(n_windows // 2, 1), n_windows, 3 * n_windows + 1]
        assert n_windows == (3 if w > 77 else 3 + 77 // w)
    # every tile width that fits is a variant of K5; K4 takes both
    # carve-outs
    assert cs.gather_variants("window", 1024) == [
        {"tile_cols": 8}, {"tile_cols": 16}, {"tile_cols": 32}]
    assert len(cs.gather_variants("window", 256)) == 5
    assert cs.gather_variants("block", 1024) == [{"max_l1": True},
                                                 {"max_l1": False}]
    assert cs.gather_variants("rows", cs.GATHER_ADV_ROWS) == [
        {"outstanding": d} for d in (1, 2, 4, 8)]
    # on the nominal card, K6's cut puts warps' ranges inside chunks at
    # both ends in these cases (on the card the phase asserts it)
    assert sum(cs.mid_chunk_ranges(
        n, t, cs.gk.rows_plan(n, t, 132, cs.gk.ROWS_BLOCKS_PER_SM))
        for t, n in rows) > 0


def test_gather_adversarial_phase_catches_a_kernel_off_by_a_little(
        monkeypatch):
    real = cs.gk.gather_window_sum

    def off_by_a_little(*a, **kw):
        return real(*a, **kw) * 1.001

    monkeypatch.setattr(cs.gk, "gather_window_sum", off_by_a_little)
    with pytest.raises(AssertionError, match="adversarial shape"):
        cs.phase_gather_adversarial(CPU, windows=(32,), chunks=(31,))


@pytest.mark.parametrize("depth", [1, 8])
def test_gather_adversarial_phase_catches_k6_off_by_a_little(monkeypatch,
                                                             depth):
    real = cs.gk.gather_rows_sum

    def off_by_a_little(*a, **kw):
        out = real(*a, **kw)
        return out * 1.001 if kw.get("outstanding") == depth else out

    monkeypatch.setattr(cs.gk, "gather_rows_sum", off_by_a_little)
    with pytest.raises(AssertionError,
                       match=f"'outstanding': {depth}.*adversarial shape"):
        cs.phase_gather_adversarial(CPU, windows=(), chunks=(),
                                    rows_chunks=(31,), n_sms=3)


def test_gather_sweep_phase_rehearsal():
    rows = cs.phase_gather_sweep(CPU, rows=4096, gathered=2048, iters=1)
    assert [(r["kernel"], r["window"]) for r in rows] == (
        [("block", 1024)] * 2 + [("window", 256)] * 5
        + [("window", 512)] * 4 + [("window", 1024)] * 3
        + [("rows", 4096)] * 4)
    assert all(r["err_over_tol"] == 0.0 and r["ms"] > 0
               and r["device_ms"] > 0 and r["host_us_per_call"] > 0
               for r in rows)
    assert all(r["blocks_per_sm"] is None for r in rows)   # no card
    assert [r["max_l1"] for r in rows[:2]] == [True, False]
    # K6 at every depth, its cut beside each (none on the CPU)
    assert [r["outstanding"] for r in rows[-4:]] == [1, 2, 4, 8]
    assert all(r["segments"] is None and r["fits_per_sm"] is None
               for r in rows[-4:])


class _FakeEvent:
    """A CUDA event whose times come from a list: the card's clock as the
    test sets it."""
    stamps = []

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = _FakeEvent.stamps.pop(0)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def _fake_card(monkeypatch, slept_ms, kernels_ms):
    """Patch torch.cuda so that time_device_ms runs on the CPU: the card
    sleeps ``slept_ms``, then the calls take ``kernels_ms``."""
    # the sleep's two events, then the window's two
    _FakeEvent.stamps = [0.0, slept_ms, slept_ms, slept_ms + kernels_ms]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)


def _clock(*readings):
    it = iter(readings)
    return lambda: next(it)


def test_device_window_times_the_card_behind_the_sleep(monkeypatch):
    calls = []
    _fake_card(monkeypatch, slept_ms=5.0, kernels_ms=0.5)
    # the host queues 20 calls in 0.4 ms, inside the 5 ms sleep
    d_ms, h_us = timing.time_device_ms(
        lambda: calls.append(1), torch.device("cuda", 0), iters=20,
        warmup=3, clock=_clock(10.0, 10.0004))
    assert len(calls) == 23
    assert d_ms == pytest.approx(0.5 / 20)
    assert h_us == pytest.approx(0.4e3 / 20)


def test_device_window_raises_when_the_enqueue_outlasts_the_sleep(
        monkeypatch):
    _fake_card(monkeypatch, slept_ms=5.0, kernels_ms=0.5)
    # the host took 6 ms to queue the calls: the card may have waited
    with pytest.raises(RuntimeError, match="raise sleep_ms"):
        timing.time_device_ms(lambda: None, torch.device("cuda", 0),
                              iters=20, clock=_clock(10.0, 10.006))


def test_device_window_on_the_cpu_is_the_host_clock():
    calls = []
    d_ms, h_us = timing.time_device_ms(lambda: calls.append(1), CPU, iters=4,
                                       warmup=1, clock=_clock(1.0, 1.002))
    assert len(calls) == 5
    assert d_ms == pytest.approx(0.5) and h_us == pytest.approx(500.0)


def test_cold_timing_writes_past_the_l2_between_calls():
    calls = []
    assert cs.time_cold_ms(lambda: calls.append(1), CPU, iters=3) >= 0
    assert len(calls) == 4 and cs.COLD_FLUSH_BYTES > 50 * 2 ** 20


def test_gather_bound_counts_each_byte_once():
    # 900 distinct rows named by 4096 indices in 4 chunks
    ms, by = cs.gather_bound_ms(distinct_rows=900, n_idx=4096, n_chunks=4)
    assert by == "bytes"
    assert ms == pytest.approx((512 * 900 + 4 * 4096 + 4 * 4) / 3.35e12 * 1e3)


def test_gather_path_phase_rehearsal():
    info = cs.phase_gather_path(CPU, rows=4096, gathered=2048, iters=1,
                                warmup=0)
    assert list(info["stages"]) == ["A", "B", "C256", "C512", "C1024", "D"]
    # CPU tensors never launch a kernel; stage A has none to launch
    assert info["launches"] == {"B": 0, "C256": 0, "C512": 0, "C1024": 0,
                                "D": 0}
    assert info["stages"]["B"]["total"] == pytest.approx(
        info["stages"]["C1024"]["total"])
    assert all(r["calls"] == 2 for r in info["stages"].values())


def test_gather_path_phase_catches_a_launch_of_another_kernel(monkeypatch):
    real = cs.mg.run

    def run_and_count(stage, *a, **kw):
        rep = real(stage, *a, **kw)
        if stage == "C256":
            cs.sk.spmm_csr.launches += 1
        return rep

    monkeypatch.setattr(cs.mg, "run", run_and_count)
    with pytest.raises(AssertionError, match="stage C256: spmm_csr launched"):
        cs.phase_gather_path(CPU, rows=4096, gathered=1024, iters=1, warmup=0)
    cs.sk.reset_launch_counts()


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


def test_zoo_kernel_check_phase_rehearsal():
    entries = cs.phase_zoo_kernel_check(CPU, num_nodes=300, iters=1)
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=64]", "spmm_csr[csr,F=192]", "spmm_csr[csc,F=64]",
        "spmm_csr[csc,F=192]"] + [f"gat_pass[{m},H=8,D=8]"
                                  for m in ("fwd", "dsd", "dsrc")]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["err_over_tol"] == 0.0
        assert e["bound_by"] == "bytes"
        assert (e["library_ms"] is None) == (e["case"][0] == "gat_pass")
    assert [e["case"] for e in entries[:4]] == [
        ["spmm_csr", s, f] for s in ("csr", "csc") for f in (64, 192)]


def test_zoo_kernel_check_catches_a_kernel_that_disagrees(monkeypatch):
    real = cs.sk.spmm_csr

    def off(ptr, col, w, x, *a, **kw):
        out = real(ptr, col, w, x, *a, **kw)
        return out + 1e-3 if x.shape[1] == 192 else out

    monkeypatch.setattr(cs.sk, "spmm_csr", off)
    with pytest.raises(AssertionError, match="F=192"):
        cs.phase_zoo_kernel_check(CPU, num_nodes=300, iters=1)


def test_zoo_launches_expected_per_step_and_evaluation():
    """Per train step and evaluation at the zoo's widths (F_in 100, 47
    classes): GCNII 16 CSR + 16 CSC at F=64, 16 CSR an evaluation; APPNP
    10 + 10 at F=47; MixHop CSR F=100 x2 (no CSC: the features take no
    gradient), CSR and CSC F=192 x2; SGC CSR F=100 x2; DrGCN CSR and CSC at
    F=64 and F=47; DrGAT K3 fwd, dsd, dsrc at (8, 8) and (1, 47), fwd an
    evaluation; MLP and DeeperGCN nothing."""
    one_step = {m: cs._zoo_expected(m, 1, 0, True) for m in cs.ZOO_KW}
    one_eval = {m: cs._zoo_expected(m, 0, 1, True) for m in cs.ZOO_KW}
    assert one_step["gcnii"] == {"spmm_csr": {("csr", 64): 16,
                                              ("csc", 64): 16}}
    assert one_eval["gcnii"] == {"spmm_csr": {("csr", 64): 16}}
    assert one_step["appnp"] == {"spmm_csr": {("csr", 47): 10,
                                              ("csc", 47): 10}}
    assert one_step["mixhop"] == {"spmm_csr": {
        ("csr", 100): 2, ("csr", 192): 2, ("csc", 192): 2}}
    assert one_step["sgc"] == {"spmm_csr": {("csr", 100): 2}}
    assert one_step["drgcn"] == {"spmm_csr": {
        ("csr", 64): 1, ("csc", 64): 1, ("csr", 47): 1, ("csc", 47): 1}}
    assert one_step["drgat"] == {"gat_pass": {
        (m, h, d): 1 for m in ("fwd", "dsd", "dsrc")
        for h, d in ((8, 8), (1, 47))}}
    assert one_eval["drgat"] == {"gat_pass": {("fwd", 8, 8): 1,
                                              ("fwd", 1, 47): 1}}
    assert one_step["mlp"] == one_step["deepergcn"] == {}
    assert cs._zoo_expected("gcnii", 5, 6, False) == {}


def test_zoo_main_path_phase_rehearsal():
    info = cs.phase_zoo_main_path(CPU, num_nodes=300, epochs=2)
    assert info.pop("launches_by") == {}
    assert list(info) == list(cs.ZOO_KW) + ["deepergcn-remat"]
    for run in info.values():
        assert run["launches"] == {} and run["peak_hbm_bytes"] is None
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0


def test_zoo_main_path_catches_a_launch_count_off(monkeypatch):
    real = NodeClfWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.gat_pass.launches += 1
        cs.sk.gat_pass.launches_by[("fwd", 8, 8)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(NodeClfWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="zoo-main mlp"):
        cs.phase_zoo_main_path(CPU, num_nodes=300, epochs=1, models=("mlp",))
    cs.sk.reset_launch_counts()


def test_zoo_parity_and_quality_phase_rehearsal():
    assert set(cs.phase_zoo_parity(CPU, num_nodes=300).values()) == {0.0}
    accs = cs.phase_zoo_quality(CPU, models=("sgc", "mlp"))
    assert all(a >= cs.ZOO_JAX_SBM_ACC[m] - cs.ZOO_QUALITY_MARGIN
               for m, a in accs.items())


def test_zoo_quality_holds_each_model_to_the_jax_packages_accuracy(
        monkeypatch):
    monkeypatch.setitem(cs.ZOO_JAX_SBM_ACC, "mlp", 1.03)
    with pytest.raises(AssertionError, match="mlp"):
        cs.phase_zoo_quality(CPU, models=("mlp",), epochs=5)


def test_busy_time_counts_overlaps_once():
    assert cs.busy_us([(10, 12), (0, 5), (3, 8), (11, 11)]) == 10
    assert cs.busy_us([]) == 0
    assert cs.profile_window(lambda: None, CPU)["busy_ms"] is None


def _run_without_card(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_card():
    r = _run_without_card(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_refuses_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_without_card(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
