"""CPU rehearsal of chip_smoke.py's GAT phases (K3 single-shot, its
autograd, main path, parity and quality) and the products-scale phases
(K2 and K3 accumulating over panels, the panel Functions, sweeps, the
products train steps) at a tiny size."""

import os

import pytest
import torch

import chip_smoke as cs
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# what every K1/K2 entry says of its schedule
SCHEDULE_KEYS = {"chunk_edges", "chunks", "cross_rows", "scratch_rows",
                 "cuda_kernels_per_call", "ms_over_library",
                 "share_of_bound", "structure_s"}
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def _replaces(entry, prefix):
    path, line = entry["replaces"].split(":")
    src = open(os.path.join(REPO, path)).read().splitlines()
    assert src[int(line) - 1].startswith(prefix)
    assert os.path.exists(os.path.join(REPO, entry["source"]))


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


