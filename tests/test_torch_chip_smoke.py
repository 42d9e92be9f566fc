"""CPU rehearsal of chip_smoke.py's K1 phases (kernel check,
adversarial structures, chunk sweep, GCN's main path, parity and quality)
at a tiny size, and its refusal to run without a card. (On the card,
``python3 chip_smoke.py`` runs every phase at full size.) The rehearsals
of the later paths are in ``test_torch_chip_smoke_*.py``, one file a
path."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def one_cpu_thread():
    """Run a test's torch CPU ops on one thread, a measure of time only.
    Tier-1 runs six test workers on eight cores; at eight threads a worker
    each of the thousands of small ops waits at an OpenMP barrier for
    descheduled threads (``test_adversarial_phase_rehearsal`` took 13
    minutes so, ``test_gat_parity_and_quality_phase_rehearsal`` almost 5).
    This file's tests and the other port test files' (which import it from
    here) take it as their module's ``pytestmark``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.usefixtures("one_cpu_thread")



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


def test_bound_counts_each_byte_once():
    # 1000 output rows written; only the 900 x rows that col names are read
    ms, by = cs.bound_ms(n_rows=1000, nnz=10_000, feat=128, x_rows=900)
    nbytes = 4 * 1001 + 8 * 10_000 + 4 * 900 * 128 + 4 * 1000 * 128
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


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
