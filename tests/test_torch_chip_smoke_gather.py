"""CPU rehearsal of chip_smoke.py's gather-probe phases (K4-K6 against
their plain versions, the adversarial shapes, the sweeps, the device
window's timing, every stage of the probe script) at a tiny size."""

import os

import pytest
import torch

import chip_smoke as cs

from cogdl_tpu_torch.utils import timing
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def _replaces(entry, prefix):
    path, line = entry["replaces"].split(":")
    src = open(os.path.join(REPO, path)).read().splitlines()
    assert src[int(line) - 1].startswith(prefix)
    assert os.path.exists(os.path.join(REPO, entry["source"]))


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


