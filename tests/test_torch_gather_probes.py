"""The gather probes: the plain versions of K4, K5 and K6 against the Pallas
probes of ``scripts/microbench_gather7.py`` run in interpret mode on the CPU,
against numpy in float64, and the port's probe script end to end.

The JAX script is loaded by path and left as it is: ``pallas_call`` is
patched to interpret mode and the script's ``N`` (which K5's index map
reads) to the small table's height, both through ``monkeypatch`` so that
other test files sharing the worker see neither."""

import functools
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cogdl_tpu_torch.ops.cuda import (
    gather_block_sum,
    gather_block_sum_reference,
    gather_rows_sum,
    gather_rows_sum_reference,
    gather_window_sum,
    gather_window_sum_reference,
)
from cogdl_tpu_torch.ops.cuda import gather_kernels as gk
from cogdl_tpu_torch.ops.cuda.gather_kernels import (
    gather_window_sum_tiled_reference,
    window_rows,
)
from cogdl_tpu_torch.scripts import microbench_gather as mg
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, T = 4096, 1024
# fp32 sums of the same terms in another order: relative to Σ|terms|, as
# chip_smoke.py holds the kernels
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def jax_probes(monkeypatch):
    """``scripts/microbench_gather7.py`` with its kernels in interpret mode
    over a table of ``ROWS`` rows."""
    spec = importlib.util.spec_from_file_location(
        "microbench_gather7",
        os.path.join(REPO, "scripts", "microbench_gather7.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(mod, "N", ROWS)
    assert mod.T == T == mg.T
    return mod


def _inputs(n_chunks, hi, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((ROWS, 128)).astype(np.float32)
    idx = rng.integers(0, hi, n_chunks * T).astype(np.int32)
    return table, idx


def _tol(table, rows):
    """The tolerance on a sum of ``table[rows]``: ATOL + RTOL·Σ|terms|."""
    return ATOL + RTOL * float(np.abs(table[rows]).sum())


def _numpy_chunks(table, rows, n_chunks):
    return table.astype(np.float64)[rows].reshape(n_chunks, -1).sum(1)


def _held(out, table, rows, n_chunks):
    """Per-chunk sums within tolerance of numpy's float64 sums."""
    ref = _numpy_chunks(table, rows, n_chunks)
    tol = ATOL + RTOL * np.abs(table[rows]).reshape(n_chunks, -1).sum(1)
    np.testing.assert_array_less(np.abs(out.double().numpy() - ref), tol)


def test_block_probe_matches_pallas(jax_probes):
    n_chunks = 4                      # one chunk per block of the table
    table, idx = _inputs(n_chunks, T)
    total_j = float(jax_probes.make_dyn_gather(n_chunks)(
        jnp.asarray(table), jnp.asarray(idx)))
    out = gather_block_sum_reference(torch.from_numpy(table),
                                     torch.from_numpy(idx), T)
    rows = idx + np.repeat(np.arange(n_chunks) * T, T)
    assert abs(float(out.sum()) - total_j) <= _tol(table, rows)
    _held(out, table, rows, n_chunks)


@pytest.mark.parametrize("window", [256, 512])
def test_window_probe_matches_pallas(jax_probes, window):
    n_chunks = 4
    table, idx = _inputs(n_chunks, window, seed=window)
    total_j = float(jax_probes.make_onehot(window, n_chunks)(
        jnp.asarray(table), jnp.asarray(idx)))
    out = gather_window_sum_reference(torch.from_numpy(table),
                                      torch.from_numpy(idx), window, T)
    rows = idx + np.repeat(
        (np.arange(n_chunks) % (ROWS // window)) * window, T)
    assert abs(float(out.sum()) - total_j) <= _tol(table, rows)
    _held(out, table, rows, n_chunks)


def test_window_probe_wraps_like_pallas(jax_probes):
    """More chunks than windows: chunk c reads window c % (N // window) in
    both."""
    window, n_chunks = 2048, 3         # 2 windows, chunk 2 wraps to window 0
    table, idx = _inputs(n_chunks, window, seed=7)
    total_j = float(jax_probes.make_onehot(window, n_chunks)(
        jnp.asarray(table), jnp.asarray(idx)))
    out = gather_window_sum_reference(torch.from_numpy(table),
                                      torch.from_numpy(idx), window, T)
    rows = idx + np.repeat(np.array([0, 1, 0]) * window, T)
    assert abs(float(out.sum()) - total_j) <= _tol(table, rows)
    _held(out, table, rows, n_chunks)


@pytest.mark.parametrize("outstanding", [4, 8])
def test_rows_probe_matches_pallas(jax_probes, outstanding):
    n_chunks = 2                       # the interpret loop is 1024 copies a chunk
    table, idx = _inputs(n_chunks, ROWS, seed=outstanding)
    total_j = float(jax_probes.make_row_dma(n_chunks, outstanding)(
        jnp.asarray(table), jnp.asarray(idx)))
    out = gather_rows_sum(torch.from_numpy(table), torch.from_numpy(idx), T,
                          outstanding)
    assert torch.equal(out, gather_rows_sum_reference(
        torch.from_numpy(table), torch.from_numpy(idx), T))
    assert abs(float(out.sum()) - total_j) <= _tol(table, idx)
    _held(out, table, idx, n_chunks)


def test_block_is_the_window_of_chunk_height():
    table, idx = _inputs(6, T, seed=3)   # 6 chunks over 4 blocks: two wrap
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    assert torch.equal(gather_block_sum(t, i, T),
                       gather_window_sum(t, i, T, T))
    rows = window_rows(i, ROWS, T, T)
    assert rows.dtype == torch.int64
    assert torch.equal(rows[4 * T: 5 * T], i[4 * T: 5 * T].long())  # block 0
    assert torch.equal(rows[5 * T:], i[5 * T:].long() + T)          # block 1


def test_small_chunks_and_odd_windows():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((300, 128)).astype(np.float32)
    chunk, window, n_chunks = 7, 90, 5      # 3 windows of 90 rows
    idx = rng.integers(0, window, chunk * n_chunks).astype(np.int32)
    out = gather_window_sum(torch.from_numpy(table), torch.from_numpy(idx),
                            window, chunk)
    rows = idx + np.repeat((np.arange(n_chunks) % 3) * window, chunk)
    np.testing.assert_allclose(out.numpy(),
                               _numpy_chunks(table, rows, n_chunks),
                               rtol=1e-5, atol=1e-4)


def test_out_of_range_indices_are_clamped():
    table, idx = _inputs(1, 256)
    t = torch.from_numpy(table)
    wild = torch.from_numpy(idx).clone()
    wild[::5] = -3
    wild[1::5] = 10 ** 6
    for call, hi in ((lambda i: gather_block_sum(t, i, T), T),
                     (lambda i: gather_window_sum(t, i, 256, T), 256),
                     (lambda i: gather_rows_sum(t, i, T), ROWS)):
        assert torch.equal(call(wild), call(wild.clamp(0, hi - 1)))


def _good():
    table, idx = _inputs(2, 256)
    return torch.from_numpy(table), torch.from_numpy(idx)


CALLS = {"block": lambda t, i: gather_block_sum(t, i, T),
         "window": lambda t, i: gather_window_sum(t, i, 256, T),
         "rows": lambda t, i: gather_rows_sum(t, i, T)}


@pytest.mark.parametrize("kernel", sorted(CALLS))
def test_wrappers_refuse_what_the_kernels_do_not_take(kernel):
    call = CALLS[kernel]
    t, i = _good()
    assert call(t, i).shape == (2,)
    with pytest.raises(TypeError, match="float32"):
        call(t.double(), i)
    with pytest.raises(TypeError, match="int32"):
        call(t, i.long())
    with pytest.raises(ValueError, match="contiguous"):
        call(t.T.contiguous().T, i)
    with pytest.raises(ValueError, match="contiguous"):
        call(t, torch.stack([i, i], 1)[:, 0])
    with pytest.raises(ValueError, match="128"):
        call(t[:, :64].contiguous(), i)
    with pytest.raises(ValueError, match="multiple"):
        call(t, i[:-1].contiguous())
    if kernel != "rows":       # a table lower than one block or window
        with pytest.raises(ValueError, match="rows"):
            call(t[:200].contiguous(), i)


def test_rows_wrapper_takes_only_the_built_ring_depths():
    t, i = _good()
    with pytest.raises(ValueError, match="outstanding"):
        gather_rows_sum(t, i, T, outstanding=3)


@pytest.mark.parametrize("stage", mg.STAGES)
def test_probe_script_runs_every_stage_on_the_cpu(stage):
    rep = mg.run(stage, device="cpu", rows=ROWS, gathered=2 * T, iters=1,
                 warmup=0)
    n = T if stage == "D" else 2 * T
    assert rep["rows_gathered"] == n and rep["calls"] == 2
    assert rep["ms"] > 0 and np.isfinite(rep["total"])
    assert rep["ns_per_row"] == pytest.approx(rep["ms"] * 1e6 / n)
    # the same seed gives the same table and indices: the total is that of
    # the plain version on them
    gen = torch.Generator().manual_seed(0)
    t = torch.randn((ROWS, 128), generator=gen)
    hi = {"A": ROWS, "B": T, "D": ROWS}.get(stage) or int(stage[1:])
    idx = torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32)
    window = {"A": ROWS, "D": ROWS, "B": T}.get(stage) or int(stage[1:])
    want = float(t[window_rows(idx, ROWS, window, T)].double().sum())
    assert rep["total"] == pytest.approx(want, abs=ATOL + RTOL * float(
        t[window_rows(idx, ROWS, window, T)].abs().sum()))


def test_probe_script_main_prints_reports_and_one_json_line(capsys):
    result = mg.main(["all", "--device", "cpu", "--rows", str(ROWS),
                      "--gathered", str(T), "--iters", "1", "--warmup", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(mg.STAGES) + 1
    assert all("ns/row" in ln and " ms " in ln for ln in lines[:-1])
    assert json.loads(lines[-1]) == result
    assert [s["stage"] for s in result["stages"]] == list(mg.STAGES)
    assert result["device"] == "cpu" and result["chunk"] == T


def test_probe_script_defaults_to_the_card_and_checks_sizes():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            mg.run("B")
    with pytest.raises(ValueError, match="multiple"):
        mg.run("B", device="cpu", rows=ROWS, gathered=1000)
    with pytest.raises(ValueError, match="unknown stage"):
        mg.run("C128", device="cpu", rows=ROWS, gathered=T)
    assert (mg.N, mg.E, mg.T, mg.WINDOWS) == (100_352, 3_145_728, 1024,
                                              (256, 512, 1024))


def test_jax_script_is_untouched_by_the_patches(jax_probes):
    """The fixture patches a fresh module object and ``pl.pallas_call``
    only for this test; the file itself keeps its sizes."""
    src = open(os.path.join(REPO, "scripts", "microbench_gather7.py")).read()
    assert "N = 100_352" in src and "E = 3_145_728" in src
    assert jax_probes.N == ROWS and jax_probes.E == mg.E


# ---------------------------------------------------------------------------
# The cut of the redesigned K4 and K5: per (chunk, column tile, run of
# slots) partials added in order. Tolerance: fp32 sums of the same terms in
# another order, ATOL + RTOL·Σ|terms| a chunk, as above.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_cols", [4, 16, 32, 128])
@pytest.mark.parametrize("window", [256, 512])
def test_tiled_reference_matches_plain_and_pallas(jax_probes, window,
                                                  tile_cols):
    n_chunks = 4
    table, idx = _inputs(n_chunks, window, seed=window + tile_cols)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    out = gather_window_sum_tiled_reference(t, i, window, T, tile_cols,
                                            segments=2)
    rows = idx + np.repeat(
        (np.arange(n_chunks) % (ROWS // window)) * window, T)
    _held(out, table, rows, n_chunks)
    plain = gather_window_sum_reference(t, i, window, T)
    scale = gather_window_sum_reference(t.abs(), i, window, T)
    assert float(((out - plain).abs() / (ATOL + RTOL * scale)).max()) <= 1.0
    total_j = float(jax_probes.make_onehot(window, n_chunks)(
        jnp.asarray(table), jnp.asarray(idx)))
    assert abs(float(out.sum()) - total_j) <= _tol(table, rows)


def test_tiled_reference_cut_as_k4_matches_pallas(jax_probes):
    n_chunks = 4
    table, idx = _inputs(n_chunks, T, seed=11)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    tile_cols, segments = gk.block_plan(ROWS, n_chunks, T)
    # one chunk a block: its 32 warps take a run of 32 slots each
    assert (tile_cols, segments) == (32, 32)
    out = gather_window_sum_tiled_reference(t, i, T, T, tile_cols, segments)
    rows = idx + np.repeat(np.arange(n_chunks) * T, T)
    _held(out, table, rows, n_chunks)
    total_j = float(jax_probes.make_dyn_gather(n_chunks)(
        jnp.asarray(table), jnp.asarray(idx)))
    assert abs(float(out.sum()) - total_j) <= _tol(table, rows)


# (n_rows, window, chunk, n_chunks): more chunks than windows and not a
# multiple of them; fewer chunks than windows (windows that serve none);
# rows past the last whole window; chunks of 1 to 4096 slots
UNEVEN = [(3 * 256 + 77, 256, 1024, 3 * 3 + 1),
          (9 * 32 + 77, 32, 31, 4),
          (5 * 1024 + 77, 1024, 4096, 5),
          (2 * 4096 + 77, 4096, 1, 7),
          (80, 1, 5, 3 * 80 + 1),
          (700, 90, 7, 23)]


@pytest.mark.parametrize("tile_cols", [4, 16, 32, 128])
@pytest.mark.parametrize("n_rows,window,chunk,n_chunks", UNEVEN)
def test_tiled_reference_on_uneven_groups(n_rows, window, chunk, n_chunks,
                                          tile_cols):
    rng = np.random.default_rng(n_rows + chunk)
    table = rng.standard_normal((n_rows, 128)).astype(np.float32)
    idx = rng.integers(-3, window + 3, chunk * n_chunks).astype(np.int32)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    plan = gk.window_plan(n_rows, n_chunks, window, chunk)
    out = gather_window_sum_tiled_reference(t, i, window, chunk, tile_cols,
                                            plan[1])
    rows = window_rows(i, n_rows, window, chunk).numpy()
    assert rows.max() < (n_rows // window) * window   # the tail is not read
    _held(out, table, rows, n_chunks)
    # the kernel's own cut (its tile width and runs) agrees too
    own = gather_window_sum_tiled_reference(t, i, window, chunk)
    _held(own, table, rows, n_chunks)


@pytest.mark.parametrize("window,cols", [(1, 32), (90, 32), (256, 32),
                                         (1024, 32), (1816, 32), (1817, 16),
                                         (2048, 16), (4096, 8)])
def test_window_tiles_are_32_columns_where_they_fit(window, cols):
    assert gk.window_tile_cols(window) == cols
    assert window * cols * 4 <= gk.MAX_TILE_BYTES


def test_plans_at_the_probe_sizes():
    """One item a warp at the probe script's sizes: W = 256 serves ~8
    chunks a window over 16 warps, so its chunks are cut in two; the rest
    serve 16 or more chunks (K4: ~31 over 32 warps)."""
    n_chunks = mg.E // mg.T
    assert [gk.window_plan(mg.N, n_chunks, w) for w in mg.WINDOWS] == [
        (32, 2), (32, 1), (32, 1)]
    assert gk.block_plan(mg.N, n_chunks) == (32, 1)
    # runs are never empty and never shorter than 32 slots, unless the chunk is
    for n_rows, window, chunk, n_c in UNEVEN:
        _, segs = gk.window_plan(n_rows, n_c, window, chunk)
        seg_len = -(-chunk // segs)
        assert (segs - 1) * seg_len < chunk
        assert seg_len >= min(32, chunk)


def test_plans_and_tiled_reference_take_no_chunk():
    t = torch.from_numpy(_inputs(1, 256)[0])
    none = torch.zeros(0, dtype=torch.int32)
    # no chunk: a plan all the same (the kernels then start nothing)
    assert gk.window_plan(ROWS, 0, 256)[0] == gk.block_plan(ROWS, 0)[0] == 32
    assert gather_window_sum_tiled_reference(t, none, 256).shape == (0,)


def test_window_wrapper_refuses_a_tile_it_does_not_take():
    t, i = _good()
    with pytest.raises(ValueError, match="tile_cols"):
        gather_window_sum(t, i, 256, T, tile_cols=24)
    with pytest.raises(ValueError, match="tile_cols"):
        gather_window_sum(t, i, 4096 // 4 * 4, T, tile_cols=128)


# ---------------------------------------------------------------------------
# The cut of the redesigned K6: (chunk, run of slots) items split evenly
# over every warp of a grid that fills the card, each warp a contiguous
# range of slots; partials added in run order. Tolerance as above.
# ---------------------------------------------------------------------------

# (n_chunks, chunk, SMs, blocks a SM): the probe's stage D at the depths'
# occupancies, chunks of 1 to 4096 slots, fewer chunks than SMs, as many,
# and a count that is a multiple of neither, no chunk at all
ROWS_SHAPES = [(192, 1024, 132, b) for b in (1, 4, 5, 6, 8)] + [
    (3072, 1024, 132, 6), (5, 4096, 132, 6), (132, 31, 132, 6),
    (403, 1, 132, 6), (66, 4096, 132, 7), (3, 1000, 4, 2), (1, 1, 1, 1),
    (0, 1024, 132, 6)]


@pytest.mark.parametrize("n_chunks,chunk,n_sms,per_sm", ROWS_SHAPES)
def test_rows_plan_covers_every_slot_once_in_order(n_chunks, chunk, n_sms,
                                                   per_sm):
    grid, segments = gk.rows_plan(n_chunks, chunk, n_sms, per_sm)
    assert grid == n_sms * per_sm and 1 <= segments <= chunk
    seg_len = -(-chunk // segments)
    assert (segments - 1) * seg_len < chunk          # no run empty
    assert seg_len >= min(gk.ROWS_MIN_RUN, chunk)
    ranges = gk.rows_warp_slots(n_chunks, chunk, grid, segments)
    assert len(ranges) == grid * gk.ROWS_WARPS
    # warp by warp, the ranges tile [0, n_chunks * chunk) in slot order
    ends = [0] + [hi for _, hi in ranges]
    assert [lo for lo, _ in ranges] == ends[:-1]
    assert ends[-1] == n_chunks * chunk
    assert all(hi >= lo for lo, hi in ranges)


@pytest.mark.parametrize("per_sm", range(1, 9))
def test_rows_plan_spreads_the_probe_evenly(per_sm):
    """Stage D (192 chunks of 1024 slots) on 132 SMs: no block's rows
    exceed another's by more than one run (and the rounding of the last
    run of a chunk); every SM's blocks together within one run of each
    other, where one block a chunk gave 60 SMs two chunks and 72 one."""
    n_chunks, chunk, n_sms = 192, 1024, 132
    grid, segments = gk.rows_plan(n_chunks, chunk, n_sms, per_sm)
    seg_len = -(-chunk // segments)
    rounding = segments * seg_len - chunk
    ranges = gk.rows_warp_slots(n_chunks, chunk, grid, segments)
    w = gk.ROWS_WARPS
    blocks = [sum(hi - lo for lo, hi in ranges[b * w:(b + 1) * w])
              for b in range(grid)]
    assert max(blocks) - min(blocks) <= seg_len + rounding
    if rounding == 0:
        assert max(blocks) - min(blocks) <= seg_len
    # the busiest warp has at most one run more than the mean warp
    longest = max(hi - lo for lo, hi in ranges)
    assert longest <= n_chunks * chunk / len(ranges) + seg_len
    # one resident wave: SM s runs blocks s, s + 132, ... (any even spread)
    per_sm_rows = [sum(blocks[s::n_sms]) for s in range(n_sms)]
    assert max(per_sm_rows) < 2 * min(per_sm_rows)


def test_rows_plan_cuts_ranges_inside_chunks():
    """Where chunks are long and few, warps' ranges start and end inside a
    chunk; chunks of one slot are never cut."""
    grid, segments = gk.rows_plan(132, 1024, 132, 6)
    ranges = gk.rows_warp_slots(132, 1024, grid, segments)
    assert segments > 1
    assert any(lo % 1024 and hi % 1024 for lo, hi in ranges if hi > lo)
    assert gk.rows_plan(403, 1, 132, 6)[1] == 1


@pytest.mark.parametrize("segments", [1, 3, 32])
def test_rows_segmented_reference_matches_plain_and_pallas(jax_probes,
                                                           segments):
    n_chunks = 2                  # the interpret loop is 1024 copies a chunk
    table, idx = _inputs(n_chunks, ROWS, seed=40 + segments)
    idx[::97] = -5                # clamped into the table, as the kernel does
    idx[1::97] = ROWS
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    out = gk.gather_rows_sum_segmented_reference(t, i, T, segments)
    rows = np.clip(idx, 0, ROWS - 1)
    _held(out, table, rows, n_chunks)
    plain = gather_rows_sum_reference(t, i, T)
    scale = gather_rows_sum_reference(t.abs(), i, T)
    assert float(((out - plain).abs() / (ATOL + RTOL * scale)).max()) <= 1.0
    total_j = float(jax_probes.make_row_dma(n_chunks, 8)(
        jnp.asarray(table), jnp.asarray(rows.astype(np.int32))))
    assert abs(float(out.sum()) - total_j) <= _tol(table, rows)


@pytest.mark.parametrize("n_chunks,chunk,n_sms,per_sm", ROWS_SHAPES[-6:-1])
def test_rows_segmented_reference_on_uneven_cuts(n_chunks, chunk, n_sms,
                                                 per_sm):
    rng = np.random.default_rng(n_chunks + chunk)
    table = rng.standard_normal((700, 128)).astype(np.float32)
    table *= 10.0 ** rng.integers(-3, 4, (700, 1))
    idx = rng.integers(-3, 703, n_chunks * chunk).astype(np.int32)
    segments = gk.rows_plan(n_chunks, chunk, n_sms, per_sm)[1]
    out = gk.gather_rows_sum_segmented_reference(
        torch.from_numpy(table), torch.from_numpy(idx), chunk, segments)
    _held(out, table, np.clip(idx, 0, 699), n_chunks)


@pytest.mark.parametrize("n_chunks", [1, 7, 192, 5000])
def test_rows_plan_leaves_no_run_empty(n_chunks):
    """Every cut the plan gives passes the kernel's entry check: its
    ``segments - 1`` runs of ``ceil(chunk / segments)`` slots fall short of
    the chunk, so no run is empty (the entry point refuses a cut that
    leaves one, such as 10 slots in 6 runs of 2)."""
    for chunk in list(range(1, 300)) + [1000, 1023, 1024, 1025, 4095, 4096]:
        segments = gk.rows_plan(n_chunks, chunk, 132,
                                gk.ROWS_BLOCKS_PER_SM)[1]
        assert 1 <= segments <= chunk
        assert (segments - 1) * -(-chunk // segments) < chunk
