"""K4, K5 and K6, the gather probes, with their plain versions — the port of
the three Pallas kernels of ``scripts/microbench_gather7.py``.

Each sums, per chunk of ``chunk`` slots, the 128-float table rows that the
chunk's indices name, and differs in where the rows come from:

* K4 ``gather_block_sum`` (``csrc/gather_block.cu``, replaces
  ``make_dyn_gather``, ``scripts/microbench_gather7.py:73``): from the
  chunk's own block of ``chunk`` rows, by plain indexed loads that L1 serves;
* K5 ``gather_window_sum`` (``csrc/gather_window.cu``, replaces
  ``make_onehot``, ``:100``): from a window of ``window`` rows staged in
  shared memory;
* K6 ``gather_rows_sum`` (``csrc/gather_rows_async.cu``, replaces
  ``make_row_dma``, ``:129``): from anywhere in the table, every row by its
  own ``cp.async`` copy (16 bytes a lane), ``outstanding`` in flight per
  warp.

Chunk ``c`` of K4 reads block ``c % (n_rows // chunk)`` and chunk ``c`` of
K5 window ``c % (n_rows // window)``. The Pallas ``make_onehot`` wraps the
same way; ``make_dyn_gather`` takes block ``c`` and is not defined past the
table's end, so the two agree wherever the Pallas one is in range. An index
outside its range is clamped into it, in the kernels and the plain versions
alike, as JAX clamps an out-of-range read: no load leaves the table.

K4 and K5 work by window (or block) and column tile, not by chunk
(``csrc/gather_tiles.cuh``): a thread block owns ``tile_cols`` columns of
one window and serves every chunk that reads the window, each chunk cut
into ``segments`` runs of slots, one warp a (chunk, segment); a second small
kernel adds a chunk's partials in (tile, segment) order.
:func:`window_plan` and :func:`block_plan` give that cut from the shapes
alone, and :func:`gather_window_sum_tiled_reference` computes it in plain
PyTorch for the CPU tests.

K6 works by slot range: each chunk is cut into ``segments`` runs of slots
in the same way, and the (chunk, run) items, in slot order, are split
evenly over every warp of a grid that fills the card, so a warp's range
may start and end inside a chunk; a second small kernel adds a chunk's
partials in run order. :func:`rows_plan` gives the grid and the cut,
:func:`rows_warp_slots` each warp's slots, and
:func:`gather_rows_sum_segmented_reference` the sum in that order.

The kernels are built with the others into one library
(``segment_kernels.build``). Every wrapper takes its plain version only for
CPU tensors; a CUDA tensor launches the kernel or raises. Types, shapes and
contiguity are checked on either device. The probes have no gradient, so
there is no autograd Function.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import segment_kernels as sk

ROW_WIDTH = 128          # floats a table row: 32 lanes x float4
MAX_CHUNK = 4096         # the chunk K5 and K6 take at most
MAX_WINDOW = 4096        # K5: a 128 KB tile holds >= 8 columns of the window
OUTSTANDING = (1, 2, 4, 8)   # K6's ring depths, one instantiation each
ROWS_WARPS = 8           # warps a thread block of K6
# K6's blocks a SM at most: two to five measured alike on the H100, six
# (all that fit at depth 8) slower, one far slower (PERF.md, PR 8)
ROWS_BLOCKS_PER_SM = 4
ROWS_MIN_RUN = 32        # K6 cuts no run of slots shorter (unless the chunk is)
# K5: a tile is TILE_COLS_DEFAULT columns of the window's rows (128 bytes a
# row: a quarter-warp's float4 reads cover the 32 banks once), narrower
# where those rows pass the MAX_TILE_BYTES of shared memory a block may
# have; the fastest width at every probe window (chip_smoke.py's sweep)
TILE_COLS_DEFAULT = 32
MAX_TILE_BYTES = 232_448
TILE_COLS = (8, 16, 32, 64, 128)
BLOCK_TILE_COLS = 32     # K4: column quarters, one 128-byte L1 line a row
WINDOW_WARPS, BLOCK_WARPS = 16, 32   # warps a thread block of K5, K4


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with the gather entry points' signatures set."""
    lib = sk.load_library()
    ptrs = [ctypes.c_void_p] * 3
    started = [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    # table idx out partial | n_rows n_chunks chunk segments max_l1
    lib.gather_block_sum_f32.argtypes = ptrs + [ctypes.c_void_p] + [
        ctypes.c_int] * 5 + started
    # table idx out partial | n_rows n_chunks chunk window tile_cols segments
    lib.gather_window_sum_f32.argtypes = ptrs + [ctypes.c_void_p] + [
        ctypes.c_int] * 6 + started
    # table idx out partial | n_rows n_chunks chunk segments grid
    # outstanding
    lib.gather_rows_sum_f32.argtypes = ptrs + [ctypes.c_void_p] + [
        ctypes.c_int] * 6 + started
    lib.gather_window_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.gather_block_blocks_per_sm.argtypes = []
    lib.gather_rows_blocks_per_sm.argtypes = [ctypes.c_int]
    for fn in (lib.gather_block_sum_f32, lib.gather_window_sum_f32,
               lib.gather_rows_sum_f32, lib.gather_window_blocks_per_sm,
               lib.gather_block_blocks_per_sm,
               lib.gather_rows_blocks_per_sm):
        fn.restype = ctypes.c_int
    lib.gather_error_string.argtypes = [ctypes.c_int]
    lib.gather_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, table: torch.Tensor, idx: torch.Tensor, chunk: int,
           span: int) -> int:
    """Raise on what the kernels do not take; returns the chunk count.
    ``span`` is the number of table rows one chunk's indices range over."""
    if table.dtype != torch.float32:
        raise TypeError(f"{fn}: table must be float32, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{fn}: idx must be int32, got {idx.dtype}")
    if table.ndim != 2 or table.shape[1] != ROW_WIDTH:
        raise ValueError(f"{fn}: table must be [n_rows, {ROW_WIDTH}], got "
                         f"{tuple(table.shape)}")
    if idx.ndim != 1:
        raise ValueError(f"{fn}: idx must be 1-D, got {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"{fn}: idx is on {idx.device}, table on "
                         f"{table.device}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError(f"{fn}: table and idx must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError(f"{fn}: table must be 16-byte aligned (its rows are "
                         "read 16 bytes a lane)")
    if chunk <= 0 or idx.numel() % chunk:
        raise ValueError(f"{fn}: idx has {idx.numel()} entries, not a "
                         f"multiple of chunk={chunk}")
    if not 0 < span <= table.shape[0]:
        raise ValueError(f"{fn}: a chunk ranges over {span} rows, the table "
                         f"has {table.shape[0]}")
    if max(table.numel(), idx.numel()) >= 2 ** 31:
        raise ValueError(f"{fn}: int32 offsets overflow at this size")
    return idx.numel() // chunk


def _chunk_sums(table: torch.Tensor, rows: torch.Tensor,
                n_chunks: int) -> torch.Tensor:
    return table.index_select(0, rows).reshape(n_chunks, -1).sum(1)


def _launch(fn, name: str, key, table, n_chunks: int, call,
            per_chunk: int = 0) -> torch.Tensor:
    """Allocate the output (and, with ``per_chunk`` > 1, a scratch of that
    many partial floats a chunk behind it, in the same allocation), run
    ``call(lib, out, partial, started, stream)`` on the table's device and
    count the launch. ``started`` is a ctypes int that K4-K6's entry points
    (``per_chunk`` >= 1) set to the CUDA kernels they started; it lands in
    ``fn.cuda_kernels``. Kept lean: it runs on the host once a call."""
    scratch = n_chunks * per_chunk if per_chunk > 1 else 0
    buf = torch.empty(n_chunks + scratch, dtype=torch.float32,
                      device=table.device)
    if n_chunks == 0:
        return buf
    out = buf[:n_chunks] if scratch else buf
    partial = buf.data_ptr() + 4 * n_chunks if scratch else None
    started = ctypes.c_int(0)
    lib = _library()
    dev = table.device.index
    # the current stream's handle, without building a torch.cuda.Stream
    # object a call
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch.cuda.current_device():
        err = call(lib, out, partial, ctypes.byref(started), stream)
    else:
        with torch.cuda.device(dev):
            err = call(lib, out, partial, ctypes.byref(started), stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.gather_error_string(err).decode()})")
    fn.launches += 1
    fn.launches_by[key] += 1
    if per_chunk:
        fn.cuda_kernels = started.value
    return out


def window_rows(idx: torch.Tensor, n_rows: int, window: int,
                chunk: int = 1024) -> torch.Tensor:
    """The table row each slot names, int64: its index, clamped into
    ``[0, window)``, plus the first row of its chunk's window, chunk ``c``
    reading window ``c % (n_rows // window)``."""
    n_chunks = idx.numel() // chunk
    first = (torch.arange(n_chunks, device=idx.device)
             % (n_rows // window)) * window
    return idx.long().clamp(0, window - 1) + first.repeat_interleave(chunk)


def _segments(n_rows: int, n_chunks: int, chunk: int, span: int,
              warps: int) -> int:
    """Runs of slots a chunk is cut into so that a block's warps have an
    item each: the block of the window that serves the most chunks, ``m``,
    gets ``m · segments >= warps`` items, no run shorter than 32 slots
    (unless the chunk is), and no run empty."""
    m = max(-(-n_chunks // max(min(n_rows // span, n_chunks), 1)), 1)
    want = min(-(-warps // m), max(chunk // 32, 1))
    seg_len = -(-chunk // want)
    return -(-chunk // seg_len)


def window_tile_cols(window: int) -> int:
    """K5's tile width: ``TILE_COLS_DEFAULT`` columns, or the widest power
    of two below it (at least 8) whose ``window`` rows fit
    ``MAX_TILE_BYTES``."""
    cols = TILE_COLS_DEFAULT
    while cols > TILE_COLS[0] and window * cols * 4 > MAX_TILE_BYTES:
        cols //= 2
    return cols


def window_plan(n_rows: int, n_chunks: int, window: int, chunk: int = 1024,
                tile_cols: Optional[int] = None) -> Tuple[int, int]:
    """``(tile_cols, segments)`` of a K5 call: columns a block stages and
    runs of slots a chunk is cut into (``csrc/gather_tiles.cuh``)."""
    return (tile_cols or window_tile_cols(window),
            _segments(n_rows, n_chunks, chunk, window, WINDOW_WARPS))


def block_plan(n_rows: int, n_chunks: int,
               chunk: int = 1024) -> Tuple[int, int]:
    """``(tile_cols, segments)`` of a K4 call: its column quarters and runs
    of slots a chunk is cut into."""
    return (BLOCK_TILE_COLS,
            _segments(n_rows, n_chunks, chunk, chunk, BLOCK_WARPS))


def gather_window_sum_tiled_reference(table: torch.Tensor, idx: torch.Tensor,
                                      window: int, chunk: int = 1024,
                                      tile_cols: Optional[int] = None,
                                      segments: Optional[int] = None
                                      ) -> torch.Tensor:
    """K5 (and, with ``window = chunk``, ``tile_cols`` 32 and K4's
    segments, K4) in plain PyTorch *the way the kernels cut it*: for every
    chunk one partial a (column tile, run of slots), each the sum of its
    rows' tile columns, then a chunk's partials added in (tile, run) order.
    ``tile_cols`` and ``segments`` default to :func:`window_plan`'s. For the
    CPU tests: it holds the whole ``[E, 128]`` gather."""
    n_chunks = idx.numel() // chunk
    plan = window_plan(table.shape[0], n_chunks, window, chunk, tile_cols)
    tile_cols, segments = tile_cols or plan[0], segments or plan[1]
    rows = window_rows(idx, table.shape[0], window, chunk)
    g = table.index_select(0, rows).view(n_chunks, chunk,
                                         ROW_WIDTH // tile_cols, tile_cols)
    seg_len = -(-chunk // segments)
    out = None
    for j in range(ROW_WIDTH // tile_cols):
        for s in range(segments):
            part = g[:, s * seg_len:(s + 1) * seg_len, j].sum((1, 2))
            out = part if out is None else out + part
    return out


def gather_block_sum_reference(table: torch.Tensor, idx: torch.Tensor,
                               chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of K4: ``index_select`` of the block's rows,
    reshape, ``sum``. The CPU path and the tests use it; on the card it is
    the yardstick of correctness only."""
    return gather_window_sum_reference(table, idx, chunk, chunk)


def gather_block_sum(table: torch.Tensor, idx: torch.Tensor,
                     chunk: int = 1024, *, max_l1: bool = True) -> torch.Tensor:
    """``out[c] = Σ_{s<chunk} Σ_f table[b·chunk + idx[c·chunk + s], f]`` with
    ``b = c % (n_rows // chunk)``: per-chunk sums ``[n_chunks]`` of the rows
    gathered inside each chunk's own block of the table.

    ``table`` float32 ``[n_rows, 128]``, ``idx`` int32 with values in
    ``[0, chunk)`` (others are clamped into it), both contiguous. CUDA
    tensors run K4 on the current stream; CPU tensors run
    :func:`gather_block_sum_reference`. ``max_l1`` sets the shared-memory
    carve-out to its least (else the CUDA driver's default); the gather sweep
    times both. Each launch adds one to
    ``gather_block_sum.launches`` and ``.launches_by[chunk]``;
    ``.cuda_kernels`` holds the CUDA kernels the last call started (2: the
    quarters, then their sums) and ``.kernel`` the name of the kernel it
    ran."""
    n_chunks = _check("gather_block_sum", table, idx, chunk, chunk)
    if not table.is_cuda:
        return gather_block_sum_reference(table, idx, chunk)
    tile_cols, segments = block_plan(table.shape[0], n_chunks, chunk)
    gather_block_sum.kernel = "block_quarters"
    return _launch(
        gather_block_sum, "gather_block_sum", chunk, table, n_chunks,
        lambda lib, out, part, started, stream: lib.gather_block_sum_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), part,
            table.shape[0], n_chunks, chunk, segments, int(max_l1),
            started, stream),
        per_chunk=ROW_WIDTH // tile_cols * segments)


def gather_window_sum_reference(table: torch.Tensor, idx: torch.Tensor,
                                window: int,
                                chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of K5: ``index_select`` of the window's rows,
    reshape, ``sum``. The CPU path and the tests use it; on the card it is
    the yardstick of correctness only."""
    return _chunk_sums(table, window_rows(idx, table.shape[0], window, chunk),
                       idx.numel() // chunk)


def gather_window_sum(table: torch.Tensor, idx: torch.Tensor, window: int,
                      chunk: int = 1024, *,
                      tile_cols: Optional[int] = None) -> torch.Tensor:
    """``out[c] = Σ_{s<chunk} Σ_f table[v·window + idx[c·chunk + s], f]`` with
    ``v = c % (n_rows // window)``: per-chunk sums ``[n_chunks]`` of the rows
    gathered from each chunk's window of the table.

    ``table`` float32 ``[n_rows, 128]``, ``idx`` int32 with values in
    ``[0, window)`` (others are clamped into it), both contiguous;
    ``window`` and ``chunk`` at most 4096. CUDA tensors run K5 on the
    current stream; CPU tensors run :func:`gather_window_sum_reference`.
    ``tile_cols``, the columns a block stages (a power of two from 8 to 128
    whose ``window`` rows fit 227 KB), is what the gather sweep varies;
    None takes :func:`window_tile_cols`. Each launch adds one to
    ``gather_window_sum.launches`` and ``.launches_by[window]``;
    ``.cuda_kernels`` holds the CUDA kernels the last call started (1, or 2
    when a chunk has more than one partial) and ``.kernel`` the name of the
    kernel it ran."""
    if tile_cols is not None and (tile_cols not in TILE_COLS or
                                  window * tile_cols * 4 > MAX_TILE_BYTES):
        raise ValueError(f"gather_window_sum: tile_cols must be one of "
                         f"{TILE_COLS} with window * tile_cols * 4 <= "
                         f"{MAX_TILE_BYTES} bytes, got {tile_cols} at "
                         f"window {window}")
    n_chunks = _check("gather_window_sum", table, idx, chunk, window)
    if not table.is_cuda:
        return gather_window_sum_reference(table, idx, window, chunk)
    if window > MAX_WINDOW or chunk > MAX_CHUNK:
        raise ValueError(f"gather_window_sum: the kernel takes window <= "
                         f"{MAX_WINDOW} and chunk <= {MAX_CHUNK}, got "
                         f"{window} and {chunk}")
    tile_cols, segments = window_plan(table.shape[0], n_chunks, window, chunk,
                                      tile_cols)
    gather_window_sum.kernel = "window_tiles"
    return _launch(
        gather_window_sum, "gather_window_sum", window, table, n_chunks,
        lambda lib, out, part, started, stream: lib.gather_window_sum_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), part,
            table.shape[0], n_chunks, chunk, window, tile_cols, segments,
            started, stream),
        per_chunk=ROW_WIDTH // tile_cols * segments)


def blocks_per_sm(kernel: str, window: int = 0, tile_cols: int = 0) -> int:
    """Thread blocks of K4 (``kernel="block"``) or K5 (``"window"``, at
    ``window`` and ``tile_cols``) that share one SM, as the CUDA runtime
    computes it: what the gather sweep records beside each time."""
    lib = _library()
    if kernel == "block":
        return lib.gather_block_blocks_per_sm()
    return lib.gather_window_blocks_per_sm(window, tile_cols)


def gather_rows_sum_reference(table: torch.Tensor, idx: torch.Tensor,
                              chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of K6: ``index_select`` over the whole table,
    reshape, ``sum``. The CPU path and the tests use it; on the card it is
    the yardstick of correctness only."""
    return _chunk_sums(table, idx.long().clamp(0, table.shape[0] - 1),
                       idx.numel() // chunk)


@functools.lru_cache(maxsize=256)
def rows_plan(n_chunks: int, chunk: int, n_sms: int, blocks_per_sm: int,
              warps: int = ROWS_WARPS) -> Tuple[int, int]:
    """``(grid, segments)`` of a K6 call: ``blocks_per_sm · n_sms`` thread
    blocks of ``warps`` warps, one wave over the whole card (``blocks_per_sm``
    no more than fit at once), and the runs of slots
    a chunk is cut into (``ceil(chunk / segments)`` slots each, the last
    shorter, none empty, none under ``ROWS_MIN_RUN`` slots unless the chunk
    is). Of the cuts, the one whose busiest warp has the fewest rows when
    the ``n_chunks · segments`` items are split evenly over the warps
    (:func:`rows_warp_slots`); the fewest runs among equals."""
    grid = max(n_sms * blocks_per_sm, 1)
    n_warps = grid * warps
    best = None
    for want in range(1, max(chunk // ROWS_MIN_RUN, 1) + 1):
        seg_len = -(-chunk // want)
        segments = -(-chunk // seg_len)
        longest = -(-n_chunks * segments // n_warps) * seg_len
        if best is None or longest < best[0]:
            best = (longest, segments)
    return grid, best[1]


def rows_warp_slots(n_chunks: int, chunk: int, grid: int, segments: int,
                    warps: int = ROWS_WARPS):
    """The slots ``[lo, hi)`` each of K6's ``grid · warps`` warps walks, in
    warp order (block-major): warp ``g`` of ``G`` takes the items
    ``[g·n // G, (g+1)·n // G)`` of the ``n = n_chunks · segments`` (chunk,
    run) items, whose slots are contiguous, as the kernel computes them."""
    n_items = n_chunks * segments
    n_warps = grid * warps
    seg_len = -(-chunk // segments)

    def slot(i):
        c, s = divmod(i, segments)
        return c * chunk + min(s * seg_len, chunk)

    return [(slot(g * n_items // n_warps), slot((g + 1) * n_items // n_warps))
            for g in range(n_warps)]


def gather_rows_sum_segmented_reference(table: torch.Tensor,
                                        idx: torch.Tensor, chunk: int,
                                        segments: int) -> torch.Tensor:
    """K6 in plain PyTorch *the way the kernel cuts it*: one partial a
    (chunk, run of ``ceil(chunk / segments)`` slots), each the sum of its
    rows, then a chunk's partials added in run order. For the CPU tests."""
    n_chunks = idx.numel() // chunk
    g = table.index_select(0, idx.long().clamp(0, table.shape[0] - 1))
    g = g.view(n_chunks, chunk, -1)
    seg_len = -(-chunk // segments)
    out = None
    for s in range(segments):
        part = g[:, s * seg_len:(s + 1) * seg_len].sum((1, 2))
        out = part if out is None else out + part
    return out if out is not None else table.new_zeros(0)


@functools.lru_cache(maxsize=None)
def rows_occupancy(device_index: int, outstanding: int) -> Tuple[int, int]:
    """``(SMs, K6 thread blocks that share one SM)`` on a card, as the CUDA
    runtime computes them for this depth; once per process."""
    n_sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    with torch.cuda.device(device_index):
        per_sm = _library().gather_rows_blocks_per_sm(outstanding)
    if per_sm < 1:
        raise RuntimeError(f"gather_rows_sum: the occupancy query failed for "
                           f"outstanding={outstanding}")
    return n_sms, per_sm


def gather_rows_sum(table: torch.Tensor, idx: torch.Tensor,
                    chunk: int = 1024, outstanding: int = 8) -> torch.Tensor:
    """``out[c] = Σ_{s<chunk} Σ_f table[idx[c·chunk + s], f]``: per-chunk
    sums ``[n_chunks]`` of rows named anywhere in the table, each fetched by
    its own asynchronous copy with ``outstanding`` copies in flight per warp.

    ``table`` float32 ``[n_rows, 128]``, ``idx`` int32 with values in
    ``[0, n_rows)`` (others are clamped into it), both contiguous; ``chunk``
    at most 4096; ``outstanding`` one of 1, 2, 4, 8. CUDA tensors run K6 on
    the current stream, its work cut by :func:`rows_plan`; CPU tensors run
    :func:`gather_rows_sum_reference`. Its grid is ``ROWS_BLOCKS_PER_SM``
    thread blocks a SM, or fewer where fewer fit. Each launch adds one to ``gather_rows_sum.launches`` and
    ``.launches_by[outstanding]``; ``.cuda_kernels`` holds the CUDA kernels
    the last call started (1, or 2 when a chunk is cut into runs),
    ``.kernel`` the name of the kernel it ran and ``.plan`` its
    ``(grid, segments)``."""
    if outstanding not in OUTSTANDING:
        raise ValueError(f"gather_rows_sum: outstanding must be one of "
                         f"{OUTSTANDING}, got {outstanding}")
    n_chunks = _check("gather_rows_sum", table, idx, chunk, table.shape[0])
    if not table.is_cuda:
        return gather_rows_sum_reference(table, idx, chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"gather_rows_sum: the kernel takes chunk <= "
                         f"{MAX_CHUNK}, got {chunk}")
    n_sms, fit = rows_occupancy(table.device.index, outstanding)
    grid, segments = rows_plan(n_chunks, chunk, n_sms,
                               min(fit, ROWS_BLOCKS_PER_SM))
    gather_rows_sum.kernel = "rows_ranges"
    gather_rows_sum.plan = (grid, segments)
    return _launch(
        gather_rows_sum, "gather_rows_sum", outstanding, table, n_chunks,
        lambda lib, out, part, started, stream: lib.gather_rows_sum_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), part,
            table.shape[0], n_chunks, chunk, segments, grid, outstanding,
            started, stream),
        per_chunk=segments)


for _fn in (gather_block_sum, gather_window_sum, gather_rows_sum):
    _fn.launches = 0
    _fn.launches_by = collections.Counter()
    sk.COUNTED_WRAPPERS.append(_fn)
for _fn in (gather_block_sum, gather_window_sum, gather_rows_sum):
    _fn.cuda_kernels = 0
    _fn.kernel = None
gather_rows_sum.plan = None
