"""K4, K5 and K6, the gather probes, with their plain versions — the port of
the three Pallas kernels of ``scripts/microbench_gather7.py``.

Each sums, per chunk of ``chunk`` slots, the 128-float table rows that the
chunk's indices name, and differs in where the rows come from:

* K4 ``gather_block_sum`` (``csrc/gather_block.cu``, replaces
  ``make_dyn_gather``, ``scripts/microbench_gather7.py:73``): from the
  chunk's own block of ``chunk`` rows, by plain indexed loads;
* K5 ``gather_window_sum`` (``csrc/gather_window.cu``, replaces
  ``make_onehot``, ``:100``): from a window of ``window`` rows staged in
  shared memory;
* K6 ``gather_rows_sum`` (``csrc/gather_rows_async.cu``, replaces
  ``make_row_dma``, ``:129``): from anywhere in the table, every row by its
  own ``cp.async`` copy, ``outstanding`` in flight per warp.

Chunk ``c`` of K4 reads block ``c % (n_rows // chunk)`` and chunk ``c`` of
K5 window ``c % (n_rows // window)``. The Pallas ``make_onehot`` wraps the
same way; ``make_dyn_gather`` takes block ``c`` and is not defined past the
table's end, so the two agree wherever the Pallas one is in range. An index
outside its range is clamped into it, in the kernels and the plain versions
alike, as JAX clamps an out-of-range read: no load leaves the table.

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

import torch

from . import segment_kernels as sk

ROW_WIDTH = 128          # floats a table row: 32 lanes x float4
MAX_CHUNK = 4096         # K5 and K6 keep a chunk's indices in shared memory
MAX_WINDOW = 4096        # K5: a 64 KB tile holds >= 4 columns of the window
OUTSTANDING = (1, 2, 4, 8)   # K6's ring depths, one instantiation each


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with the gather entry points' signatures set."""
    lib = sk.load_library()
    ptrs = [ctypes.c_void_p] * 3
    lib.gather_block_sum_f32.argtypes = ptrs + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.gather_window_sum_f32.argtypes = ptrs + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.gather_rows_sum_f32.argtypes = ptrs + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for fn in (lib.gather_block_sum_f32, lib.gather_window_sum_f32,
               lib.gather_rows_sum_f32):
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


def _launch(fn, name: str, key, table, n_chunks: int, call) -> torch.Tensor:
    """Allocate the output, run ``call(lib, out, stream)`` on the table's
    device and count the launch."""
    out = torch.empty(n_chunks, dtype=torch.float32, device=table.device)
    if n_chunks == 0:
        return out
    lib = _library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = call(lib, out, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.gather_error_string(err).decode()})")
    fn.launches += 1
    fn.launches_by[key] += 1
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


def gather_block_sum_reference(table: torch.Tensor, idx: torch.Tensor,
                               chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of K4: ``index_select`` of the block's rows,
    reshape, ``sum``. The CPU path and the tests use it; on the card it is
    the yardstick of correctness only."""
    return gather_window_sum_reference(table, idx, chunk, chunk)


def gather_block_sum(table: torch.Tensor, idx: torch.Tensor,
                     chunk: int = 1024) -> torch.Tensor:
    """``out[c] = Σ_{s<chunk} Σ_f table[b·chunk + idx[c·chunk + s], f]`` with
    ``b = c % (n_rows // chunk)``: per-chunk sums ``[n_chunks]`` of the rows
    gathered inside each chunk's own block of the table.

    ``table`` float32 ``[n_rows, 128]``, ``idx`` int32 with values in
    ``[0, chunk)`` (others are clamped into it), both contiguous. CUDA
    tensors run K4 on the current stream; CPU tensors run
    :func:`gather_block_sum_reference`. Each launch adds one to
    ``gather_block_sum.launches`` and ``.launches_by[chunk]``."""
    n_chunks = _check("gather_block_sum", table, idx, chunk, chunk)
    if not table.is_cuda:
        return gather_block_sum_reference(table, idx, chunk)
    return _launch(
        gather_block_sum, "gather_block_sum", chunk, table, n_chunks,
        lambda lib, out, stream: lib.gather_block_sum_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), table.shape[0],
            n_chunks, chunk, stream))


def gather_window_sum_reference(table: torch.Tensor, idx: torch.Tensor,
                                window: int,
                                chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of K5: ``index_select`` of the window's rows,
    reshape, ``sum``. The CPU path and the tests use it; on the card it is
    the yardstick of correctness only."""
    return _chunk_sums(table, window_rows(idx, table.shape[0], window, chunk),
                       idx.numel() // chunk)


def gather_window_sum(table: torch.Tensor, idx: torch.Tensor, window: int,
                      chunk: int = 1024) -> torch.Tensor:
    """``out[c] = Σ_{s<chunk} Σ_f table[v·window + idx[c·chunk + s], f]`` with
    ``v = c % (n_rows // window)``: per-chunk sums ``[n_chunks]`` of the rows
    gathered from each chunk's window of the table.

    ``table`` float32 ``[n_rows, 128]``, ``idx`` int32 with values in
    ``[0, window)`` (others are clamped into it), both contiguous;
    ``window`` and ``chunk`` at most 4096. CUDA tensors run K5 on the
    current stream; CPU tensors run :func:`gather_window_sum_reference`.
    Each launch adds one to ``gather_window_sum.launches`` and
    ``.launches_by[window]``."""
    n_chunks = _check("gather_window_sum", table, idx, chunk, window)
    if not table.is_cuda:
        return gather_window_sum_reference(table, idx, window, chunk)
    if window > MAX_WINDOW or chunk > MAX_CHUNK:
        raise ValueError(f"gather_window_sum: the kernel takes window <= "
                         f"{MAX_WINDOW} and chunk <= {MAX_CHUNK}, got "
                         f"{window} and {chunk}")
    return _launch(
        gather_window_sum, "gather_window_sum", window, table, n_chunks,
        lambda lib, out, stream: lib.gather_window_sum_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), table.shape[0],
            n_chunks, chunk, window, stream))


def gather_rows_sum_reference(table: torch.Tensor, idx: torch.Tensor,
                              chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of K6: ``index_select`` over the whole table,
    reshape, ``sum``. The CPU path and the tests use it; on the card it is
    the yardstick of correctness only."""
    return _chunk_sums(table, idx.long().clamp(0, table.shape[0] - 1),
                       idx.numel() // chunk)


def gather_rows_sum(table: torch.Tensor, idx: torch.Tensor,
                    chunk: int = 1024, outstanding: int = 8) -> torch.Tensor:
    """``out[c] = Σ_{s<chunk} Σ_f table[idx[c·chunk + s], f]``: per-chunk
    sums ``[n_chunks]`` of rows named anywhere in the table, each fetched by
    its own asynchronous copy with ``outstanding`` copies in flight per warp.

    ``table`` float32 ``[n_rows, 128]``, ``idx`` int32 with values in
    ``[0, n_rows)`` (others are clamped into it), both contiguous; ``chunk``
    at most 4096; ``outstanding`` one of 1, 2, 4, 8. CUDA tensors run K6 on
    the current stream; CPU tensors run :func:`gather_rows_sum_reference`. Each launch adds one to
    ``gather_rows_sum.launches`` and ``.launches_by[outstanding]``."""
    if outstanding not in OUTSTANDING:
        raise ValueError(f"gather_rows_sum: outstanding must be one of "
                         f"{OUTSTANDING}, got {outstanding}")
    n_chunks = _check("gather_rows_sum", table, idx, chunk, table.shape[0])
    if not table.is_cuda:
        return gather_rows_sum_reference(table, idx, chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"gather_rows_sum: the kernel takes chunk <= "
                         f"{MAX_CHUNK}, got {chunk}")
    return _launch(
        gather_rows_sum, "gather_rows_sum", outstanding, table, n_chunks,
        lambda lib, out, stream: lib.gather_rows_sum_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), table.shape[0],
            n_chunks, chunk, outstanding, stream))


for _fn in (gather_block_sum, gather_window_sum, gather_rows_sum):
    _fn.launches = 0
    _fn.launches_by = collections.Counter()
    sk.COUNTED_WRAPPERS.append(_fn)
