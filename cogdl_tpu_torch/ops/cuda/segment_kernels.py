"""K1 (the CSR SpMM), K2 (the accumulating CSR SpMM) and K3 (the fused GAT
attention pass), with their plain versions, autograd rules and loader — the
port of ``cogdl_tpu/ops/pallas/segment_kernels.py`` for the GCN, GAT and
products-scale slices.

K1 (``cogdl_tpu_torch/csrc/spmm_csr.cu``) replaces the Pallas
``sorted_segment_matmul`` (``cogdl_tpu/ops/pallas/segment_kernels.py:294``).
It computes ``out[r] = Σ_{e in row r} w[e] · x[col[e]]`` over a CSR
structure with the gather fused in.

K2 (``cogdl_tpu_torch/csrc/spmm_csr_accum.cu``) replaces
``sorted_segment_matmul_accum`` (``segment_kernels.py:244``): the same sum
added in place to a running output, ``acc[r] += Σ …``, one call per source
panel of the panel-major CSR that ``device_layout`` builds; rows without an
edge in the panel keep their values.

K1 and K2 are one design (``csrc/spmm_chunk.cuh``). Both are bound by the
bytes of their gathers, and what a kernel loses on top of them on a
power-law graph is balance: rows run from no edge to hundreds of thousands.
So the work is cut by edges: a :class:`SpmmSchedule`, built once with the
structure, cuts the flat edge array into chunks of about ``CHUNK_EDGES``
edges, one warp takes one chunk with several gathered rows in flight, a row
inside a chunk is written by its warp, and a row longer than a chunk leaves
one partial sum a chunk in a scratch table of just those pieces, which a
second kernel adds in chunk order: no atomics, one writer per element. One call of ``spmm_csr`` or
``spmm_csr_accum`` therefore starts one or two CUDA kernels (one more per
further 256 columns, 64 where ``F % 4 != 0``); the launch counters count
calls. Rows of ``F`` floats that 4 does not divide (the 47 classes) take one
pass too, two columns a lane.
:func:`spmm_csr_chunked_reference` computes the same cut in plain PyTorch
for the CPU tests.

K3 (``cogdl_tpu_torch/csrc/gat_fused.cu``) replaces ``_gat_pass``
(``segment_kernels.py:975``, kernel body ``_make_gat_pass_kernel``): the
fused GAT scores + softmax + aggregation pass in three modes, ``fwd`` and
``dsd`` over the CSR (grouped by destination) and ``dsrc`` over the CSC
(grouped by source), with the attention-dropout hash of the TPU kernel bit
for bit, keyed on the edge's id or on its (dst, src) coordinates, and
either single-shot or accumulating over the panels of a panel-major CSR. It
cuts its work on K1/K2's schedule: one warp a chunk of edges, a cut row's
pieces (narrow: the per-head dots are taken before a piece is stored) added
in chunk order by K1's second kernel. :func:`gat_pass_chunked_reference`
computes that cut in plain PyTorch for the CPU tests. All three kernels are
bound by bytes on the H100.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` at first use,
one ``nvcc`` a source, all started together, and linked into one library in
``build/cogdl_tpu_torch/`` beside the package, keyed by a hash of the
sources, their shared headers and the flags, bound through ``ctypes`` (plain
C interface, no PyTorch headers, so a build takes seconds).

``spmm_csr``, ``spmm_csr_accum`` and ``gat_pass`` take their plain versions
only for CPU tensors. A CUDA tensor launches the kernel or raises: there is
no fallback.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from .device_layout import SpmmSchedule, build_spmm_schedule

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cogdl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# heads K3 takes, as the Pallas kernel (segment_kernels.py:1193); its
# row-a-warp kernel keeps one lane a head
GAT_MAX_HEADS = 128
GAT_ROWS_MAX_HEADS = 32
GAT_MODES = ("fwd", "dsd", "dsrc")


def sources() -> Tuple[Path, ...]:
    """The kernel sources, in a fixed order."""
    return tuple(sorted(CSRC.glob("*.cu")))


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA toolkit is needed to build the port's kernels")
    return nvcc


def build() -> Tuple[Path, str, float]:
    """Compile the kernel library unless a build of these exact sources and
    flags exists: one ``nvcc -c`` per
    source, all running at once, then one link. Returns ``(path, nvcc
    stderr, seconds)``; the log holds ``-Xptxas -v``'s register and spill
    lines and is empty when the library was already built. Raises with
    nvcc's stderr if a step fails."""
    srcs = sources()
    digest = hashlib.sha256(
        b"".join(p.name.encode() + p.read_bytes()
                 for p in (*srcs, *sorted(CSRC.glob("*.cuh"))))
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcogdl_kernels_{digest}.so"
    if lib.exists():
        return lib, "", 0.0
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{p.stem}_{tag}.o" for p in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for p, o in zip(srcs, objs)]
    logs = []
    failed = []
    for p, proc in zip(srcs, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {p} (exit {proc.returncode}):"
                          f"\n{err}")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {lib.name} (exit "
                               f"{link.returncode}):\n{link.stderr}")
        os.replace(tmp, lib)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return lib, "".join(logs), time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    # row_ptr, col, w, x, out | n_rows, n_feat | erow, chunk_start,
    # piece_start | n_chunks | cross | n_cross | partial | K1 only: rows (1:
    # the row-a-warp kernel) | n_kernels, a host int | stream
    schedule = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_void_p]
    tail = [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    head = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + schedule
    lib.spmm_csr_f32.argtypes = head + [ctypes.c_int] + tail
    lib.spmm_csr_f32.restype = ctypes.c_int
    lib.spmm_csr_accum_f32.argtypes = head + tail
    lib.spmm_csr_accum_f32.restype = ctypes.c_int
    # mode | ptr idx orig seed sd ss smax h2 dagg dden out_vec out_head
    # keep_out | n_rows H D | alpha inv_keep | thresh | drop coord_key accum
    # | schedule | partial_head | rows | n_kernels, stream
    lib.gat_pass_f32.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 13
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
        + [ctypes.c_uint32] + [ctypes.c_int] * 3 + schedule
        + [ctypes.c_void_p, ctypes.c_int] + tail)
    lib.gat_pass_f32.restype = ctypes.c_int
    for name in ("spmm_csr_error_string", "spmm_csr_accum_error_string",
                 "gat_pass_error_string"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
    return lib


def spmm_csr_reference(row_ptr: torch.Tensor, col: torch.Tensor,
                       w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``out[r] = Σ_{e in row r} w[e]·x[col[e]]``
    with gather + ``index_add``. The CPU path and the tests use it; on the
    card it is the yardstick of correctness only."""
    n = row_ptr.numel() - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(n, device=x.device), counts)
    E = row.numel()
    msg = x.index_select(0, col[:E].long()) * w[:E].unsqueeze(-1)
    return x.new_zeros((n, x.shape[1])).index_add(0, row, msg)


def _check_schedule(fn: str, schedule: SpmmSchedule, nnz: int, width: int,
                    dev) -> None:
    """Device, type, rank and contiguity of a schedule's tensors, ``erow``
    as long as the flat edge arrays, and int32 offsets into a scratch of
    ``width`` floats a piece."""
    for name, t, ndim in (("erow", schedule.erow, 1),
                          ("chunk_start", schedule.chunk_start, 1),
                          ("cross", schedule.cross, 2),
                          ("piece_start", schedule.piece_start, 1),
                          ("piece_row", schedule.piece_row, 1)):
        if t.device != dev:
            raise ValueError(f"{fn}: schedule.{name} is on {t.device}, the "
                             f"tables on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{fn}: schedule.{name} must be torch.int32, got "
                            f"{t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"{fn}: schedule.{name} must be {ndim}-D, got "
                             f"shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: schedule.{name} must be contiguous")
    if schedule.erow.numel() != nnz:
        raise ValueError(f"{fn}: schedule.erow has {schedule.erow.numel()} "
                         f"entries, the edge arrays {nnz}")
    if schedule.chunk_start.numel() < 1 or schedule.cross.shape[1] != 3:
        raise ValueError(
            f"{fn}: schedule.chunk_start needs n_chunks + 1 entries and "
            f"schedule.cross (row, first, last) triples, got shapes "
            f"{tuple(schedule.chunk_start.shape)} and "
            f"{tuple(schedule.cross.shape)}")
    if schedule.piece_start.shape != schedule.chunk_start.shape:
        raise ValueError(
            f"{fn}: schedule.piece_start must be shaped as "
            f"schedule.chunk_start, {tuple(schedule.chunk_start.shape)}, "
            f"got {tuple(schedule.piece_start.shape)}")
    if schedule.piece_row.numel() * width >= 2 ** 31:
        raise ValueError(f"{fn}: the scratch of one partial row a piece "
                         "overflows int32 offsets at this size")


def _check_launch_args(row_ptr, col, w, x, acc=None, schedule=None,
                       fn="spmm_csr"):
    dev = x.device
    tensors = [("row_ptr", row_ptr, torch.int32, 1),
               ("col", col, torch.int32, 1), ("w", w, torch.float32, 1),
               ("x", x, torch.float32, 2)]
    if acc is not None:
        tensors.append(("acc", acc, torch.float32, 2))
    for name, t, dtype, ndim in tensors:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"{fn}: {name} must be {ndim}-D, got "
                             f"shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if col.numel() != w.numel():
        raise ValueError(f"{fn}: col has {col.numel()} entries, "
                         f"w {w.numel()}")
    if x.shape[0] != row_ptr.numel() - 1:
        raise ValueError(
            f"{fn}: the matrix is square over {row_ptr.numel() - 1} "
            f"rows, x has {x.shape[0]}")
    if acc is not None and acc.shape != x.shape:
        raise ValueError(f"{fn}: acc must be {tuple(x.shape)} as x, got "
                         f"{tuple(acc.shape)}")
    if max(x.numel(), col.numel()) >= 2 ** 31:
        raise ValueError(f"{fn}: int32 offsets overflow at this size")
    if schedule is not None:
        _check_schedule(fn, schedule, col.numel(), x.shape[1], dev)


# every wrapper that counts its launches; the modules of the other kernels
# (gather_kernels) add theirs
COUNTED_WRAPPERS: list = []


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counters to 0."""
    for fn in COUNTED_WRAPPERS:
        fn.launches = 0
        fn.launches_by.clear()


def _own_schedule(row_ptr: torch.Tensor, col: torch.Tensor) -> SpmmSchedule:
    """The schedule of ``row_ptr`` for a caller that passes none, its
    ``erow`` as long as the flat ``col``."""
    sched = build_spmm_schedule(row_ptr)
    pad = col.numel() - sched.erow.numel()
    if pad > 0:
        sched = sched._replace(erow=torch.cat([sched.erow,
                                               sched.erow.new_zeros(pad)]))
    return sched


def _schedule_args(schedule: SpmmSchedule, F: int, device):
    """The schedule as the C functions take it: ``erow, chunk_start,
    piece_start, n_chunks, cross, n_cross, partial``, and the scratch tensor
    to keep alive (one partial row a piece of a cut row, only when a row is
    cut)."""
    n_chunks = schedule.chunk_start.numel() - 1
    n_cross = schedule.cross.shape[0]
    partial = (torch.empty((schedule.piece_row.numel(), F),
                           dtype=torch.float32, device=device)
               if n_cross else None)
    return (schedule.erow.data_ptr(), schedule.chunk_start.data_ptr(),
            schedule.piece_start.data_ptr(), n_chunks,
            schedule.cross.data_ptr() if n_cross else None, n_cross,
            None if partial is None else partial.data_ptr()), partial


K1_KERNELS = ("rows", "chunks")


def spmm_csr(row_ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor, structure: str = "csr",
             schedule: Optional[SpmmSchedule] = None,
             kernel: Optional[str] = None) -> torch.Tensor:
    """``out[r] = Σ_{e in [row_ptr[r], row_ptr[r+1])} w[e] · x[col[e]]``.

    ``row_ptr``/``col`` int32, ``w``/``x`` float32, all contiguous, ``x``
    ``[n, F]`` with ``n = row_ptr.numel() - 1``. CUDA tensors run K1 on the
    current stream; CPU tensors run :func:`spmm_csr_reference`.

    ``schedule``: the :class:`SpmmSchedule` of ``row_ptr`` that
    ``prepare_spmm`` or ``prepare_spmm_device`` stored; the call then does
    no set-up work. Without one it is built from ``row_ptr`` on the device,
    which costs a few torch ops and two host synchronisations a call.
    ``kernel``: ``"chunks"``, the edge-chunk kernel, or ``"rows"``, one warp
    a row; None takes ``"rows"`` for a structure without a row longer than a
    chunk (``schedule.cross`` is empty) and ``"chunks"`` otherwise.

    Each call adds one to ``spmm_csr.launches`` and to
    ``spmm_csr.launches_by[(structure, F)]``, however many CUDA kernels it
    starts (``spmm_csr.cuda_kernels`` holds that number of the last call,
    ``spmm_csr.kernel`` the name of the kernel it ran); ``structure`` names
    what the caller passes, ``"csr"`` (A) or ``"csc"`` (Aᵀ), and only keys
    that count."""
    if kernel not in (None, *K1_KERNELS):
        raise ValueError(f"spmm_csr: kernel must be one of {K1_KERNELS} or "
                         f"None, got {kernel!r}")
    if not x.is_cuda:
        return spmm_csr_reference(row_ptr, col, w, x)
    if schedule is None and kernel != "rows":
        _check_launch_args(row_ptr, col, w, x)
        schedule = _own_schedule(row_ptr, col)
    _check_launch_args(row_ptr, col, w, x, schedule=schedule)
    n, F = x.shape
    out = torch.empty((n, F), dtype=torch.float32, device=x.device)
    if n == 0 or F == 0:
        return out
    if kernel is None:
        kernel = "chunks" if schedule.cross.shape[0] else "rows"
    lib = load_library()
    # the row-a-warp kernel reads no schedule
    sched_args, partial = ((None, None, None, 0, None, 0, None), None) if (
        schedule is None) else _schedule_args(schedule, F, x.device)
    started = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spmm_csr_f32(row_ptr.data_ptr(), col.data_ptr(),
                               w.data_ptr(), x.data_ptr(), out.data_ptr(),
                               n, F, *sched_args, int(kernel == "rows"),
                               ctypes.byref(started), stream)
    if err != 0:
        raise RuntimeError(
            f"spmm_csr kernel launch failed: CUDA error {err} "
            f"({lib.spmm_csr_error_string(err).decode()})")
    spmm_csr.launches += 1
    spmm_csr.launches_by[(structure, F)] += 1
    spmm_csr.cuda_kernels = started.value
    spmm_csr.kernel = kernel
    return out


spmm_csr.launches = 0
spmm_csr.launches_by = collections.Counter()
spmm_csr.cuda_kernels = 0
spmm_csr.kernel = None


class SpMMFunction(torch.autograd.Function):
    """``Y = A X`` through K1, with the backward ``dX = Aᵀ G`` through K1
    over the transposed structure (CSR of Aᵀ), and ``dw`` — only when asked
    for — as the plain SDDMM ``(G[row] · X[col]).sum(-1)``, the way the JAX
    package's XLA route differentiates the weights.

    Inputs: ``x``, the CSR of A (``fw_ptr``, ``fw_col``, ``fw_w``) and the
    CSR of Aᵀ (``bw_ptr``, ``bw_col``, ``bw_w``), then optionally each
    direction's prepared :class:`SpmmSchedule`; ``dw`` is the gradient of
    ``fw_w``. ``bw_w`` holds the same values in transposed order and is
    treated as a constant."""

    @staticmethod
    def forward(ctx, x, fw_ptr, fw_col, fw_w, bw_ptr, bw_col, bw_w,
                fw_schedule=None, bw_schedule=None):
        x = x.contiguous()
        # only the dw SDDMM reads x: keep it alive only when dw is asked for
        ctx.save_for_backward(x if ctx.needs_input_grad[3] else None,
                              fw_ptr, fw_col, bw_ptr, bw_col, bw_w)
        ctx.bw_schedule = bw_schedule
        return spmm_csr(fw_ptr, fw_col, fw_w, x, structure="csr",
                        schedule=fw_schedule)

    @staticmethod
    def backward(ctx, g):
        x, fw_ptr, fw_col, bw_ptr, bw_col, bw_w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = spmm_csr(bw_ptr, bw_col, bw_w, g, structure="csc",
                          schedule=ctx.bw_schedule)
        if ctx.needs_input_grad[3]:
            n = fw_ptr.numel() - 1
            row = torch.repeat_interleave(
                torch.arange(n, device=g.device),
                (fw_ptr[1:] - fw_ptr[:-1]).long())
            dw = (g.index_select(0, row)
                  * x.index_select(0, fw_col[: row.numel()])).sum(-1)
        return dx, None, None, dw, None, None, None, None, None


# ---------------------------------------------------------------------------
# K2: the accumulating CSR SpMM, one call per source panel
# ---------------------------------------------------------------------------

# edges the plain versions handle at a time: bounds their [edges, F] message
# tensor at sizes where one panel holds tens of millions of edges
_REFERENCE_EDGE_CHUNK = 1 << 21


def panel_edges(row_ptr: torch.Tensor):
    """``(lo, row)`` of one grouping: the offset of its first edge in the
    flat arrays and the grouping row of each of its edges, in order."""
    n = row_ptr.numel() - 1
    row = torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device),
        (row_ptr[1:] - row_ptr[:-1]).long())
    return int(row_ptr[0]), row


def spmm_csr_accum_reference(acc: torch.Tensor, row_ptr: torch.Tensor,
                             col: torch.Tensor, w: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: gather + ``index_add_`` into ``acc``, in
    place, over the edges ``[row_ptr[0], row_ptr[-1])`` of the flat ``col``
    and ``w``, a slice of edges at a time. The CPU path and the tests use
    it; on the card it is the yardstick of correctness only."""
    lo, row = panel_edges(row_ptr)
    for a in range(0, row.numel(), _REFERENCE_EDGE_CHUNK):
        r = row[a: a + _REFERENCE_EDGE_CHUNK]
        e = slice(lo + a, lo + a + r.numel())
        acc.index_add_(0, r, x.index_select(0, col[e].long())
                       * w[e].unsqueeze(-1))
    return acc


def spmm_csr_chunked_reference(row_ptr: torch.Tensor, col: torch.Tensor,
                               w: torch.Tensor, x: torch.Tensor,
                               schedule: SpmmSchedule,
                               acc: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """K1 (``acc`` None) or K2 (``acc`` given, added to in place) in plain
    PyTorch *the way the kernels cut it*, for the CPU tests of the schedule:
    chunk by chunk, a row inside a chunk written (K1) or added (K2) by that
    chunk, the piece of a row that began earlier stored in scratch slot
    ``piece_start[c]``, of a row that goes on in slot ``piece_start[c + 1] −
    1``, and each row of ``schedule.cross`` summed from its run of slots in
    order. A Python loop over chunks: small structures only. Raises when a
    slot is read that no chunk wrote, written twice, written and never
    read, or holds another row than ``piece_row`` says, i.e. when the
    schedule does not fit ``row_ptr``."""
    out = x.new_zeros(x.shape) if acc is None else acc
    starts = schedule.chunk_start.tolist()
    slots = schedule.piece_start.tolist()
    piece_row = schedule.piece_row.tolist()
    erow = schedule.erow.tolist()
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    partial = {}
    for c, (s, e) in enumerate(zip(starts[:-1], starts[1:])):
        if s >= e:
            continue
        head_open = s > lo and erow[s - 1] == erow[s]
        tail_open = e < hi and erow[e] == erow[e - 1]
        bounds = [s] + [i for i in range(s + 1, e)
                        if erow[i] != erow[i - 1]] + [e]
        for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            piece = (x[col[a:b].long()] * w[a:b, None]).sum(0)
            open_left, open_right = i == 0 and head_open, b == e and tail_open
            if open_left or open_right:
                slot = slots[c] if open_left else slots[c + 1] - 1
                if slot in partial or piece_row[slot] != erow[a]:
                    raise AssertionError(
                        f"chunk {c} puts a piece of row {erow[a]} into slot "
                        f"{slot}, which is taken or belongs to another row")
                partial[slot] = piece
            elif acc is None:
                out[erow[a]] = piece
            else:
                out[erow[a]] += piece
    for row, first, last in schedule.cross.tolist():
        if row < 0:
            continue
        slot = slots[first + 1] - 1
        total = partial.pop(slot).clone()
        for i in range(1, last - first + 1):
            total += partial.pop(slot + i)
        out[row] += total
    if partial:
        raise AssertionError(f"partial sums {sorted(partial)} were written "
                             "and never added to a row")
    return out


def spmm_csr_accum(acc: torch.Tensor, row_ptr: torch.Tensor,
                   col: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                   structure: str = "csr",
                   schedule: Optional[SpmmSchedule] = None) -> torch.Tensor:
    """``acc[r] += Σ_{e in [row_ptr[r], row_ptr[r+1])} w[e] · x[col[e]]`` in
    place; returns ``acc``. A row whose range is empty keeps its values bit
    for bit.

    ``row_ptr`` is one panel's row of the panel-major CSR: int32 offsets
    into the flat ``col`` (int32, global indices) and ``w`` (float32).
    ``x`` and ``acc`` are float32 ``[n, F]`` with ``n = row_ptr.numel() -
    1``, contiguous, and must not share memory. CUDA tensors run K2 on the
    current stream; CPU tensors run :func:`spmm_csr_accum_reference`.

    ``schedule``: the panel's :class:`SpmmSchedule`
    (``SpmmSchedule.panel(p)`` of what ``prepare_spmm_device`` stored); the
    call then does no set-up work. Without one it is built from ``row_ptr``
    on the device on every call.

    Each call adds one to ``spmm_csr_accum.launches`` and to
    ``spmm_csr_accum.launches_by[(structure, F)]``, however many CUDA
    kernels it starts (``spmm_csr_accum.cuda_kernels`` holds that number of
    the last call); ``structure`` names what the caller passes, ``"csr"`` (A) or ``"csc"``
    (Aᵀ), and only keys that count."""
    if not x.is_cuda:
        return spmm_csr_accum_reference(acc, row_ptr, col, w, x)
    if schedule is None:
        _check_launch_args(row_ptr, col, w, x, acc, fn="spmm_csr_accum")
        schedule = _own_schedule(row_ptr, col)
    _check_launch_args(row_ptr, col, w, x, acc, schedule, "spmm_csr_accum")
    n, F = x.shape
    if n == 0 or F == 0:
        return acc
    lib = load_library()
    sched_args, partial = _schedule_args(schedule, F, x.device)
    started = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spmm_csr_accum_f32(row_ptr.data_ptr(), col.data_ptr(),
                                     w.data_ptr(), x.data_ptr(),
                                     acc.data_ptr(), n, F, *sched_args,
                                     ctypes.byref(started), stream)
    if err != 0:
        raise RuntimeError(
            f"spmm_csr_accum kernel launch failed: CUDA error {err} "
            f"({lib.spmm_csr_accum_error_string(err).decode()})")
    spmm_csr_accum.launches += 1
    spmm_csr_accum.launches_by[(structure, F)] += 1
    spmm_csr_accum.cuda_kernels = started.value
    return acc


spmm_csr_accum.launches = 0
spmm_csr_accum.launches_by = collections.Counter()
spmm_csr_accum.cuda_kernels = 0


class SpMMPanelFunction(torch.autograd.Function):
    """``Y = A X`` over a panel-major CSR through K2: the forward starts
    from zeros and runs K2 once per panel of the forward structure, the
    backward ``dX = Aᵀ G`` once per panel of the backward structure (the
    same tensors when the structure was prepared ``symmetric``), and ``dw``
    — only when asked for — as the plain SDDMM, as :class:`SpMMFunction`.

    Inputs as :class:`SpMMFunction`, with ``fw_ptr``/``bw_ptr``
    ``[n_panels, n + 1]`` and the schedules those of the panel structures;
    ``dw`` is in the flat (panel-major) order of ``fw_w``."""

    @staticmethod
    def forward(ctx, x, fw_ptr, fw_col, fw_w, bw_ptr, bw_col, bw_w,
                fw_schedule=None, bw_schedule=None):
        x = x.contiguous()
        ctx.save_for_backward(x if ctx.needs_input_grad[3] else None,
                              fw_ptr, fw_col, bw_ptr, bw_col, bw_w)
        ctx.bw_schedule = bw_schedule
        out = torch.zeros_like(x)
        for p, ptr in enumerate(fw_ptr):
            spmm_csr_accum(out, ptr, fw_col, fw_w, x, structure="csr",
                           schedule=fw_schedule and fw_schedule.panel(p))
        return out

    @staticmethod
    def backward(ctx, g):
        x, fw_ptr, fw_col, bw_ptr, bw_col, bw_w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.zeros_like(g)
            sched = ctx.bw_schedule
            for p, ptr in enumerate(bw_ptr):
                spmm_csr_accum(dx, ptr, bw_col, bw_w, g, structure="csc",
                               schedule=sched and sched.panel(p))
        if ctx.needs_input_grad[3]:
            row = torch.cat([panel_edges(ptr)[1] for ptr in fw_ptr])
            dw = (g.index_select(0, row)
                  * x.index_select(0, fw_col.long())).sum(-1)
        return dx, None, None, dw, None, None, None, None, None


# ---------------------------------------------------------------------------
# K3: the fused GAT attention pass
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a · b) mod 2³²`` for int64 ``a`` in ``[0, 2³²)`` and a constant
    ``b < 2³²``: ``b`` is split into 16-bit halves so that no product
    overflows int64."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _drop_params(attn_drop: float) -> Tuple[int, float]:
    """The keep threshold on the 32-bit hash and the keep scale, as the TPU
    kernel computes them (``segment_kernels.py:690-692``); the scale is
    rounded to fp32."""
    thresh = int((1.0 - attn_drop) * float(2 ** 32 - 1))
    inv_keep = float(torch.tensor(1.0 / (1.0 - attn_drop), dtype=torch.float32))
    return thresh, inv_keep


def dropout_keep_reference(orig: Optional[torch.Tensor], seed: torch.Tensor,
                           H: int, attn_drop: float,
                           dst: Optional[torch.Tensor] = None,
                           src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's attention-dropout scales ``[nnz, H]``: ``1/(1-p)`` where the
    edge and head are kept, else 0. The hash of the TPU kernel
    (``segment_kernels.py:806-828``) in int64 arithmetic mod 2³²: the key is
    ``uint32(orig) ^ seed`` or, when ``dst`` and ``src`` are given (the
    coordinate key of the panel route), ``dst·0x9E3779B1 ^ src·0x85EBCA77 ^
    seed``; then ``key·H + h`` through a multiply-add and the murmur3
    finaliser."""
    thresh, inv_keep = _drop_params(attn_drop)
    sv = seed.long().reshape(()) & _M32
    if dst is not None:
        ek = (_mul32(dst.long() & _M32, 0x9E3779B1)
              ^ _mul32(src.long() & _M32, 0x85EBCA77) ^ sv)
    else:
        ek = (orig.long() & _M32) ^ sv
    hx = (ek[:, None] * H + torch.arange(H, device=ek.device)) & _M32
    hx = (_mul32(hx, 747796405) + 2891336453) & _M32
    hx = hx ^ (hx >> 16)
    hx = _mul32(hx, 0x85EBCA6B)
    hx = hx ^ (hx >> 13)
    hx = _mul32(hx, 0xC2B2AE35)
    hx = hx ^ (hx >> 16)
    return torch.where(hx < thresh, inv_keep, 0.0).float()


def gat_output_widths(mode: str, H: int, HD: int) -> Tuple[int, ...]:
    """Column counts of a K3 pass's outputs: ``(num, den)`` for ``fwd``,
    ``(dsd,)`` for ``dsd``, ``(dh2, dss)`` for ``dsrc``."""
    return (H,) if mode == "dsd" else (HD, H)


def _gat_edge_terms(mode: str, grp, nbr, e: slice, orig, sd, ss, smax, *,
                    alpha: float, attn_drop: float, seed, coord_key: bool):
    """K3's per-(edge, head) terms for the edges ``e`` of the flat arrays,
    ``grp`` their grouping rows and ``nbr`` their neighbours (long): ``(dst,
    src, ex, slope, keep)``, ``keep`` None without attention dropout, in the
    order of the JAX kernel's formulas (``segment_kernels.py:640-655``)."""
    H = sd.shape[1]
    dst, src = (nbr, grp) if mode == "dsrc" else (grp, nbr)
    sd_e = sd.index_select(0, dst)
    pre = sd_e + ss.index_select(0, src)
    slope = torch.where(pre > 0, 1.0, alpha)
    m = sd_e + smax
    m = torch.where(m > 0, m, alpha * m)
    ex = torch.exp(pre * slope - m)
    keep = None
    if attn_drop > 0.0 and coord_key:
        keep = dropout_keep_reference(None, seed, H, attn_drop, dst, src)
    elif attn_drop > 0.0:
        keep = dropout_keep_reference(orig[e], seed, H, attn_drop)
    return dst, src, ex, slope, keep


def gat_pass_reference(mode: str, ptr, idx, orig, sd, ss, smax, h2,
                       dagg=None, dden=None, *, alpha: float,
                       attn_drop: float = 0.0, seed=None,
                       with_keep: bool = False, acc=None,
                       coord_key: bool = False):
    """Plain PyTorch version of K3 with gathers and ``index_add``, per edge
    in the order of the JAX kernel's formulas (``segment_kernels.py:642-970``).
    The CPU path and the tests use it; on the card it is the yardstick of
    correctness only. Arguments and results as :func:`gat_pass`."""
    n, H = ptr.numel() - 1, sd.shape[1]
    HD = h2.shape[1]
    D = HD // H
    lo, grp_all = panel_edges(ptr)
    # added to in place: rows without an edge here keep their values
    outs = acc if acc is not None else tuple(
        sd.new_zeros((n, w)) for w in gat_output_widths(mode, H, HD))
    out_vec, out_head = (None, *outs) if mode == "dsd" else outs
    keep_all = sd.new_zeros((idx.numel(), H)) if with_keep else None
    # a slice of edges at a time bounds the [edges, H·D] temporaries
    for a in range(0, grp_all.numel(), _REFERENCE_EDGE_CHUNK):
        grp = grp_all[a: a + _REFERENCE_EDGE_CHUNK]
        E = grp.numel()
        e = slice(lo + a, lo + a + E)
        dst, src, ex, slope, keep = _gat_edge_terms(
            mode, grp, idx[e].long(), e, orig, sd, ss, smax, alpha=alpha,
            attn_drop=attn_drop, seed=seed, coord_key=coord_key)
        exn = ex if keep is None else ex * keep
        if mode == "fwd":
            msg = h2.index_select(0, src).view(E, H, D) * exn[:, :, None]
            out_vec.index_add_(0, grp, msg.view(E, HD))
            out_head.index_add_(0, grp, ex)
        else:
            dagg_e = dagg.index_select(0, dst).view(E, H, D)
            dex = (dagg_e * h2.index_select(0, src).view(E, H, D)).sum(-1)
            if keep is not None:
                dex = dex * keep
            ds = (dex + dden.index_select(0, dst)) * ex * slope
            out_head.index_add_(0, grp, ds)
            if mode == "dsrc":
                out_vec.index_add_(
                    0, grp, (dagg_e * exn[:, :, None]).view(E, HD))
        if with_keep:
            keep_all[e] = 1.0 if keep is None else keep
    return outs + ((keep_all,) if with_keep else ())


def _chunk_targets(ptr, schedule: SpmmSchedule):
    """Where the kernels put each edge of ``ptr``'s range on ``schedule``:
    ``(lo, grp, piece, slot)``, ``piece`` true for an edge of a row that is
    cut, ``slot`` its piece's slot in the scratch (the chunk's head slot
    ``piece_start[c]`` for the end of a row that began in an earlier chunk,
    else its tail slot ``piece_start[c + 1] − 1``). Raises when the schedule
    does not fit ``ptr``."""
    lo, grp = panel_edges(ptr)
    hi = lo + grp.numel()
    erow = schedule.erow.long()
    if not torch.equal(erow[lo:hi], grp):
        raise AssertionError("schedule.erow does not hold the rows of ptr")
    starts = schedule.chunk_start.long()
    edge = torch.arange(lo, hi, device=grp.device)
    c = torch.searchsorted(starts, edge, right=True) - 1
    cs, ce = starts[c], starts[c + 1]
    before = torch.where(cs > lo, erow[(cs - 1).clamp_min(0)], -1)
    after = torch.where(ce < hi, erow[ce.clamp_max(erow.numel() - 1)], -1)
    first_row, last_row = erow[cs], erow[ce - 1]
    head = (before == first_row) & (grp == first_row)
    piece = head | ((after == last_row) & (grp == last_row))
    slot = torch.where(head, schedule.piece_start[c],
                       schedule.piece_start[c + 1] - 1).long()
    cut = schedule.cross[:, 0]
    cut = cut[cut >= 0].long()
    if not (torch.equal(torch.unique(grp[piece]), torch.unique(cut))
            and torch.equal(schedule.piece_row.long()[slot[piece]],
                            grp[piece])):
        raise AssertionError("the schedule's cut rows or piece slots do not "
                             "fit ptr")
    return lo, grp, piece, slot


def gat_pass_chunked_reference(mode: str, ptr, idx, orig, sd, ss, smax, h2,
                               dagg=None, dden=None, *,
                               schedule: SpmmSchedule, alpha: float,
                               attn_drop: float = 0.0, seed=None,
                               with_keep: bool = False, acc=None,
                               coord_key: bool = False):
    """K3 in plain PyTorch *the way the chunk kernel cuts it* on
    ``schedule``, for the CPU tests: the per-edge terms of
    :func:`gat_pass_reference`, summed with ``index_add_`` into the rows
    that lie inside a chunk and into the scratch slots of the pieces of cut
    rows; the per-head dots of ``dsd`` and ``dsrc`` taken of each row's and
    each piece's summed vector (so a ``dsd`` piece is ``<dagg[r], Σ
    ex·slope·keep·h2[c]> + dden[r]·Σ ex·slope``); then each cut row's pieces
    added in slot (chunk) order and written, or added, once. Vectorised:
    small and medium structures in one go. Arguments and results as
    :func:`gat_pass`."""
    n, H = ptr.numel() - 1, sd.shape[1]
    HD = h2.shape[1]
    D = HD // H
    lo, grp, piece, slot = _chunk_targets(ptr, schedule)
    E = grp.numel()
    e = slice(lo, lo + E)
    dst, src, ex, slope, keep = _gat_edge_terms(
        mode, grp, idx[e].long(), e, orig, sd, ss, smax, alpha=alpha,
        attn_drop=attn_drop, seed=seed, coord_key=coord_key)
    exn = ex if keep is None else ex * keep
    # per edge: the vector output's term, the vector the dots are taken of
    # (if any) and the per-head term
    if mode == "fwd":
        vec = (h2.index_select(0, src).view(E, H, D) * exn[:, :, None])
        dotted, head = None, ex
    elif mode == "dsd":
        vec = None
        dotted = h2.index_select(0, src).view(E, H, D) * (exn * slope)[
            :, :, None]
        head = ex * slope
    else:
        dagg_e = dagg.index_select(0, dst).view(E, H, D)
        vec = dagg_e * exn[:, :, None]
        dotted = dagg_e * (exn * slope)[:, :, None]
        head = dden.index_select(0, dst) * ex * slope

    def sums(at, to, key):
        """Per target (rows ``key``: a grouping row, or a slot's row) the
        sums of the edges ``at``, which go to targets ``to``: the vector,
        and the per-head value with the dots taken."""
        t = key.numel()
        v = None if vec is None else vec.new_zeros((t, HD)).index_add_(
            0, to, vec[at].reshape(-1, HD))
        h = head.new_zeros((t, H)).index_add_(0, to, head[at])
        if dotted is not None:
            d = dotted.new_zeros((t, HD)).index_add_(
                0, to, dotted[at].reshape(-1, HD)).view(t, H, D)
            own = (dagg if mode == "dsd" else h2).index_select(0, key)
            dot = (own.view(t, H, D) * d).sum(-1)
            h = dot + (dden.index_select(0, key) * h if mode == "dsd" else h)
        return v, h

    inside = ~piece
    row_vec, row_head = sums(inside, grp[inside],
                             torch.arange(n, device=grp.device))
    slot_vec, slot_head = sums(piece, slot[piece],
                               schedule.piece_row.long().clamp_min(0))
    has = torch.zeros(n, dtype=torch.bool, device=grp.device)
    has[grp[inside]] = True
    # each cut row's pieces, added in slot order
    cut = schedule.piece_row.long()
    real = cut >= 0
    tot_head = slot_head.new_zeros((n, H)).index_add_(0, cut[real],
                                                      slot_head[real])
    tot_vec = None if vec is None else slot_vec.new_zeros((n, HD)).index_add_(
        0, cut[real], slot_vec[real])
    is_cut = torch.zeros(n, dtype=torch.bool, device=grp.device)
    is_cut[cut[real]] = True
    outs = acc if acc is not None else tuple(
        sd.new_zeros((n, w)) for w in gat_output_widths(mode, H, HD))
    out_vec, out_head = (None, *outs) if mode == "dsd" else outs
    for out, rows, tot in ((out_vec, row_vec, tot_vec),
                           (out_head, row_head, tot_head)):
        if out is None:
            continue
        if acc is None:
            out[has] = rows[has]
            out[is_cut] = tot[is_cut]
        else:
            out[has] += rows[has]
            out[is_cut] += tot[is_cut]
    if not with_keep:
        return outs
    keep_all = sd.new_zeros((idx.numel(), H))
    keep_all[e] = 1.0 if keep is None else keep
    return outs + (keep_all,)


def _check_gat_args(mode, tensors, n, H, HD):
    dev = tensors["sd"].device
    for name, t in tensors.items():
        if t is None:
            raise ValueError(f"gat_pass[{mode}]: {name} is required")
        if t.device != dev:
            raise ValueError(f"gat_pass: {name} is on {t.device}, sd on {dev}")
        want = torch.int32 if name in ("ptr", "idx", "orig") else (
            torch.int64 if name == "seed" else torch.float32)
        if t.dtype != want:
            raise TypeError(f"gat_pass: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gat_pass: {name} must be contiguous")
    shapes = {"sd": (n, H), "ss": (n, H), "smax": (H,), "h2": (n, HD),
              "dagg": (n, HD), "dden": (n, H), "seed": (1,)}
    for name, shape in shapes.items():
        t = tensors.get(name)
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"gat_pass: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    nnz = tensors["idx"].numel()
    if "orig" in tensors and tensors["orig"].numel() != nnz:
        raise ValueError(f"gat_pass: orig has {tensors['orig'].numel()} "
                         f"entries, idx {nnz}")
    if max(n * HD, nnz * H) >= 2 ** 31:
        raise ValueError("gat_pass: int32 offsets overflow at this size")


GAT_KERNELS = ("rows", "chunks")


def gat_pass(mode: str, ptr: torch.Tensor, idx: torch.Tensor,
             orig: Optional[torch.Tensor], sd: torch.Tensor, ss: torch.Tensor,
             smax: torch.Tensor, h2: torch.Tensor,
             dagg: Optional[torch.Tensor] = None,
             dden: Optional[torch.Tensor] = None, *, alpha: float,
             attn_drop: float = 0.0, seed: Optional[torch.Tensor] = None,
             with_keep: bool = False,
             acc: Optional[Tuple[torch.Tensor, ...]] = None,
             coord_key: bool = False,
             schedule: Optional[SpmmSchedule] = None,
             kernel: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """One K3 pass over the grouping ``ptr``/``idx`` (int32; the CSR of the
    graph for ``fwd`` and ``dsd``, its CSC for ``dsrc``), ``orig`` the int32
    position of each edge in the graph's edge list (the dropout key).
    ``ptr`` may be one panel's row of a panel-major CSR: offsets into the
    flat ``idx``.

    ``sd``/``ss`` ``[n, H]`` are the score halves (``H`` up to
    ``GAT_MAX_HEADS``), ``smax`` ``[H]`` the max of ``ss`` over all rows,
    ``h2`` ``[n, H·D]`` the transformed features; the backward modes also
    take ``dagg = g/den`` ``[n, H·D]`` and ``dden = −Σ_d g·out/den``
    ``[n, H]``. ``seed`` is a one-element int64 tensor, read when
    ``attn_drop > 0``. Returns ``(num, den)`` for ``fwd``, ``(dsd,)`` for
    ``dsd``, ``(dh2, dss)`` for ``dsrc``, and with ``with_keep`` also the
    ``[nnz, H]`` keep scales the pass used (0 for entries outside ``ptr``'s
    range).

    ``acc``: the mode's output buffers; the pass adds its sums into them in
    place, leaves rows without an edge in ``ptr``'s range untouched, and
    returns them. ``coord_key``: hash the dropout mask from each edge's
    (dst, src) coordinates, ``dst·0x9E3779B1 ^ src·0x85EBCA77 ^ seed``,
    instead of ``orig ^ seed``; ``orig`` is then not read. Parallel edges
    share one decision under this key.

    ``schedule``: the :class:`SpmmSchedule` of ``ptr`` (a panel's:
    ``SpmmSchedule.panel(p)``) that ``prepare_spmm`` or
    ``prepare_spmm_device`` stored; without one it is built from ``ptr`` on
    the device on every call. ``kernel``: ``"chunks"``, the edge-chunk
    kernel, or ``"rows"``, one warp a row (at most ``GAT_ROWS_MAX_HEADS``
    heads); None takes ``"rows"`` for a structure without a row longer than
    a chunk (``schedule.cross`` empty) and at most that many heads, else
    ``"chunks"``.

    CUDA tensors run K3 on the current stream; CPU tensors run
    :func:`gat_pass_reference`. Each call adds one to ``gat_pass.launches``
    and ``gat_pass.launches_by[(mode, H, D)]``, however many CUDA kernels it
    starts (``gat_pass.cuda_kernels`` holds that number of the last call,
    ``gat_pass.kernel`` the name of the kernel it ran)."""
    if mode not in GAT_MODES:
        raise ValueError(f"gat_pass: mode must be one of {GAT_MODES}, got "
                         f"{mode!r}")
    if kernel not in (None, *GAT_KERNELS):
        raise ValueError(f"gat_pass: kernel must be one of {GAT_KERNELS} or "
                         f"None, got {kernel!r}")
    if not sd.is_cuda:
        return gat_pass_reference(mode, ptr, idx, orig, sd, ss, smax, h2,
                                  dagg, dden, alpha=alpha,
                                  attn_drop=attn_drop, seed=seed,
                                  with_keep=with_keep, acc=acc,
                                  coord_key=coord_key)
    n, H = sd.shape
    HD = h2.shape[1]
    rows_ok = H <= GAT_ROWS_MAX_HEADS
    if not 1 <= H <= GAT_MAX_HEADS or HD % H or (
            kernel == "rows" and not rows_ok):
        raise ValueError(
            f"gat_pass: the kernel takes 1 <= H <= "
            f"{GAT_ROWS_MAX_HEADS if kernel == 'rows' else GAT_MAX_HEADS} "
            f"heads dividing H·D, got H={H}, H·D={HD}")
    D = HD // H
    drop = attn_drop > 0.0
    tensors = {"ptr": ptr, "idx": idx, "sd": sd, "ss": ss, "smax": smax,
               "h2": h2}
    if mode != "fwd":
        tensors.update(dagg=dagg, dden=dden)
    if drop:
        tensors.update(seed=seed)
        if not coord_key:
            tensors.update(orig=orig)
    out_shapes = tuple((n, w) for w in gat_output_widths(mode, H, HD))
    if acc is not None:
        if len(acc) != len(out_shapes):
            raise ValueError(f"gat_pass[{mode}]: acc takes {len(out_shapes)} "
                             f"buffers, got {len(acc)}")
        for i, (t, shape) in enumerate(zip(acc, out_shapes)):
            if tuple(t.shape) != shape:
                raise ValueError(f"gat_pass[{mode}]: acc[{i}] must be "
                                 f"{shape}, got {tuple(t.shape)}")
            tensors[f"acc[{i}]"] = t
    _check_gat_args(mode, tensors, n, H, HD)
    if ptr.numel() != n + 1:
        raise ValueError(f"gat_pass: ptr has {ptr.numel()} entries for {n} "
                         "rows")
    if schedule is None and kernel != "rows":
        schedule = _own_schedule(ptr, idx)
    if schedule is not None:
        _check_schedule("gat_pass", schedule, idx.numel(), HD + H, sd.device)
    if kernel is None:
        kernel = "rows" if rows_ok and not schedule.cross.shape[0] else "chunks"
    nnz = idx.numel()
    if acc is not None:
        out_vec, out_head = (None, *acc) if mode == "dsd" else acc
    else:
        out_vec = (None if mode == "dsd" else torch.empty(
            (n, HD), dtype=torch.float32, device=sd.device))
        out_head = torch.empty((n, H), dtype=torch.float32, device=sd.device)
    keep = (torch.zeros((nnz, H), dtype=torch.float32, device=sd.device)
            if with_keep else None)
    thresh, inv_keep = _drop_params(attn_drop) if drop else (0, 1.0)
    # the scratch: a vector (fwd, dsrc) and a per-head row a piece of a cut
    # row, only when a row is cut
    sched_args, partial_head = (None, None, None, 0, None, 0, None), None
    if kernel == "chunks":
        sched_args, partial_vec = _schedule_args(
            schedule, 0 if mode == "dsd" else HD, sd.device)
        if schedule.cross.shape[0]:
            partial_head = torch.empty((schedule.piece_row.numel(), H),
                                       dtype=torch.float32, device=sd.device)
    lib = load_library()

    def p(t):
        return None if t is None else t.data_ptr()

    started = ctypes.c_int(0)
    with torch.cuda.device(sd.device):
        stream = torch.cuda.current_stream(sd.device).cuda_stream
        err = lib.gat_pass_f32(
            GAT_MODES.index(mode), p(ptr), p(idx),
            p(orig) if drop and not coord_key else None,
            p(seed) if drop else None, p(sd), p(ss), p(smax), p(h2),
            p(dagg) if mode != "fwd" else None,
            p(dden) if mode != "fwd" else None, p(out_vec), p(out_head),
            p(keep), n, H, D, float(alpha), inv_keep, thresh, int(drop),
            int(coord_key), int(acc is not None), *sched_args,
            p(partial_head), int(kernel == "rows"), ctypes.byref(started),
            stream)
    if err != 0:
        raise RuntimeError(
            f"gat_pass[{mode}] kernel launch failed: CUDA error {err} "
            f"({lib.gat_pass_error_string(err).decode()})")
    gat_pass.launches += 1
    gat_pass.launches_by[(mode, H, D)] += 1
    gat_pass.cuda_kernels = started.value
    gat_pass.kernel = kernel
    outs = {"fwd": (out_vec, out_head), "dsd": (out_head,),
            "dsrc": (out_vec, out_head)}[mode]
    return outs + ((keep,) if with_keep else ())


gat_pass.launches = 0
gat_pass.launches_by = collections.Counter()
gat_pass.cuda_kernels = 0
gat_pass.kernel = None
COUNTED_WRAPPERS += [spmm_csr, spmm_csr_accum, gat_pass]


def _gat_sweep(mode: str, ptr, idx, orig, schedule, sd, *tables, **kw):
    """One K3 sweep over a whole structure: a single pass over a CSR
    (``ptr`` 1-D, dropout keyed on ``orig``), or, over a panel-major CSR
    (``ptr`` ``[n_panels, n + 1]``), one pass per panel into one zeroed
    accumulator with the coordinate-keyed dropout hash, as the JAX
    package's ``_gat_apply`` drives its blocked layouts. ``schedule``: the
    structure's stored :class:`SpmmSchedule`, or None."""
    if ptr.ndim == 1:
        return gat_pass(mode, ptr, idx, orig, sd, *tables, schedule=schedule,
                        **kw)
    n, H = sd.shape
    acc = tuple(sd.new_zeros((n, w)) for w in gat_output_widths(
        mode, H, tables[2].shape[1]))
    for p, panel_ptr in enumerate(ptr):
        gat_pass(mode, panel_ptr, idx, None, sd, *tables, acc=acc,
                 coord_key=True, schedule=schedule and schedule.panel(p),
                 **kw)
    return acc


class GATFusedFunction(torch.autograd.Function):
    """``out[r,h,:] = Σ_e softmax_e(lrelu(sd[r,h] + ss[c_e,h])) · keep ·
    h2[c_e,h,:]`` through K3, the port of the custom VJP ``gat_fused_p``
    (``segment_kernels.py:1200-1232``): the forward runs the ``fwd`` pass
    and divides by the clamped denominator in plain torch; the backward runs
    ``dsd`` over the CSR and ``dsrc`` over the CSC and returns the
    cotangents of ``sd``, ``ss`` and ``h2`` (``h2`` flat ``[n, H·D]``).

    Inputs: ``sd``, ``ss``, ``h2``; the CSR (``fw_ptr``, ``fw_col``,
    ``fw_orig``) and CSC (``bw_ptr``, ``bw_col``, ``bw_orig``) of
    ``prepare_spmm``; ``seed`` (one-element int64 tensor or None),
    ``alpha``, ``attn_drop``; then optionally each direction's prepared
    :class:`SpmmSchedule`. The softmax shift ``lrelu(sd + max ss)`` is
    exact and gets no gradient.

    Over the panel-major CSR of ``prepare_spmm_device`` (``fw_ptr`` and
    ``bw_ptr`` 2-D) each of the three sweeps is one accumulating pass per
    panel; the shift does not depend on the panel, so the panels' partial
    sums add up exactly. ``fw_orig``/``bw_orig`` are then None: the dropout
    mask is hashed from the edges' coordinates."""

    @staticmethod
    def forward(ctx, sd, ss, h2, fw_ptr, fw_col, fw_orig, bw_ptr, bw_col,
                bw_orig, seed, alpha: float, attn_drop: float,
                fw_schedule=None, bw_schedule=None):
        sd, ss, h2 = sd.contiguous(), ss.contiguous(), h2.contiguous()
        n, H = sd.shape
        smax = ss.detach().amax(0).contiguous()
        num, den = _gat_sweep("fwd", fw_ptr, fw_col, fw_orig, fw_schedule,
                              sd, ss, smax, h2, alpha=alpha,
                              attn_drop=attn_drop, seed=seed)
        den = den.clamp_min(1e-16)
        out = (num.view(n, H, -1) / den[:, :, None]).view(n, -1)
        ctx.save_for_backward(sd, ss, h2, smax, den, out, fw_ptr, fw_col,
                              fw_orig, bw_ptr, bw_col, bw_orig, seed)
        ctx.alpha, ctx.attn_drop = alpha, attn_drop
        ctx.schedules = fw_schedule, bw_schedule
        return out

    @staticmethod
    def backward(ctx, g):
        (sd, ss, h2, smax, den, out, fw_ptr, fw_col, fw_orig, bw_ptr, bw_col,
         bw_orig, seed) = ctx.saved_tensors
        fw_schedule, bw_schedule = ctx.schedules
        n, H = sd.shape
        g = g.contiguous().view(n, H, -1)
        dagg = (g / den[:, :, None]).reshape(n, -1)
        dden = (-(g * out.view(n, H, -1)).sum(2) / den).contiguous()
        kw = dict(alpha=ctx.alpha, attn_drop=ctx.attn_drop, seed=seed)
        dsd = dss = dh2 = None
        if ctx.needs_input_grad[0]:
            (dsd,) = _gat_sweep("dsd", fw_ptr, fw_col, fw_orig, fw_schedule,
                                sd, ss, smax, h2, dagg, dden, **kw)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dh2, dss = _gat_sweep("dsrc", bw_ptr, bw_col, bw_orig,
                                  bw_schedule, sd, ss, smax, h2, dagg, dden,
                                  **kw)
        return (dsd, dss, dh2) + (None,) * 11
