"""Device-side construction of the kernels' panel structure — the port of
``cogdl_tpu/ops/pallas/device_layout.py``.

``prepare_spmm`` (``ops/cuda/__init__.py``) builds one CSR per direction
from a graph whose edges are already in CSR order. This module builds the
structure from any edge list with torch ops on the edge list's own device,
so a graph generated on the card never visits the host, and it can group
the edges by **source panel** (``col // panel_rows``): one kernel call then
gathers from one slice of the feature table, and K2
(``spmm_csr_accum``) or K3's accumulating form adds each panel's partial
sums into one output.

The structure is a panel-major CSR: edges sorted by (panel, row, col), the
three keys of the JAX package's layout, global int32 column indices, one row
pointer array per panel, ``ptr[p, r]`` the offset of panel ``p``'s first
edge of row ``r`` in the flat ``col`` (``ptr`` is ``[n_panels, n_pad + 1]``;
``[n_pad + 1]`` without panels). The sort is total up to parallel edges, so
the transposed build of a symmetric edge set gives the same arrays, which
is what lets ``symmetric=True`` share one structure between directions.

Beside every structure goes its **schedule** (:func:`build_spmm_schedule`):
the flat edge array cut into chunks of about ``CHUNK_EDGES`` edges, one
warp's work each in K1, K2 and K3, so that the kernels' load does not
depend on the degree distribution.

What the JAX package adds on top of this is layout for the TPU's kernels
and has no counterpart here: 1024-slot chunks and their tile map, mega-block
alignment, the packed slot stream, panel-local indices and per-direction
panel heights.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

# Source panels of a device-prepared structure, where the caller names no
# height, for K1/K2 and for fused GAT alike. Not a choice for speed: in the
# panel sweeps of chip_smoke.py at the products shape (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md §6) the GCN and the GAT step are fastest with no
# panels at all and get slower with every panel added, since K2 and K3 cost
# their bytes and every panel reads and writes the accumulators again. Two,
# the fewest that are panels, keep K2 and K3's accumulating form (the ports
# of the JAX package's panel loops) on the path of a graph prepared on the
# device, a few percent behind ``panel_rows=0``, which takes the
# single-shot kernels.
SPMM_PANELS = 2


# Edges a warp of K1, K2 and K3 takes (T). Read off K1/K2's sweep of
# chip_smoke.py over 32, 64, 128 and 256 (PERF.md §6).
CHUNK_EDGES = 128


class SpmmSchedule(NamedTuple):
    """How K1, K2 and K3 cut one structure's edges into chunks, one warp a
    chunk.

    ``erow`` int32 ``[nnz]``: the row of every entry of the flat ``col``.
    ``chunk_start`` int32 ``[n_chunks + 1]`` (``[n_panels, n_chunks + 1]``
    for a panel structure, a panel with fewer chunks padded with its end):
    chunk ``c`` holds the edges ``[chunk_start[c], chunk_start[c + 1])``,
    fewer than ``2·T`` of them; its first row is ``erow[chunk_start[c]]``.
    ``cross`` int32 ``[n_cross, 3]`` (``[n_panels, n_cross, 3]``): the rows
    that lie in more than one chunk, exactly those with more than ``T``
    edges, as ``(row, first chunk, last chunk)``, padded with −1. It is
    empty when no row is longer than ``T``: the statistic the K1 and K3
    wrappers choose their kernel by.
    ``piece_start`` int32, shaped as ``chunk_start``: the pieces of cut rows
    that the chunks before ``c`` hold. A chunk holds at most two, in the
    order of its edges: the end of a row that began earlier, in slot
    ``piece_start[c]`` of the kernels' scratch, and the start of a row that
    goes on, in slot ``piece_start[c + 1] − 1``; so the pieces of one row
    fill the slots from ``piece_start[first + 1] − 1`` on, in chunk order.
    ``piece_row`` int32 ``[n_pieces]`` (``[n_panels, n_pieces]``, padded
    with −1): the row of the piece in every slot. Its length is the number
    of rows the scratch needs, known without asking the device."""

    erow: torch.Tensor
    chunk_start: torch.Tensor
    cross: torch.Tensor
    piece_start: torch.Tensor
    piece_row: torch.Tensor

    def panel(self, p: int) -> "SpmmSchedule":
        """The schedule of panel ``p`` of a panel structure."""
        return SpmmSchedule(self.erow, self.chunk_start[p], self.cross[p],
                            self.piece_start[p], self.piece_row[p])


SCHEDULE_KEYS = SpmmSchedule._fields


def build_spmm_schedule(ptr: torch.Tensor, chunk_edges: int = CHUNK_EDGES,
                        erow: Optional[torch.Tensor] = None) -> SpmmSchedule:
    """The :class:`SpmmSchedule` of the CSR ``ptr`` (int32, ``[n + 1]``, or
    ``[n_panels, n + 1]`` with offsets into one flat edge array), built with
    torch ops on ``ptr``'s device.

    Boundary ``c`` of a panel that starts at edge ``lo`` is ``lo + c·T``,
    moved back to the start of the row that holds that edge when the row
    has at most ``T`` edges. So a row of at most ``T`` edges lies in one
    chunk, a longer row is cut at multiples of ``T``, and every edge lies in
    exactly one chunk. ``erow``: the per-edge row ids where the caller has
    them already (they are derived from ``ptr`` otherwise; entries before
    ``ptr``'s first edge are then zero)."""
    T = int(chunk_edges)
    if T <= 0:
        raise ValueError(f"build_spmm_schedule: chunk_edges must be positive, "
                         f"got {chunk_edges}")
    ptrs = ptr if ptr.ndim == 2 else ptr[None]
    n_panels, n = ptrs.shape[0], ptrs.shape[1] - 1
    dev = ptr.device
    lens = ptrs[:, 1:] - ptrs[:, :-1]
    lo, hi = ptrs[:, 0], ptrs[:, -1]
    if erow is None:
        rows = torch.arange(n, dtype=torch.int32, device=dev).repeat(n_panels)
        erow = torch.cat([
            torch.zeros(int(lo[0]) if n_panels else 0, dtype=torch.int32,
                        device=dev),
            torch.repeat_interleave(rows, lens.reshape(-1).long())])
    n_chunks = int(((hi - lo + (T - 1)) // T).max()) if n_panels else 0
    # the raw boundaries lo + c·T, cut off at the panel's end
    raw = torch.minimum(
        lo[:, None] + T * torch.arange(n_chunks + 1, dtype=torch.int32,
                                       device=dev)[None], hi[:, None])
    # the row that holds each boundary's edge: the last one starting at or
    # before it (rows without an edge are skipped)
    r = (torch.searchsorted(ptrs, raw, right=True) - 1).clamp_(0, max(n - 1, 0))
    if n:
        snap = (raw < hi[:, None]) & (lens.gather(1, r) <= T)
        chunk_start = torch.where(snap, ptrs.gather(1, r), raw)
    else:
        chunk_start = raw
    # rows longer than T are cut at multiples of T from the panel's start
    xp, xr = torch.nonzero(lens > T, as_tuple=True)
    first = torch.div(ptrs[xp, xr] - lo[xp], T,
                      rounding_mode="floor").long()
    last = torch.div(ptrs[xp, xr + 1] - 1 - lo[xp], T,
                     rounding_mode="floor").long()
    per_panel = torch.bincount(xp, minlength=n_panels)
    n_cross = int(per_panel.max()) if n_panels else 0
    cross = torch.full((n_panels, n_cross, 3), -1, dtype=torch.int32,
                       device=dev)
    slot = torch.arange(xp.numel(), device=dev) - (
        torch.cumsum(per_panel, 0) - per_panel)[xp]
    cross[xp, slot] = torch.stack([xr.int(), first.int(), last.int()], 1)
    # pieces a chunk: one where a cut row goes on into it (first < c <= last;
    # the ranges of two cut rows do not overlap), one where a cut row starts
    held = torch.zeros((n_panels, n_chunks + 2), dtype=torch.int32,
                       device=dev)
    one = torch.ones_like(first, dtype=torch.int32)
    held.index_put_((xp, first + 1), one, accumulate=True)
    held.index_put_((xp, last + 1), -one, accumulate=True)
    held = torch.cumsum(held, 1, dtype=torch.int32)
    held.index_put_((xp, first), one, accumulate=True)
    piece_start = torch.zeros((n_panels, n_chunks + 1), dtype=torch.int32,
                              device=dev)
    torch.cumsum(held[:, :n_chunks], 1, dtype=torch.int32,
                 out=piece_start[:, 1:])
    n_pieces = int(piece_start[:, -1].max()) if n_panels else 0
    piece_row = torch.full((n_panels, n_pieces), -1, dtype=torch.int32,
                           device=dev)
    pieces = last - first + 1
    cut = torch.repeat_interleave(torch.arange(xp.numel(), device=dev), pieces)
    nth = torch.arange(cut.numel(), device=dev) - (
        torch.cumsum(pieces, 0) - pieces)[cut]
    base = piece_start[xp, first + 1].long() - 1
    piece_row[xp[cut], base[cut] + nth] = xr[cut].int()
    if ptr.ndim == 1:
        chunk_start, cross = chunk_start[0], cross[0]
        piece_start, piece_row = piece_start[0], piece_row[0]
    return SpmmSchedule(erow.contiguous(), chunk_start.int().contiguous(),
                        cross, piece_start, piece_row)


def default_panel_rows(n_pad: int, feat_bytes: int = 512,
                       budget_mb: int = 96) -> int:
    """Panel height whose slice of a ``feat_bytes``-a-row table fits
    ``budget_mb`` (the JAX function's default: its VMEM staging budget): 0
    (no panels) when the whole table fits, else ``n_pad`` split into the
    fewest equal panels that do. No default of the port's structures goes
    by it."""
    rows_budget = (budget_mb * 1_000_000) // feat_bytes
    if rows_budget <= 0:
        raise ValueError(f"a {feat_bytes}-byte row does not fit a budget of "
                         f"{budget_mb} MB")
    if n_pad <= rows_budget:
        return 0
    n_panels = -(-n_pad // rows_budget)
    return -(-n_pad // n_panels)


def build_spmm_structure(row: torch.Tensor, col: torch.Tensor,
                         weight: Optional[torch.Tensor], n_pad: int,
                         panel_rows: int = 0, with_orig: bool = False,
                         chunk_edges: int = CHUNK_EDGES
                         ) -> Dict[str, torch.Tensor]:
    """The (panel-major) CSR of the edges ``(row[e], col[e])`` over
    ``n_pad`` rows, built on the edges' device. ``row`` need not be sorted.

    Returns ``ptr`` (int32, ``[n_pad + 1]`` for ``panel_rows == 0``, else
    ``[n_panels, n_pad + 1]`` with offsets into the flat arrays), ``col``
    (int32, global indices, sorted by (panel, row, col)), ``w`` (float32, in
    that order; absent when ``weight`` is None) and, with ``with_orig``,
    ``orig``: each entry's position in the input edge list; and the
    tensors of the structure's :class:`SpmmSchedule` at ``chunk_edges``
    edges a chunk (``erow``, ``chunk_start``, ``cross``, ``piece_start``,
    ``piece_row``), which K1, K2 and K3 read."""
    E = row.numel()
    if E >= 2 ** 31 or n_pad >= 2 ** 31:
        raise ValueError(f"build_spmm_structure: {E} edges over {n_pad} rows "
                         "overflow int32 indices")
    n_panels = 1 if panel_rows <= 0 else -(-n_pad // panel_rows)
    if n_panels * (n_pad + 1) >= 2 ** 31:
        raise ValueError(
            f"build_spmm_structure: {n_panels} panels of {n_pad} rows make "
            "2³¹ row pointers or more; use taller panels")
    # one composite int64 key (panel, row, col): at most n_panels · n_pad²
    if n_panels * n_pad * n_pad >= 2 ** 63:
        raise ValueError("build_spmm_structure: the sort key overflows int64")
    key = row.long() * n_pad
    if panel_rows > 0:
        key += torch.div(col, panel_rows, rounding_mode="floor").long() * (
            n_pad * n_pad)
    key += col
    key, order = torch.sort(key, stable=True)
    out = {"col": (key % n_pad).int()}
    key //= n_pad                                   # panel · n_pad + row
    counts = torch.bincount(key, minlength=n_panels * n_pad)
    erow = (key % n_pad).int()
    del key
    flat = torch.zeros(n_panels * n_pad + 1, dtype=torch.int64,
                       device=row.device)
    torch.cumsum(counts, 0, out=flat[1:])
    del counts
    if panel_rows > 0:
        ptr = torch.empty((n_panels, n_pad + 1), dtype=torch.int32,
                          device=row.device)
        ptr[:, :-1] = flat[:-1].view(n_panels, n_pad)
        ptr[:, -1] = flat[n_pad::n_pad]
    else:
        ptr = flat.int()
    out["ptr"] = ptr
    if weight is not None:
        out["w"] = weight.detach().float()[order].contiguous()
    out.update(build_spmm_schedule(ptr, chunk_edges, erow)._asdict())
    if with_orig:
        out["orig"] = order.int()
    return out


def prepare_spmm_device(graph, symmetric: bool = False,
                        with_orig: bool = False,
                        panel_rows: Optional[int] = None,
                        store_w: Optional[bool] = None):
    """``prepare_spmm`` for a graph that lives on the device: attaches the
    kernels' structure, built there by :func:`build_spmm_structure`, under
    the same ``spmm_fw_*``/``spmm_bw_*`` names. Call after normalisation:
    only a one-panel structure with ``spmm_*_orig`` takes new weights later
    (``reweighted_structure``); any other refuses them.

    ``symmetric=True`` (an undirected graph under a symmetric
    normalisation, ``Aᵀ = A``): the backward uses the forward's tensors
    themselves, half the build and half the memory. Otherwise the transpose
    is built as well.

    ``panel_rows``: the source-panel height; None gives every structure
    ``SPMM_PANELS`` panels (K2, K3 accumulating); 0 builds one CSR (the
    single-shot kernels K1 and K3).
    ``meta["spmm_panel_rows"]`` records it and is what the dispatchers go
    by.

    ``with_orig=True`` is the structure for fused GAT. Without panels it
    stores each entry's position in the edge list per direction
    (``spmm_*_orig``, the key of K3's dropout hash; with ``symmetric`` only
    these differ between the directions). With panels it stores none: the
    accumulating K3 hashes the mask from each edge's (dst, src)
    coordinates.

    ``store_w`` (default ``not with_orig``): keep the weights. The fused
    GAT route never reads them. Without them a plain ``spmm`` on CUDA
    tensors raises (the JAX package falls back to its XLA tier there; the
    port has no fallback on the card) — pass ``store_w=True`` for a model
    that mixes attention and plain aggregation on one graph. The schedule
    that K1, K2 and K3 read (``spmm_*_erow``, ``spmm_*_chunk_start``,
    ``spmm_*_cross``, ``spmm_*_piece_start``, ``spmm_*_piece_row``, see
    :class:`SpmmSchedule`) is stored with every structure and, under
    ``symmetric``, shared between the directions as ``ptr`` is.

    The JAX function's further arguments (``r_tile``, ``block_chunks``,
    ``gather_bf16``, ``drop_empty_groups``, ``panel_rows_bw``,
    ``with_dropout``) shape TPU layouts only and are not accepted."""
    n_pad, E = graph.n_pad, graph.num_edges
    row, col = graph.row[:E], graph.col[:E]
    if store_w is None:
        store_w = not with_orig
    w = graph.edge_weight[:E] if store_w else None
    if panel_rows is None:
        panel_rows = -(-n_pad // SPMM_PANELS)
    orig = with_orig and panel_rows <= 0

    fwd = build_spmm_structure(row, col, w, n_pad, panel_rows, orig)
    if not symmetric:
        bwd = build_spmm_structure(col, row, w, n_pad, panel_rows, orig)
    elif orig:
        # the same arrays but for the map back to the edge list: entry s
        # read transposed is another edge of the list
        bwd = {**fwd, "orig": build_spmm_structure(
            col, row, None, n_pad, panel_rows, True)["orig"]}
    else:
        bwd = fwd

    # a re-prepare leaves nothing of an earlier structure behind
    extras = {k: v for k, v in (graph.extras or {}).items()
              if not k.startswith("spmm_")}
    for pre, lay in (("fw", fwd), ("bw", bwd)):
        for name, t in lay.items():
            extras[f"spmm_{pre}_{name}"] = t
    return graph.replace(extras=extras).with_meta(
        spmm_panel_rows=int(max(panel_rows, 0)))
