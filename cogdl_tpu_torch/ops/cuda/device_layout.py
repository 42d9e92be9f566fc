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

What the JAX package adds on top of this is layout for the TPU's kernels
and has no counterpart here: 1024-slot chunks and their tile map, mega-block
alignment, the packed slot stream, panel-local indices and per-direction
panel heights.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# Default size of one panel's slice of the feature table, in MB: a fifth of
# the H100's 50 MB L2. In the panel sweep of chip_smoke.py at the products
# shape (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, "Panel sweep") the GCN
# step got faster with every halving of the slice down to 5-10 MB and slower
# again at 2.5 MB, while the row pointers (4 bytes a row and panel) grow
# with every halving.
PANEL_BUDGET_MB = 10


def default_panel_rows(n_pad: int, feat_bytes: int = 512,
                       budget_mb: int = PANEL_BUDGET_MB) -> int:
    """Panel height whose slice of a ``feat_bytes``-a-row table fits
    ``budget_mb``: 0 (no panels) when the whole table fits, else ``n_pad``
    split into the fewest equal panels that do."""
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
                         panel_rows: int = 0, with_orig: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """The (panel-major) CSR of the edges ``(row[e], col[e])`` over
    ``n_pad`` rows, built on the edges' device. ``row`` need not be sorted.

    Returns ``ptr`` (int32, ``[n_pad + 1]`` for ``panel_rows == 0``, else
    ``[n_panels, n_pad + 1]`` with offsets into the flat arrays), ``col``
    (int32, global indices, sorted by (panel, row, col)), ``w`` (float32, in
    that order; absent when ``weight`` is None) and, with ``with_orig``,
    ``orig``: each entry's position in the input edge list."""
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
    the structure snapshots ``edge_weight``.

    ``symmetric=True`` (an undirected graph under a symmetric
    normalisation, ``Aᵀ = A``): the backward uses the forward's tensors
    themselves, half the build and half the memory. Otherwise the transpose
    is built as well.

    ``panel_rows``: the source-panel height; None sizes it with
    :func:`default_panel_rows` for 128 fp32 columns, 0 builds one CSR (the
    single-shot kernels K1 and K3). ``meta["spmm_panel_rows"]`` records it
    and is what the dispatchers go by.

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
    that mixes attention and plain aggregation on one graph.

    The JAX function's further arguments (``r_tile``, ``block_chunks``,
    ``gather_bf16``, ``drop_empty_groups``, ``panel_rows_bw``,
    ``with_dropout``) shape TPU layouts only and are not accepted."""
    n_pad, E = graph.n_pad, graph.num_edges
    row, col = graph.row[:E], graph.col[:E]
    if store_w is None:
        store_w = not with_orig
    w = graph.edge_weight[:E] if store_w else None
    if panel_rows is None:
        panel_rows = default_panel_rows(n_pad)
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
