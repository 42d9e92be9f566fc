"""CUDA kernel tier — the port of ``cogdl_tpu/ops/pallas/__init__.py``.

``prepare_spmm(graph)`` builds the kernels' structure once per graph and
stores it in ``graph.extras``; ``maybe_cuda_spmm`` then routes ``spmm``
through the hand-written CUDA CSR kernel (K1) and ``maybe_cuda_gat_fused``
routes GAT attention through the fused attention kernel (K3) for CUDA
tensors. ``device_layout.prepare_spmm_device`` builds the structure on the
graph's own device, optionally grouped by source panel; both store it under
the same ``spmm_fw_*``/``spmm_bw_*`` names, and ``meta["spmm_panel_rows"]``
tells the dispatchers which it is: 0, one CSR per direction (K1, K3
single-shot); above 0, a panel-major CSR (K2, K3 accumulating). Both also
store the schedule that cuts each structure's edges into one warp's chunks
(``spmm_*_<field>`` for each field of ``SpmmSchedule``), which the
dispatchers hand to K1, K2 and K3.
``gather_kernels`` holds the gather probes K4-K6, which no model runs: the
script ``cogdl_tpu_torch.scripts.microbench_gather`` drives them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .device_layout import (  # noqa: F401  (public kernel-tier re-exports)
    CHUNK_EDGES,
    SCHEDULE_KEYS,
    SpmmSchedule,
    build_spmm_schedule,
    build_spmm_structure,
    default_panel_rows,
    prepare_spmm_device,
)
from .gather_kernels import (  # noqa: F401  (public kernel-tier re-exports)
    gather_block_sum,
    gather_block_sum_reference,
    gather_rows_sum,
    gather_rows_sum_reference,
    gather_window_sum,
    gather_window_sum_reference,
)
from .segment_kernels import (  # noqa: F401  (public kernel-tier re-exports)
    GAT_MAX_HEADS,
    GATFusedFunction,
    SpMMFunction,
    SpMMPanelFunction,
    gat_pass,
    gat_pass_chunked_reference,
    gat_pass_reference,
    reset_launch_counts,
    spmm_csr,
    spmm_csr_accum,
    spmm_csr_accum_reference,
    spmm_csr_chunked_reference,
    spmm_csr_reference,
)

_KEYS = ("spmm_fw_ptr", "spmm_fw_col", "spmm_fw_w",
         "spmm_bw_ptr", "spmm_bw_col", "spmm_bw_w")


def _row_ptr(ids: torch.Tensor, n: int) -> torch.Tensor:
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
    ptr[1:] = torch.cumsum(torch.bincount(ids, minlength=n), 0)
    return ptr.int()


def prepare_spmm(graph):
    """Attach the kernels' structure for both directions to the graph: the
    CSR of A (``spmm_fw_ptr``, ``spmm_fw_col``, ``spmm_fw_w``) for the
    forward and the CSR of Aᵀ, i.e. the CSC of A (``spmm_bw_*``), for the
    backward. ``spmm_fw_orig``/``spmm_bw_orig`` hold each entry's position
    in the graph's edge list, the key of K3's dropout hash, so that both
    directions draw the same mask per edge (as
    ``cogdl_tpu/ops/pallas/__init__.py:55-57`` maps them). int32 indices,
    built from the first ``num_edges`` edges only: pad edges all sit in the
    sink row and would give one warp up to a quarter of E serial
    iterations. Beside each direction goes its :class:`SpmmSchedule`
    (``spmm_*_<field>``). The weights are ``edge_weight``'s at the call; a
    later change of the graph's weights rebuilds them
    (:func:`reweighted_structure`). Runs on the graph's device."""
    E, n = graph.num_edges, graph.n_pad
    if E >= 2 ** 31:
        raise ValueError(f"prepare_spmm: {E} edges overflow int32 indices")
    row = graph.row[:E].long()
    col = graph.col[:E].long()
    w = graph.edge_weight[:E].detach().float()
    # the graph's edges are already in CSR order (sorted by row, then col)
    order = torch.argsort(col, stable=True)
    extras = {k: v for k, v in (graph.extras or {}).items()
              if not k.startswith("spmm_")}
    extras.update({
        "spmm_fw_ptr": _row_ptr(row, n),
        "spmm_fw_col": col.int().contiguous(),
        "spmm_fw_w": w.contiguous(),
        "spmm_fw_orig": torch.arange(E, dtype=torch.int32, device=row.device),
        "spmm_bw_ptr": _row_ptr(col, n),
        "spmm_bw_col": row[order].int().contiguous(),
        "spmm_bw_w": w[order].contiguous(),
        "spmm_bw_orig": order.int().contiguous(),
    })
    for d, erow in (("fw", row), ("bw", col[order])):
        sched = build_spmm_schedule(extras[f"spmm_{d}_ptr"],
                                    erow=erow.int())
        extras.update({f"spmm_{d}_{k}": t
                       for k, t in sched._asdict().items()})
    return graph.replace(extras=extras).with_meta(spmm_panel_rows=0)


def reweighted_structure(graph):
    """``graph.extras`` with the kernel structure's weights taken from
    ``graph.edge_weight``: ``spmm_fw_w`` keeps the weights' gradient (K1's
    ``dw`` reaches them through :class:`SpMMFunction`), ``spmm_bw_w`` is a
    constant, each one gather of ``num_edges`` floats through the entries'
    positions in the edge list (``spmm_*_orig``). Pointers, columns and
    schedules stay. Extras without weights (the fused GAT structure) are
    returned as they are: nothing in them is stale. A panel-major structure,
    or one without ``spmm_*_orig``, has no map back to the edge list and
    raises rather than keep the old weights."""
    extras = graph.extras
    if not extras or "spmm_fw_w" not in extras:
        return extras
    if _panel_route(graph) or not all(
            f"spmm_{d}_orig" in extras for d in ("fw", "bw")):
        raise ValueError(
            "cannot reweight this kernel structure: it is panel-major or has "
            "no spmm_*_orig map back to the edge list; prepare the graph "
            "again (prepare_spmm) after changing its weights")
    w = graph.edge_weight[: graph.num_edges].float()
    return {**extras,
            "spmm_fw_w": w.index_select(0, extras["spmm_fw_orig"]),
            "spmm_bw_w": w.detach().index_select(0, extras["spmm_bw_orig"])}


def stored_schedule(extras, direction: str) -> Optional[SpmmSchedule]:
    """The schedule stored in ``extras`` for ``"fw"`` or ``"bw"``, None for
    a structure that has none (the wrappers then build it from the row
    pointers on every call)."""
    keys = [f"spmm_{direction}_{k}" for k in SCHEDULE_KEYS]
    if not all(k in extras for k in keys):
        return None
    return SpmmSchedule(*(extras[k] for k in keys))


def _panel_route(graph) -> bool:
    """Whether the graph's structure is a panel-major CSR, by its meta; the
    row pointers' rank must agree."""
    panels = int(graph.meta_get("spmm_panel_rows", 0)) > 0
    if panels != (graph.extras["spmm_fw_ptr"].ndim == 2):
        raise ValueError(
            f"meta spmm_panel_rows={graph.meta_get('spmm_panel_rows', 0)} "
            f"does not match the rank of extras['spmm_fw_ptr'] "
            f"({graph.extras['spmm_fw_ptr'].ndim}): the graph's structure "
            "was not attached by prepare_spmm or prepare_spmm_device")
    return panels


def maybe_cuda_spmm(graph, x: torch.Tensor) -> Optional[torch.Tensor]:
    """K1 through :class:`SpMMFunction`, or K2 through
    :class:`SpMMPanelFunction` over a panel structure, when the graph
    carries the prepared structure with its weights. A CPU tensor without
    it returns None (the caller takes the plain tier); a CUDA tensor
    without it raises."""
    extras = graph.extras
    if not extras or "spmm_fw_w" not in extras:
        if x.is_cuda:
            raise RuntimeError(
                "spmm on a CUDA tensor runs the CSR kernel, which needs the "
                "structure from cogdl_tpu_torch.ops.cuda.prepare_spmm(graph) "
                "or prepare_spmm_device(graph), with its weights "
                "(store_w=True)")
        return None
    if x.ndim != 2:
        raise ValueError(f"spmm takes [n_pad, F] features, got {tuple(x.shape)}")
    fn = SpMMPanelFunction if _panel_route(graph) else SpMMFunction
    return fn.apply(x, *(extras[k] for k in _KEYS),
                    stored_schedule(extras, "fw"),
                    stored_schedule(extras, "bw"))


_GAT_KEYS = ("spmm_fw_ptr", "spmm_fw_col", "spmm_fw_orig",
             "spmm_bw_ptr", "spmm_bw_col", "spmm_bw_orig")


def has_gat_structure(graph) -> bool:
    """Whether ``graph`` carries the structure the fused GAT route reads: a
    panel structure, or a one-panel one with ``spmm_*_orig``."""
    extras = graph.extras
    return bool(extras) and "spmm_fw_ptr" in extras and (
        _panel_route(graph) or "spmm_fw_orig" in extras)


def draw_gat_seed(generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """K3's dropout seed, one int64 in ``[0, 2³¹ − 1)`` from ``generator``
    on ``device``."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=device)


def maybe_cuda_gat_fused(graph, score_dst: torch.Tensor,
                         score_src: torch.Tensor, h: torch.Tensor,
                         alpha: float = 0.2, attn_drop: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         seed: Optional[torch.Tensor] = None
                         ) -> Optional[torch.Tensor]:
    """Fused GAT attention (scores, softmax, dropout, aggregation) through
    K3 and :class:`GATFusedFunction` when the graph carries the prepared
    structure — the counterpart of ``maybe_gat_fused``, with each
    direction's stored schedule. A panel structure
    takes K3's accumulating form, one pass per panel with the
    coordinate-keyed dropout hash (parallel edges then share one keep/drop
    decision, as in the JAX package), and needs no ``spmm_*_orig``. ``h`` is
    ``[n_pad, H, D]``, the score halves ``[n_pad, H]``; ``score_src`` must
    equal ``Σ_d a_src·h``. With ``attn_drop > 0`` one seed in
    ``[0, 2³¹ − 1)`` is drawn from ``generator`` per call
    (:func:`draw_gat_seed`), unless ``seed`` gives the one drawn ahead (a
    checkpointed caller draws it outside the recomputed call). Returns
    ``[n_pad, H, D]``; None for a CPU tensor on a graph without the
    structure (the caller takes the unfused route); raises for a CUDA
    tensor without it."""
    extras = graph.extras
    if not has_gat_structure(graph):
        if h.is_cuda:
            raise RuntimeError(
                "GAT attention on a CUDA tensor runs the fused attention "
                "kernel, which needs the structure from "
                "cogdl_tpu_torch.ops.cuda.prepare_spmm(graph) or "
                "prepare_spmm_device(graph, with_orig=True)")
        return None
    H, D = h.shape[1], h.shape[2]
    if H > GAT_MAX_HEADS:
        raise ValueError(f"the fused GAT kernel takes at most {GAT_MAX_HEADS} "
                         f"heads, got {H}")
    if attn_drop <= 0.0:
        seed = None
    elif seed is None:
        seed = draw_gat_seed(generator, h.device)
    out = GATFusedFunction.apply(score_dst, score_src, h.reshape(-1, H * D),
                                 *(extras.get(k) for k in _GAT_KEYS), seed,
                                 float(alpha), float(attn_drop),
                                 stored_schedule(extras, "fw"),
                                 stored_schedule(extras, "bw"))
    return out.view(-1, H, D)
