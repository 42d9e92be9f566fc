"""CUDA kernel tier — the port of ``cogdl_tpu/ops/pallas/__init__.py``.

``prepare_spmm(graph)`` builds the kernels' structure once per graph and
stores it in ``graph.extras``; ``maybe_cuda_spmm`` then routes ``spmm``
through the hand-written CUDA CSR kernel (K1) and ``maybe_cuda_gat_fused``
routes GAT attention through the fused attention kernel (K3) for CUDA
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from .segment_kernels import (  # noqa: F401  (public kernel-tier re-exports)
    GAT_MAX_HEADS,
    GATFusedFunction,
    SpMMFunction,
    gat_pass,
    gat_pass_reference,
    spmm_csr,
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
    iterations. Call after normalisation: the structure snapshots
    ``edge_weight``. Runs on the graph's device."""
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
    return graph.replace(extras=extras)


def maybe_cuda_spmm(graph, x: torch.Tensor) -> Optional[torch.Tensor]:
    """K1 through :class:`SpMMFunction` when the graph carries the prepared
    structure. A CPU tensor without the structure returns None (the caller
    takes the plain tier); a CUDA tensor without it raises."""
    extras = graph.extras
    if not extras or "spmm_fw_ptr" not in extras:
        if x.is_cuda:
            raise RuntimeError(
                "spmm on a CUDA tensor runs the CSR kernel, which needs the "
                "structure from cogdl_tpu_torch.ops.cuda.prepare_spmm(graph)")
        return None
    if x.ndim != 2:
        raise ValueError(f"spmm takes [n_pad, F] features, got {tuple(x.shape)}")
    return SpMMFunction.apply(x, *(extras[k] for k in _KEYS))


_GAT_KEYS = ("spmm_fw_ptr", "spmm_fw_col", "spmm_fw_orig",
             "spmm_bw_ptr", "spmm_bw_col", "spmm_bw_orig")


def maybe_cuda_gat_fused(graph, score_dst: torch.Tensor,
                         score_src: torch.Tensor, h: torch.Tensor,
                         alpha: float = 0.2, attn_drop: float = 0.0,
                         generator: Optional[torch.Generator] = None
                         ) -> Optional[torch.Tensor]:
    """Fused GAT attention (scores, softmax, dropout, aggregation) through
    K3 and :class:`GATFusedFunction` when the graph carries the prepared
    structure — the counterpart of ``maybe_gat_fused``. ``h`` is
    ``[n_pad, H, D]``, the score halves ``[n_pad, H]``; ``score_src`` must
    equal ``Σ_d a_src·h``. With ``attn_drop > 0`` one seed in
    ``[0, 2³¹ − 1)`` is drawn from ``generator`` per call. Returns
    ``[n_pad, H, D]``; None for a CPU tensor on a graph without the
    structure (the caller takes the unfused route); raises for a CUDA
    tensor without it."""
    extras = graph.extras
    if not extras or "spmm_fw_orig" not in extras:
        if h.is_cuda:
            raise RuntimeError(
                "GAT attention on a CUDA tensor runs the fused attention "
                "kernel, which needs the structure from "
                "cogdl_tpu_torch.ops.cuda.prepare_spmm(graph)")
        return None
    H, D = h.shape[1], h.shape[2]
    if H > GAT_MAX_HEADS:
        raise ValueError(f"the fused GAT kernel takes at most {GAT_MAX_HEADS} "
                         f"heads, got {H}")
    seed = None
    if attn_drop > 0.0:
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=h.device)
    out = GATFusedFunction.apply(score_dst, score_src, h.reshape(-1, H * D),
                                 *(extras[k] for k in _GAT_KEYS), seed,
                                 float(alpha), float(attn_drop))
    return out.view(-1, H, D)
