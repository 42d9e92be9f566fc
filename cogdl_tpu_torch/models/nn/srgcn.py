"""SRGCN — the port of ``cogdl_tpu/models/nn/srgcn.py``: a GCN whose
propagation matrix is one of six attention types under one of five
normalisations, each written as edge operations.

Attention types: ``identity``, ``node``, ``edge`` and ``heat`` rewrite the
edge weights; ``ppr`` and ``gaussian`` propagate a series
``Σ_i θ_i A^i h`` at aggregation time. Normalisations (``_normalize``):
``identity``, ``row_uniform``, ``row_softmax``, ``col_uniform`` and
``symmetry``. Propagation is ``spmm_coo`` (gather and ``index_add``), as in
the JAX package, on every device: the weights change in each forward, so
no kernel structure is built for them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...layers.utils import CDense, dropout, reset_parameters
from ...ops import segment as seg
from ...ops import spmm_coo

ATTENTION_TYPES = ("node", "edge", "identity", "gaussian", "ppr", "heat")
NORM_TYPES = ("identity", "row_uniform", "row_softmax", "col_uniform",
              "symmetry")


def _degrees(graph: Graph) -> torch.Tensor:
    """Real edges a destination row, at least 1."""
    ones = graph.edge_mask().float()
    return seg.segment_sum(ones, graph.row, graph.n_pad).clamp_min(1.0)


def _normalize(norm: str, graph: Graph, w: torch.Tensor) -> torch.Tensor:
    """The five normalisations of the edge weights ``w``."""
    row, col, n = graph.row, graph.col, graph.n_pad
    if norm == "identity":
        return w
    if norm == "row_softmax":
        w = torch.exp(w) * graph.edge_mask()
    s_row = seg.segment_sum(w, row, n)
    if norm in ("row_uniform", "row_softmax"):
        return w / seg.gather(s_row, row).clamp_min(1e-12)
    if norm == "col_uniform":
        return w / seg.gather(s_row, col).clamp_min(1e-12)
    if norm == "symmetry":
        inv_sqrt = torch.rsqrt(s_row.clamp_min(1e-12))
        return w * seg.gather(inv_sqrt, row) * seg.gather(inv_sqrt, col)
    raise ValueError(f"normalization {norm!r}; known: {NORM_TYPES}")


def _ppr_series(alpha: float = 0.4, steps: int = 4):
    series, th = [alpha], alpha * (1 - alpha)
    for _ in range(steps - 1):
        series.append(th)
        th *= (1 - alpha)
    return series


def _gaussian_series(theta: float = 1.0, steps: int = 4):
    """Bessel coefficients of the Chebyshev expansion of ``exp(-θ(L−μI))``,
    as the JAX package takes them."""
    from scipy.special import iv

    coef = [float(iv(i, theta)) for i in range(steps)]
    coef[1:] = [(-1.0) ** i * 2 * c for i, c in enumerate(coef[1:])]
    return coef


class SRGCNLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 attention: str = "node", normalization: str = "row_uniform",
                 nhop: int = 1, subheads: int = 2, dropout: float = 0.5):
        super().__init__()
        if attention not in ATTENTION_TYPES:
            raise ValueError(
                f"attention {attention!r}; known: {ATTENTION_TYPES}")
        if normalization not in NORM_TYPES:
            raise ValueError(
                f"normalization {normalization!r}; known: {NORM_TYPES}")
        self.attention = attention
        self.normalization = normalization
        self.nhop = nhop
        self.subheads = subheads
        self.dropout = dropout
        for r in range(subheads):
            self.add_module(f"W{r}", CDense(in_features, out_features,
                                            bias=False))
            if attention in ("node", "edge"):
                self.add_module(f"att_p{r}", CDense(out_features, 1))
            if attention == "edge":
                self.add_module(f"att_q{r}", CDense(out_features, 1))
            if attention == "heat":
                self.register_parameter(f"heat_t{r}",
                                        nn.Parameter(torch.zeros(1)))

    def reset_own_parameters(self, generator=None):
        with torch.no_grad():
            for r in range(self.subheads):
                if self.attention == "heat":
                    getattr(self, f"heat_t{r}").zero_()

    def _weights(self, graph: Graph, h: torch.Tensor, r: int, deg_inv):
        """The edge weights of subhead ``r`` before normalisation, and the
        propagation series (None: ``nhop`` plain steps)."""
        w0, row, col = graph.edge_weight, graph.row, graph.col
        if self.attention == "identity":
            return w0, None
        if self.attention == "node":
            diag = torch.sigmoid(getattr(self, f"att_p{r}")(h))[:, 0]
            return (w0 * seg.gather(deg_inv, row)
                    * seg.gather(diag, col)), None
        if self.attention == "edge":
            p = F.relu(getattr(self, f"att_p{r}")(h))[:, 0]
            q = F.relu(getattr(self, f"att_q{r}")(h))[:, 0]
            dis = torch.rsqrt(_degrees(graph))
            wt = w0 * seg.gather(dis, row) * seg.gather(dis, col)
            return wt * (seg.gather(p, col) + seg.gather(q, row)), None
        if self.attention == "heat":
            t = getattr(self, f"heat_t{r}")
            w = torch.exp(t * w0 * seg.gather(deg_inv, col) - t)
            return w * graph.edge_mask(), None
        if self.attention == "ppr":
            dis = torch.rsqrt(_degrees(graph))
            return (w0 * seg.gather(dis, row) * seg.gather(dis, col),
                    _ppr_series())
        # gaussian
        return w0 * seg.gather(deg_inv, row), _gaussian_series()

    def forward(self, graph: Graph, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        deg_inv = 1.0 / _degrees(graph)
        row, col, n = graph.row, graph.col, graph.n_pad
        out = 0.0
        for r in range(self.subheads):
            h = getattr(self, f"W{r}")(x)
            w, series = self._weights(graph, h, r, deg_inv)
            w = _normalize(self.normalization, graph, w)
            if series is None:
                z = h
                for _ in range(self.nhop):
                    z = spmm_coo(z, row, col, w, n)
            else:
                z, t = series[0] * h, h
                for c in series[1:]:
                    t = spmm_coo(t, row, col, w, n)
                    z = z + c * t
            out = out + z
        out = out / self.subheads
        if self.dropout > 0 and training:
            out = dropout(out, self.dropout, generator)
        return out


class SRGCN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, attention: str = "node",
                 normalization: str = "row_uniform", nhop: int = 1,
                 subheads: int = 2, dropout: float = 0.5):
        super().__init__()
        kw = dict(attention=attention, normalization=normalization,
                  nhop=nhop, subheads=subheads)
        self.layer0 = SRGCNLayer(in_features, hidden_size, dropout=dropout,
                                 **kw)
        self.layer1 = SRGCNLayer(hidden_size, out_features, dropout=0.0, **kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        h = F.leaky_relu(self.layer0(graph, x, training, generator))
        return self.layer1(graph, h, training, generator)
