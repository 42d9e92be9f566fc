"""STGCN, the spatio-temporal GCN for traffic forecasting — the port of
``cogdl_tpu/models/nn/stgcn.py`` (``TemporalGatedConv``, ``STConvBlock``,
``STGCN``). The input is a window ``[B, T, n_pad, C]``; each block is a
gated temporal convolution, a graph convolution on every (batch, time)
slice, a second gated temporal convolution and a layer norm; a
convolution over the time left and a dense head give ``[B, n_pad, out]``.

The spatial step: the JAX model maps ``spmm`` over the ``B·T`` slices
(``jax.vmap``). Here it is ONE ``spmm`` over the block-diagonal union of
``B·T`` copies of the normalised road graph (``data.batch.block_union``),
whose rows line up with ``[B, T, n_pad, S]`` viewed as ``[B·T·n_pad, S]``:
one K1 call a block on the card, at ``spatial_channels`` wide, and one
over the transpose in the backward. The unions come from the graph's
``extras["slice_unions"]`` (built once, with their kernel structure, by
the traffic wrapper's ``prepare_graph`` through :meth:`prepare_unions`);
a model called on a graph without them builds each copy count's union
once and keeps those of the last such graph.

``adj_norm = "sym"``: the JAX model normalises inside its forward; here
the unions copy the normalised graph (:meth:`STGCN.union_source`), free on
a graph the wrapper normalised already.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.batch import block_union
from ...data.graph import Graph, sym_norm
from ...layers.utils import CDense, reset_parameters
from ...ops import spmm
from ...ops.cuda import prepare_spmm


def _lecun_conv_(conv: nn.Conv2d,
                 generator: Optional[torch.Generator] = None) -> None:
    """A convolution as flax initialises it: a LeCun-normal kernel over
    ``in · kernel size`` inputs (a normal truncated at ±2σ, σ corrected for
    the truncation) and a zero bias."""
    fan_in = conv.in_channels * math.prod(conv.kernel_size)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        conv.bias.zero_()


def _time_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax's ``Conv`` of kernel ``(k, 1)``, VALID, over ``[B, T, N, C]``:
    torch's NCHW convolution with time as the height, back to ``[B, T',
    N, C']``."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class TemporalGatedConv(nn.Module):
    """A causal convolution over time, ``kt`` steps wide, to ``2·channels``
    and the GLU gate ``p · sigmoid(q)``: ``[B, T, N, C]`` to ``[B, T − kt
    + 1, N, channels]``."""

    def __init__(self, in_channels: int, channels: int, kt: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, 2 * channels, (kt, 1))

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        _lecun_conv_(self.conv, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, q = _time_conv(self.conv, x).chunk(2, dim=-1)
        return p * torch.sigmoid(q)


class TrafficModel(nn.Module):
    """What STGCN and STGAT share: the unions of road-graph copies, one a
    (batch, time) slice count, and ``out_t``, the convolution over the
    time a window leaves. A subclass sets ``kt``, ``num_blocks`` and
    ``hidden_size`` and calls :meth:`_set_window`; :meth:`union_source`
    says which graph its unions copy."""

    # the last graph called without its unions, and the unions built for
    # it by copy count
    _union_cache = (None, {})

    def spatial_steps(self, window: int) -> List[int]:
        """The time steps left at each block's spatial step for a window of
        ``window`` steps: each gated convolution takes ``kt − 1``."""
        return [window - (2 * i + 1) * (self.kt - 1)
                for i in range(self.num_blocks)]

    def union_source(self, graph: Graph) -> Graph:
        return graph

    def build_union(self, graph: Graph, copies: int,
                    structure: Optional[bool] = None) -> Graph:
        """The union of ``copies`` copies of :meth:`union_source`'s graph,
        with the kernels' structure (``prepare_spmm``) when ``structure``
        is set, by default on the card."""
        union = block_union(self.union_source(graph), copies)
        if structure or (structure is None and graph.device.type == "cuda"):
            union = prepare_spmm(union)
        return union

    def prepare_unions(self, graph: Graph, batch_size: int, window: int,
                       structure: Optional[bool] = None) -> Graph:
        """``graph`` with the unions that batches of ``batch_size`` windows
        of ``window`` steps take, one a spatial step's slice count, in
        ``extras["slice_unions"]``."""
        counts = sorted({batch_size * t for t in self.spatial_steps(window)})
        unions = tuple(self.build_union(graph, c, structure) for c in counts)
        return graph.replace(extras={**(graph.extras or {}),
                                     "slice_unions": unions})

    def slice_union(self, graph: Graph, copies: int) -> Graph:
        """The union of ``copies`` copies: ``graph``'s own from
        ``extras["slice_unions"]``, else the one this model built for
        ``graph`` before, else a new one, kept for the next call on
        ``graph`` (a call on another graph drops it)."""
        for union in (graph.extras or {}).get("slice_unions", ()):
            if union.meta_get("copies") == copies:
                return union
        if self._union_cache[0] is not graph:
            self._union_cache = (graph, {})
        unions = self._union_cache[1]
        if copies not in unions:
            unions[copies] = self.build_union(graph, copies)
        return unions[copies]

    def _set_window(self, window: int):
        """``out_t`` for windows of ``window`` steps: a convolution over
        the steps the blocks leave."""
        self.window = window
        left = window - 2 * self.num_blocks * (self.kt - 1)
        if left < 1:
            raise ValueError(f"a window of {window} steps leaves no step "
                             f"after {self.num_blocks} blocks of kt={self.kt}")
        self.out_t = nn.Conv2d(self.hidden_size, self.hidden_size, (left, 1))

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        _lecun_conv_(self.out_t, generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         window: Optional[int] = None):
        """Every parameter anew; with ``window``, ``out_t`` resized first
        for windows of that many steps (flax sizes it from the input)."""
        if window is not None and window != self.window:
            self._set_window(window)
        reset_parameters(self, generator)

    def _check_window(self, graph: Graph, x: torch.Tensor):
        if x.shape[2] != graph.n_pad:
            raise ValueError(f"the window has {x.shape[2]} node rows and the "
                             f"graph {graph.n_pad}: pad the series to n_pad")


class STConvBlock(nn.Module):
    def __init__(self, in_channels: int, spatial_channels: int,
                 out_channels: int, kt: int = 3):
        super().__init__()
        self.t1 = TemporalGatedConv(in_channels, out_channels, kt)
        self.theta = CDense(out_channels, spatial_channels, bias=False)
        self.t2 = TemporalGatedConv(spatial_channels, out_channels, kt)
        self.ln = nn.LayerNorm(out_channels, eps=1e-6)   # flax's epsilon

    def forward(self, union_of, x: torch.Tensor) -> torch.Tensor:
        """``union_of(copies)`` gives the normalised road graph's union
        for ``copies`` slices."""
        x = self.t1(x)
        B, T, N, _ = x.shape
        h = self.theta(x)
        h = spmm(union_of(B * T), h.reshape(B * T * N, -1))
        x = F.relu(h.view(B, T, N, -1))
        return self.ln(self.t2(x))


class STGCN(TrafficModel):
    adj_norm = "sym"
    calls_spmm = True

    def __init__(self, in_features: int, out_features: int = 1,
                 hidden_size: int = 64, spatial_channels: int = 16,
                 num_blocks: int = 2, kt: int = 3, window: int = 12):
        super().__init__()
        self.kt = kt
        self.num_blocks = num_blocks
        self.hidden_size = hidden_size
        for i in range(num_blocks):
            self.add_module(f"block{i}", STConvBlock(
                in_features if i == 0 else hidden_size, spatial_channels,
                hidden_size, kt))
        self._set_window(window)
        self.out = CDense(hidden_size, out_features)

    def union_source(self, graph: Graph) -> Graph:
        return sym_norm(graph)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: ``[B, T, n_pad, C_in]`` (``graph.extras["window"]`` when
        None). Returns ``[B, n_pad, out_features]``."""
        if x is None:
            x = graph.extras["window"]
        self._check_window(graph, x)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(
                lambda copies: self.slice_union(graph, copies), x)
        x = F.relu(_time_conv(self.out_t, x))
        return self.out(x).squeeze(1)
