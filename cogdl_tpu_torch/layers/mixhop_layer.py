"""MixHop layer: the concatenation of one dense map ``W{p}`` of each
adjacency power ``Â^p x`` — the port of ``cogdl_tpu/layers/mixhop_layer.py``.
The powers are taken by ``ops.spmm`` (K1 on the card) at the input's
width, up to the largest one asked for."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..data.graph import Graph
from ..ops import spmm
from .utils import CDense


class MixHopLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 powers: Sequence[int] = (0, 1, 2)):
        super().__init__()
        self.powers = tuple(powers)
        self.calls_spmm = max(self.powers) > 0
        for p in self.powers:
            self.add_module(f"W{p}", CDense(in_features, out_features))

    def forward(self, graph: Graph, x: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        per_power = [x]
        for _ in range(max(self.powers)):
            per_power.append(spmm(graph, per_power[-1]))
        return torch.cat([getattr(self, f"W{p}")(per_power[p])
                          for p in self.powers], dim=-1)
