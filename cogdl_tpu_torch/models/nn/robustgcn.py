"""RobustGCN — the port of ``cogdl_tpu/models/nn/robustgcn.py``: each layer
``layer{i}`` carries a (mean, variance) pair, gated by ``exp(-var)``, the
mean propagated over ``D^-1/2 (A+I) D^-1/2`` and the variance over
``D^-1 (A+I) D^-1`` (K1 on the card, both), sampled ``mean + ε·√var`` in
training and the mean in evaluation.

``adj_norm = None``: the model derives both normalisations from the
binary self-loop graph itself, two reweighted views a forward
(``Graph.with_edge_weight``), each of which hands K1 its own weights over
the one structure the wrapper built."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...layers.utils import CDense, dropout, reset_parameters
from ...ops import spmm


def dual_norm_weights(graph: Graph):
    """The edge weights of both propagation matrices from the binary
    adjacency (the wrapper's self loops included): ``w0 = D^-1/2 A
    D^-1/2`` and ``w1 = D^-1 A D^-1``, zero on pad edges."""
    w = graph.edge_mask().float()
    deg = w.new_zeros(graph.n_pad).index_add_(0, graph.row, w)
    d0 = torch.rsqrt(deg.clamp_min(1.0))
    d1 = 1.0 / deg.clamp_min(1.0)
    r, c = graph.row, graph.col
    return w * d0[r] * d0[c], w * d1[r] * d1[c]


class RobustGCNConv(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 initial: bool = False, dropout: float = 0.0):
        super().__init__()
        self.initial = initial
        self.dropout = dropout
        self.mean_conv = CDense(in_features, out_features)
        if not initial:
            self.var_conv = CDense(in_features, out_features)

    def forward(self, g0: Graph, g1: Graph, mean: torch.Tensor,
                var: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        mean = self.mean_conv(mean)
        var = mean if self.initial else self.var_conv(var)
        mean = F.elu(mean)
        var = torch.relu(var)
        attention = torch.exp(-var)
        mean = spmm(g0, mean * attention)
        var = spmm(g1, var * attention * attention)
        if self.dropout > 0:
            mean = F.elu(mean)
            var = torch.relu(var)
            if training:
                mean = dropout(mean, self.dropout, generator)
                var = dropout(var, self.dropout, generator)
        return mean, var


class RobustGCN(nn.Module):
    adj_norm = None
    calls_spmm = True

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.5):
        super().__init__()
        self.num_layers = num_layers
        width = in_features
        for i in range(num_layers):
            last = i == num_layers - 1
            out = out_features if last else hidden_size
            self.add_module(f"layer{i}", RobustGCNConv(
                width, out, initial=(i == 0),
                dropout=0.0 if last else dropout))
            width = out

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        w0, w1 = dual_norm_weights(graph)
        g0 = graph.with_edge_weight(w0).with_meta(norm="robust0")
        g1 = graph.with_edge_weight(w1).with_meta(norm="robust1")
        mean, var = x, x
        for i in range(self.num_layers):
            mean, var = getattr(self, f"layer{i}")(g0, g1, mean, var,
                                                   training, generator)
        if training:
            eps = torch.randn(var.shape, generator=generator,
                              device=var.device)
            # +1e-8: d√v/dv is infinite at v = 0, and relu'd variances are 0
            return mean + eps * torch.sqrt(var.clamp_min(0.0) + 1e-8)
        return mean
