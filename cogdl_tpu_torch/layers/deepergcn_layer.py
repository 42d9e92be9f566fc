"""DeeperGCN building blocks — the port of
``cogdl_tpu/layers/deepergcn_layer.py``: ``GENConv`` (softmax / power-mean
/ mean / max aggregation) and the pre-activation residual block
``ResGNNLayer``.

The JAX package computes GENConv outside any Pallas kernel, with segment
ops over the edges; the port does the same with torch index ops
(``ops.segment``) on every device, so no kernel of ``ops/cuda`` runs here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.graph import Graph
from ..ops import segment as seg
from .mlp import MLP
from .utils import MaskedBatchNorm, dropout

AGGREGATORS = ("softmax", "softmax_sg", "powermean", "mean", "max")


class GENConv(nn.Module):
    """Generalised aggregation conv: ``relu(x_src) + eps`` messages in the
    input space, one of :data:`AGGREGATORS` (``softmax_sg`` stops the
    gradient through the aggregation weights, as the DeeperGCN paper's
    SoftMax_Sg), an optional message norm with a scale ``s`` and an
    optional residual, then the two-layer update MLP ``mlp_out`` of hidden
    width ``2·in_features`` (identity activation by default).

    ``beta``, ``p`` and ``s`` are shape-``()`` parameters when learned
    (``learn_beta``, ``learn_p``, ``use_msg_norm`` with
    ``learn_msg_scale``), plain numbers otherwise."""

    def __init__(self, in_features: int, out_features: int,
                 aggr: str = "softmax_sg", beta: float = 1.0, p: float = 1.0,
                 learn_beta: bool = False, learn_p: bool = False,
                 residual: bool = False, use_msg_norm: bool = False,
                 learn_msg_scale: bool = True,
                 activation: Optional[str] = None, eps: float = 1e-7):
        super().__init__()
        if aggr not in AGGREGATORS:
            raise ValueError(
                f"unknown aggr {aggr!r}: {' | '.join(AGGREGATORS)}")
        self.aggr = aggr
        self.beta_init, self.p_init = beta, p
        self.residual = residual
        self.use_msg_norm = use_msg_norm
        self.eps = eps
        if learn_beta and aggr in ("softmax", "softmax_sg"):
            self.beta = nn.Parameter(torch.tensor(float(beta)))
        if learn_p and aggr == "powermean":
            self.p = nn.Parameter(torch.tensor(float(p)))
        if use_msg_norm and learn_msg_scale:
            self.s = nn.Parameter(torch.tensor(1.0))
        self.mlp_out = MLP(in_features, out_features,
                           hidden_features=2 * in_features, num_layers=2,
                           activation=activation)

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """The learned scalars back to their constants: ``beta``, ``p``, and
        ``s`` = 1."""
        with torch.no_grad():
            for name, value in (("beta", self.beta_init), ("p", self.p_init),
                                ("s", 1.0)):
                if isinstance(getattr(self, name, None), nn.Parameter):
                    getattr(self, name).fill_(value)

    def _scalar(self, name: str, default: float):
        value = getattr(self, name, None)
        return value if isinstance(value, nn.Parameter) else default

    def forward(self, graph: Graph, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        msg = torch.relu(seg.gather(x, graph.col)) + self.eps
        mask = graph.edge_mask()[:, None]
        zero = msg.new_zeros(())
        if self.aggr in ("softmax", "softmax_sg"):
            beta = self._scalar("beta", self.beta_init)
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and self.aggr == "softmax"):
                scores = seg.segment_softmax(msg * beta, graph.row,
                                             graph.n_pad,
                                             mask=mask.expand_as(msg))
            out = seg.segment_sum(torch.where(mask, msg * scores, zero),
                                  graph.row, graph.n_pad)
            if isinstance(beta, nn.Parameter) and self.aggr == "softmax_sg":
                # the JAX layer's stop_gradient gives a learned beta a zero
                # gradient, which weight decay then reads; not none
                out = out + 0.0 * beta
        elif self.aggr == "powermean":
            p = self._scalar("p", self.p_init)
            mp = torch.where(mask, msg.clamp(self.eps, 1.0) ** p, zero)
            deg = graph.in_degrees()[:, None]
            out = (seg.segment_sum(mp, graph.row, graph.n_pad)
                   / deg.clamp_min(1.0)) ** (1.0 / p)
        elif self.aggr == "mean":
            out = seg.segment_mean(torch.where(mask, msg, zero), graph.row,
                                   graph.n_pad)
        else:
            out = seg.segment_max(
                torch.where(mask, msg, msg.new_full((), -1e30)), graph.row,
                graph.n_pad)
        if self.use_msg_norm:
            s = self._scalar("s", 1.0)
            unit = out / out.norm(dim=1, keepdim=True).clamp_min(1e-12)
            out = x + s * unit * x.norm(dim=1, keepdim=True)
        if self.residual:
            out = out + x
        return self.mlp_out(out, training, generator)


class ResGNNLayer(nn.Module):
    """Pre-activation residual block ``x + conv(dropout(relu(norm(x))))``.
    ``batchnorm`` is ``MaskedBatchNorm`` over the graph's real nodes;
    DeeperGCN takes ``layernorm`` (flax's, eps 1e-6) under ``remat``.
    ``keep``, a dropout mask drawn before the call, stands in for the
    block's own draw, so that a checkpointed block's recompute drops the
    same elements."""

    def __init__(self, in_features: int, out_features: int,
                 aggr: str = "softmax_sg", dropout: float = 0.0,
                 norm: str = "batchnorm"):
        super().__init__()
        if norm == "layernorm":
            self.norm = nn.LayerNorm(in_features, eps=1e-6)
        elif norm == "batchnorm":
            self.norm = MaskedBatchNorm(in_features)
        else:
            raise ValueError(f"unknown norm {norm!r}: batchnorm | layernorm")
        self.norm_type = norm
        self.dropout = dropout
        self.conv = GENConv(in_features, out_features, aggr=aggr)

    def forward(self, graph: Graph, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_type == "layernorm":
            h = self.norm(x)
        else:
            h = self.norm(x, graph.node_mask(),
                          use_running_average=not training)
        h = torch.relu(h)
        if self.dropout > 0 and training:
            h = dropout(h, self.dropout, generator, keep)
        return x + self.conv(graph, h, training, generator)
