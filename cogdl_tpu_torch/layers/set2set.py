"""Set2Set global pooling — the port of ``cogdl_tpu/layers/set2set.py``
("Order Matters: Sequence to sequence for sets", arXiv:1511.06391):
``processing_steps`` rounds of an LSTM query, a softmax over each graph's
nodes of ``x·q`` and the attention-weighted sum, read out as ``[q, r]``.

The LSTM cell is written out as the JAX layer writes it, no ``nn.LSTM``:
packed ``w_ih_l<k> [in, 4F]``, ``w_hh_l<k> [F, 4F]`` and ``b_l<k> [4F]``
with the gates in (i, f, g, o) order, so ``load_jax_params`` maps the
parameters one to one. The softmax is the segment softmax over
``graph_id``, the readout a segment sum."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops import segment as seg


class Set2Set(nn.Module):
    """Returns a ``[num_graphs, 2 · in_features]`` readout of ``x [N, F]``
    grouped by ``graph_id [N]``."""

    def __init__(self, in_features: int, processing_steps: int = 6,
                 num_layers: int = 1):
        super().__init__()
        f = in_features
        self.in_features = f
        self.processing_steps = processing_steps
        self.num_layers = num_layers
        for layer in range(num_layers):
            in_dim = 2 * f if layer == 0 else f
            self.register_parameter(f"w_ih_l{layer}",
                                    nn.Parameter(torch.empty(in_dim, 4 * f)))
            self.register_parameter(f"w_hh_l{layer}",
                                    nn.Parameter(torch.empty(f, 4 * f)))
            self.register_parameter(f"b_l{layer}",
                                    nn.Parameter(torch.zeros(4 * f)))
        self.reset_own_parameters()

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """flax's initialisers: ``w_ih`` LeCun-normal (truncated at two
        standard deviations), ``w_hh`` orthogonal, the bias zeros."""
        with torch.no_grad():
            for layer in range(self.num_layers):
                w_ih = getattr(self, f"w_ih_l{layer}")
                std = math.sqrt(1.0 / w_ih.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(w_ih, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                nn.init.orthogonal_(getattr(self, f"w_hh_l{layer}"),
                                    generator=generator)
                getattr(self, f"b_l{layer}").zero_()

    def forward(self, x: torch.Tensor, graph_id: torch.Tensor,
                num_graphs: int) -> torch.Tensor:
        f, b = self.in_features, num_graphs
        h = [x.new_zeros(b, f) for _ in range(self.num_layers)]
        c = [x.new_zeros(b, f) for _ in range(self.num_layers)]
        q_star = x.new_zeros(b, 2 * f)
        gid = graph_id.long()
        for _ in range(self.processing_steps):
            inp = q_star
            for layer in range(self.num_layers):
                gates = (inp @ getattr(self, f"w_ih_l{layer}")
                         + h[layer] @ getattr(self, f"w_hh_l{layer}")
                         + getattr(self, f"b_l{layer}"))
                gi, gf, gg, go = gates.chunk(4, dim=-1)
                c[layer] = (torch.sigmoid(gf) * c[layer]
                            + torch.sigmoid(gi) * torch.tanh(gg))
                h[layer] = torch.sigmoid(go) * torch.tanh(c[layer])
                inp = h[layer]
            q = h[-1]
            e = (x * q.index_select(0, gid)).sum(-1)
            a = seg.segment_softmax(e, gid, b)
            r = seg.segment_sum(a[:, None] * x, gid, b)
            q_star = torch.cat([q, r], -1)
        return q_star
