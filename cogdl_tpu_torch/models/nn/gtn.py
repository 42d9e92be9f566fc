"""GTN — graph transformer network — the port of
``cogdl_tpu/models/nn/gtn.py`` (reference cogdl/models/nn/gtn.py).

Each of ``num_channels`` channels learns a soft metapath: ``num_gt_layers``
convex mixtures of the relation adjacencies, applied in turn to the
features, ``h ← Σ_r a_r · A_r h`` with ``a = softmax(alpha_c{c}_l{l})``.
The products ``A_r h`` are K1 on the card over each relation graph's
structure (the wrapper's ``prepare_graph``), at the input width in the
first layer. Then ``fc1``, relu, dropout and ``out``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph
from ...layers.utils import CDense, dropout, reset_parameters
from ...ops import spmm
from .han import _metapath_graphs


class GTN(nn.Module):
    # spmm over the relation graphs: the wrapper builds their K1 structure
    calls_spmm = True

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_channels: int = 2,
                 num_gt_layers: int = 2, dropout: float = 0.5):
        """The mixtures start over two relation graphs; the wrapper sizes
        them to the graph's (:meth:`fit_graph`)."""
        super().__init__()
        self.num_channels = num_channels
        self.num_gt_layers = num_gt_layers
        self.dropout = dropout
        self._build_alphas(2)
        self.fc1 = CDense(in_features * num_channels, hidden_size)
        self.out = CDense(hidden_size, out_features)

    def _build_alphas(self, num_relations: int):
        self.num_relations = num_relations
        for c in range(self.num_channels):
            for l in range(self.num_gt_layers):
                self.register_parameter(f"alpha_c{c}_l{l}", nn.Parameter(
                    torch.full((num_relations,), 1.0 / num_relations)))

    def fit_graph(self, graph: Graph) -> None:
        """Resize the mixtures to the graph's count of relation graphs
        (flax sizes them at the first call); the wrapper calls it before
        initialising the parameters."""
        r = len(graph.extras["relation_graphs"])
        if r != self.num_relations:
            self._build_alphas(r)

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for c in range(self.num_channels):
                for l in range(self.num_gt_layers):
                    getattr(self, f"alpha_c{c}_l{l}").fill_(
                        1.0 / self.num_relations)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graphs, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gs, x0 = _metapath_graphs(graphs, "relation_graphs")
        if x is None:
            x = x0
        outs = []
        for c in range(self.num_channels):
            h = x
            for l in range(self.num_gt_layers):
                a = torch.softmax(getattr(self, f"alpha_c{c}_l{l}"), dim=0)
                # the soft relation mixture, applied to h
                h = sum(a[r] * spmm(g, h) for r, g in enumerate(gs))
            outs.append(h)
        z = torch.relu(self.fc1(torch.cat(outs, dim=-1)))
        if self.dropout > 0 and training:
            z = dropout(z, self.dropout, generator)
        return self.out(z)
