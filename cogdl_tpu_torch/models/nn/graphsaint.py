"""GraphSAINT — the port of ``cogdl_tpu/models/nn/graphsaint.py``.

``architecture`` (such as ``"1-1-0"``) gives each layer's propagation
order; each layer is a :class:`~cogdl_tpu_torch.layers.SAINTLayer`, and the
last layer's output is L2-normalised, ``x·rsqrt(Σx² + 1e-12)``, before the
linear ``classifier``. The model applies the symmetric normalisation when
``adj_norm == "sym"`` (free on a graph already tagged). The unbiased
estimator (``norm_loss``, ``norm_aggr``) is the ``graphsaint`` wrapper's
(``wrappers/sampled_node_classification.py``). Submodules are named
``layer{i}`` and ``classifier`` as the flax parameter tree is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import SAINTLayer
from ...layers.utils import CDense


class GraphSAINT(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 128, architecture: str = "1-1-0",
                 aggr: str = "concat", act: str = "relu", bias: str = "norm",
                 dropout: float = 0.1, adj_norm: str = "sym"):
        super().__init__()
        self.adj_norm = adj_norm
        self.orders = [int(o) for o in architecture.split("-")]
        width = in_features
        for i, order in enumerate(self.orders):
            layer = SAINTLayer(width, hidden_size, order=order, aggr=aggr,
                               act=act, bias=bias, dropout=dropout)
            self.add_module(f"layer{i}", layer)
            width = layer.out_width
        self.classifier = CDense(width, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-initialise every layer from ``generator`` (in module order)."""
        for m in self.modules():
            if isinstance(m, CDense):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        if self.adj_norm == "sym":
            graph = sym_norm(graph)
        for i in range(len(self.orders)):
            x = getattr(self, f"layer{i}")(graph, x, training, generator)
        x = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
        return self.classifier(x)
