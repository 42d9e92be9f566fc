"""GraphSAGE — the port of ``cogdl_tpu/models/nn/graphsage.py``
(``GraphSAGE``; ``UnsupGraphSAGE`` waits for its wrapper).

Forward contract: ``model(graph, x=None, training=False, generator=None)
-> logits[n_pad, C]``; ``graph`` is a Graph (full batch) or a sequence of
per-hop block Graphs (sampled mini-batch, one block per layer). Submodules
are named ``layer{i}`` as the flax parameter tree is, so
``models.load_jax_params`` maps one onto the other.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph
from ...layers import SAGELayer
from ...layers.utils import CDense


class GraphSAGE(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 aggr: str = "mean", dropout: float = 0.5,
                 normalize: bool = False):
        super().__init__()
        self.num_layers = num_layers
        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"layer{i}", SAGELayer(
                width, hidden_size, aggr=aggr, normalize=normalize,
                dropout=dropout, activation="relu"))
            width = hidden_size
        self.add_module(f"layer{num_layers - 1}",
                        SAGELayer(width, out_features, aggr=aggr))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-initialise every layer from ``generator`` (in module order)."""
        for m in self.modules():
            if isinstance(m, CDense):
                m.reset_parameters(generator)

    def forward(self, graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        blocks = (graph if isinstance(graph, (list, tuple))
                  else [graph] * self.num_layers)
        if x is None:
            x = blocks[0].x
        for i in range(self.num_layers - 1):
            x = getattr(self, f"layer{i}")(blocks[i], x, training, generator)
        return getattr(self, f"layer{self.num_layers - 1}")(
            blocks[-1], x, training, generator)

    def inference(self, graph: Graph,
                  x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Layer-wise full-graph inference: each layer runs over the whole
        graph before the next, O(num_layers · E) instead of O(fanout^L) a
        node."""
        return self(graph, x, training=False)
