"""AutoGNN — the port of ``cogdl_tpu/models/nn/autognn.py``: the AutoML
search space's meta-model, a ``backbone`` of the chosen ``conv_type`` (GCN,
GAT with ``hidden_size // 8`` (at least 4) a head, or GraphSAGE), and
``AUTOGNN_SEARCH_SPACE``.

``adj_norm`` is the backbone's: ``"sym"`` for a GCN backbone (which the JAX
model normalises inside its forward, as here), None otherwise."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph
from .gat import GAT
from .gcn import GCN
from .graphsage import GraphSAGE

BACKBONES = {"gcn": GCN, "gat": GAT, "sage": GraphSAGE,
             "graphsage": GraphSAGE}


class AutoGNN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 conv_type: str = "gcn", hidden_size: int = 64,
                 num_layers: int = 2, dropout: float = 0.5):
        super().__init__()
        kw = dict(in_features=in_features, out_features=out_features,
                  num_layers=num_layers, dropout=dropout)
        kw["hidden_size"] = (max(hidden_size // 8, 4) if conv_type == "gat"
                             else hidden_size)
        self.conv_type = conv_type
        self.backbone = BACKBONES[conv_type](**kw)

    @property
    def adj_norm(self) -> Optional[str]:
        return getattr(self.backbone, "adj_norm", None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.backbone.reset_parameters(generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.backbone(graph, x, training, generator)


AUTOGNN_SEARCH_SPACE = {
    "conv_type": ("categorical", ["gcn", "gat", "sage"]),
    "hidden_size": ("categorical", [32, 64, 128]),
    "num_layers": ("int", 2, 3),
    "dropout": ("uniform", 0.2, 0.7),
    "lr": ("loguniform", 1e-3, 1e-1),
}
