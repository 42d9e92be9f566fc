"""SGC — the port of ``cogdl_tpu/models/nn/sgc.py``: ``order`` steps of the
symmetric-normalised adjacency (K1 on the card), then one linear map
``sgc/W``.

``adj_norm = "sym"`` is a class attribute: the JAX model normalises inside
its forward and declares no ``adj_norm``, so the JAX wrapper leaves the
graph unnormalised (and on a TPU its kernel reads the weights prepared
before that norm). Here the wrapper normalises before it builds the
kernels' structure, and the model's own ``sym_norm`` is a no-op by the
graph's ``norm`` tag; the result is what the JAX model computes."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import SGCLayer
from ...layers.utils import reset_parameters


class SGC(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int, order: int = 2):
        super().__init__()
        self.sgc = SGCLayer(in_features, out_features, order=order)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        return self.sgc(sym_norm(graph), x, training)
