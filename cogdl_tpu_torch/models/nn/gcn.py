"""GCN (Kipf & Welling) — the port of ``cogdl_tpu/models/nn/gcn.py``.

Forward contract: ``model(graph, x=None, training=False, generator=None)
-> logits[n_pad, C]``. Normalisation (sym by default) is applied inside the
model and is free when the graph is already tagged as normalised.
Submodules are named ``layer{i}`` with a ``linear`` inside, as the flax
parameter tree is, so ``models.load_jax_params`` maps one onto the other.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, row_norm, sym_norm
from ...layers import GCNLayer
from ...layers.utils import dropout, reset_parameters


class GCN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.5, activation: str = "relu",
                 norm: Optional[str] = None, residual: bool = False,
                 adj_norm: str = "sym", use_prop_cache: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.residual = residual
        self.adj_norm = adj_norm
        # consume extras["prop_x"/"prop_s"] (ops.cache_propagation) for the
        # first layer when exact: its input is graph.x and no dropout touches
        # it. Removes that layer's SpMM from forward and backward.
        self.use_prop_cache = use_prop_cache
        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"layer{i}", GCNLayer(
                width, hidden_size, dropout=dropout, activation=activation,
                residual=residual, norm=norm))
            width = hidden_size
        self.add_module(f"layer{num_layers - 1}",
                        GCNLayer(width, out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-initialise every layer from ``generator`` (in module order)."""
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                return_hidden: bool = False) -> torch.Tensor:
        prop = None
        if (self.use_prop_cache and (x is None or x is graph.x)
                and not self.residual
                and graph.extras and "prop_x" in graph.extras
                and not (self.dropout > 0 and training)):
            prop = (graph.extras["prop_x"], graph.extras["prop_s"])
        if x is None:
            x = graph.x
        if self.adj_norm == "sym":
            graph = sym_norm(graph)
        elif self.adj_norm == "row":
            graph = row_norm(graph)
        if self.dropout > 0 and training:
            x = dropout(x, self.dropout, generator)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"layer{i}")(
                graph, x, training, prop=prop if i == 0 else None,
                generator=generator)
        if return_hidden:
            return x
        return getattr(self, f"layer{self.num_layers - 1}")(
            graph, x, training, prop=prop if self.num_layers == 1 else None,
            generator=generator)

    def embed(self, graph: Graph, x: Optional[torch.Tensor] = None):
        """Penultimate-layer embeddings."""
        return self(graph, x, False, return_hidden=True)
