"""CompGCN — composition-based relational GCN — the port of
``cogdl_tpu/models/nn/compgcn.py`` (reference cogdl/models/nn/compgcn.py).

Each layer composes a source's features with its edge's relation embedding
(``sub``: ``x_src − rel``, or ``mult``: ``x_src · rel``), takes the mean
over each destination's weighted in-degree, and transforms the aggregate
(``W_nbr``), the node's own features (``W_self``) and the relation
embeddings (``W_rel``). No kernel of ours runs here: the messages are
``[e_pad, F_in]`` tensors over the typed union graph, gathered with
``index_select``, as the JAX package forms them. ``num_entities`` and
``return_rel`` serve KG link prediction, whose wrapper is not ported yet."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph
from ...layers.utils import CDense, dropout, glorot_uniform_, reset_parameters
from ...ops import segment as seg

COMPOSITIONS = ("sub", "mult")


class CompGCNLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 comp: str = "sub"):
        super().__init__()
        if comp not in COMPOSITIONS:
            raise ValueError(f"unknown comp {comp!r}: {COMPOSITIONS}")
        self.comp = comp
        self.W_nbr = CDense(in_features, out_features, bias=False)
        self.W_self = CDense(in_features, out_features, bias=False)
        self.W_rel = CDense(in_features, out_features, bias=False)

    def forward(self, graph: Graph, x: torch.Tensor, rel: torch.Tensor):
        """``(out [n_pad, F_out], rel_out [R, F_out])``."""
        if graph.edge_type is None:
            raise ValueError("CompGCN needs graph.edge_type")
        src = seg.gather(x, graph.col)
        r = rel.index_select(0, graph.edge_type)
        msg = src - r if self.comp == "sub" else src * r
        msg = msg * graph.edge_weight[:, None]
        agg = seg.segment_sum(msg, graph.row, graph.n_pad)
        agg = agg / graph.in_degrees(weighted=True)[:, None].clamp_min(1.0)
        out = self.W_nbr(agg) + self.W_self(x)
        return out, self.W_rel(rel)


class CompGCN(nn.Module):
    """``rel`` ``[num_relations, F_in]``, ``layer{i}`` CompGCN layers with
    tanh and dropout between them. With ``num_entities`` above 0 the model
    learns entity embeddings: called without ``x``, its input is the
    ``ent`` embedding of ``arange(n_pad) % num_entities`` (flax
    ``nn.Embed``), so ``F_in`` is ``hidden_size``."""

    def __init__(self, in_features: int, out_features: int,
                 num_relations: int = 4, num_entities: int = 0,
                 hidden_size: int = 64, num_layers: int = 2,
                 dropout: float = 0.1, return_rel: bool = False):
        super().__init__()
        self.num_entities = num_entities
        self.num_layers = num_layers
        self.dropout = dropout
        self.return_rel = return_rel
        if num_entities:
            self.ent = nn.Embedding(num_entities, hidden_size)
        width = hidden_size if num_entities else in_features
        self.rel = nn.Parameter(torch.empty(num_relations, width))
        for i in range(num_layers - 1):
            self.add_module(f"layer{i}", CompGCNLayer(width, hidden_size))
            width = hidden_size
        self.add_module(f"layer{num_layers - 1}",
                        CompGCNLayer(width, out_features))

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """``rel`` Glorot uniform; ``ent`` as flax ``nn.Embed``: normal with
        variance 1 / ``hidden_size``."""
        glorot_uniform_(self.rel, generator)
        if self.num_entities:
            w = self.ent.weight
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=generator)
                        / w.shape[1] ** 0.5)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        if x is None and self.num_entities:
            idx = torch.arange(graph.n_pad, device=graph.device) % \
                self.num_entities
            x = self.ent(idx)
        elif x is None:
            x = graph.x
        rel = self.rel
        for i in range(self.num_layers - 1):
            x, rel = getattr(self, f"layer{i}")(graph, x, rel)
            x = torch.tanh(x)
            if self.dropout > 0 and training:
                x = dropout(x, self.dropout, generator)
        x, rel = getattr(self, f"layer{self.num_layers - 1}")(graph, x, rel)
        if self.return_rel:
            return x, rel
        return x
