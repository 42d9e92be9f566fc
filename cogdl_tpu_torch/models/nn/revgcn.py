"""RevGCN, RevGAT and RevGEN — the port of ``cogdl_tpu/models/nn/revgcn.py``:
``fc_in`` to twice the hidden width, split in halves, ``num_layers``
additive-coupling blocks ``block{i}`` (``y1 = x1 + F(x2)``, ``y2 = x2 +
G(y1)``), the halves joined, ReLU and ``fc_out``. ``F`` and ``G`` are GCN
layers (K1 on the card), GAT layers of ``nhead`` heads (K3) or GENConv
layers (torch index ops, no kernel).

Each block runs under ``torch.utils.checkpoint`` while gradients are
recorded, as the JAX model's blocks run under ``nn.remat``: the backward
recomputes the block's forward, so on the card a train step runs each
block's kernels twice forward. Every draw the block would make — the GCN
layers' dropout masks, the GAT layers' attention-dropout seed (fused route)
or keep mask (unfused) — is made before the checkpointed call and passed
in, so that the recompute drops what the forward dropped and the generator
advances exactly as without checkpointing (``remat = False`` on an
instance).

``adj_norm = "sym"`` is a class attribute, as in ``models/nn/sgc.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...data.graph import Graph, sym_norm
from ...layers import GATLayer, GCNLayer, GENConv
from ...layers.utils import CDense, dropout_keep, reset_parameters


class RevBlock(nn.Module):
    def __init__(self, features: int, dropout: float = 0.0,
                 conv: str = "gcn", nhead: int = 2):
        super().__init__()
        self.conv = conv
        self.dropout = dropout
        for name in ("F", "G"):
            if conv == "gat":
                if features % nhead:
                    raise ValueError(f"RevGAT: {nhead} heads do not divide "
                                     f"the width {features}")
                layer = GATLayer(features, features // nhead, nhead=nhead,
                                 attn_drop=dropout, activation="relu")
            elif conv == "gen":
                layer = GENConv(features, features)
            elif conv == "gcn":
                layer = GCNLayer(features, features, activation="relu",
                                 dropout=dropout)
            else:
                raise ValueError(f"unknown conv {conv!r}: gcn | gat | gen")
            self.add_module(name, layer)

    def draw(self, graph: Graph, x: torch.Tensor, training: bool,
             generator: Optional[torch.Generator]):
        """The draws of ``F`` then ``G`` for one forward over ``x``'s rows,
        in the order the forward would make them (None where none)."""
        out = []
        for layer in (self.F, self.G):
            if self.conv == "gat":
                out.append(layer.draw_attn_drop(graph, x.device, generator,
                                                training))
            elif self.conv == "gcn" and training and self.dropout > 0:
                out.append(dropout_keep(x.shape, self.dropout, x.device,
                                        generator))
            else:
                out.append(None)
        return tuple(out)

    def _layer(self, layer, graph, x, training, generator, rand):
        if self.conv == "gat":
            return layer(graph, x, training, generator, attn_rand=rand)
        if self.conv == "gcn":
            return layer(graph, x, training, generator=generator, keep=rand)
        return layer(graph, x, training, generator)

    def forward(self, graph: Graph, x1: torch.Tensor, x2: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                rand=(None, None)):
        y1 = x1 + self._layer(self.F, graph, x2, training, generator, rand[0])
        y2 = x2 + self._layer(self.G, graph, y1, training, generator, rand[1])
        return y1, y2


class RevGCN(nn.Module):
    adj_norm = "sym"
    conv = "gcn"
    # the JAX blocks always run under nn.remat; a test turns it off on an
    # instance to hold the checkpointed blocks against the plain ones
    remat = True

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 8,
                 dropout: float = 0.1, group: int = 2,
                 conv: Optional[str] = None, nhead: int = 2):
        super().__init__()
        self.num_layers = num_layers
        self.conv = conv or type(self).conv
        self.fc_in = CDense(in_features, hidden_size * 2)
        for i in range(num_layers):
            self.add_module(f"block{i}", RevBlock(
                hidden_size, dropout=dropout, conv=self.conv, nhead=nhead))
        self.fc_out = CDense(hidden_size * 2, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        g = sym_norm(graph)
        x1, x2 = self.fc_in(x).chunk(2, dim=-1)
        for i in range(self.num_layers):
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                rand = block.draw(g, x2, training, generator)
                x1, x2 = checkpoint(block, g, x1, x2, training, None, rand,
                                    use_reentrant=False)
            else:
                x1, x2 = block(g, x1, x2, training, generator)
        return self.fc_out(torch.relu(torch.cat([x1, x2], -1)))


class RevGAT(RevGCN):
    """Reversible GAT: the blocks' layers are GAT layers of ``nhead`` heads
    of ``hidden_size // nhead`` (K3 on the card)."""
    conv = "gat"


class RevGEN(RevGCN):
    """Reversible DeeperGCN: the blocks' layers are GENConv layers (no
    kernel)."""
    conv = "gen"
