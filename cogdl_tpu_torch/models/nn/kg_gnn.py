"""GNN knowledge-graph link prediction — the port of
``cogdl_tpu/models/nn/kg_gnn.py``: the encoder-and-scorer pair behind the
``kg_link_prediction`` wrapper.

  * ``DistMult``: ``score(s, r, o) = Σ_d s_d·r_d·o_d``;
  * ``ConvE``: ``[s; r]`` interleaved into a ``[2·k_w, k_h]`` grid,
    normalised, convolved, projected back to the embedding width and dotted
    with the object. The JAX scorer is channels-last (flax ``Conv``); this
    one keeps that layout around a torch ``Conv2d`` (the grid moves to
    channels-first for the convolution and back), so its three norms
    reduce over the same axes: ``norm="layer"`` LayerNorms over the last
    axis (``ln0``'s has one channel, so it returns its bias, as in the JAX
    scorer), ``norm="batch"`` BatchNorms at their stored statistics;
  * ``KGLinkPredictor``: entity embeddings → a relational GNN encoder
    (RGCN, CompGCN) over the whole training graph → the scorer.

No kernel of ours runs here: RGCN and CompGCN aggregate with index ops over
the typed graph.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ...data.graph import Graph
from ...layers.utils import (
    CDense,
    MaskedBatchNorm,
    dropout,
    glorot_uniform_,
    reset_parameters,
)
from .patchy_san import _lecun_normal_


class DistMult(nn.Module):
    """``score(s, r, o) = Σ_d s_d·r_d·o_d``; against every entity ``(s·r)
    @ objᵀ``."""

    def forward(self, sub, rel, obj, training: bool = False,
                all_entities: bool = False,
                generator: Optional[torch.Generator] = None):
        if all_entities:
            return (sub * rel) @ obj.T
        return (sub * rel * obj).sum(-1)


class ConvE(nn.Module):
    """The ConvE scorer; parameters ``ln0``, ``conv``, ``ln1``, ``fc``,
    ``ln2`` and ``bias`` as the flax tree names them. The kernel is clamped
    to the grid, ``max(min(kernel_size, k_h, 2·k_w), 1)``."""

    def __init__(self, dim: int, num_filter: int = 20, kernel_size: int = 7,
                 k_w: int = 10, dropout: float = 0.3, norm: str = "layer"):
        super().__init__()
        if dim % k_w:
            raise ValueError(f"ConvE: dim {dim} is not a multiple of k_w "
                             f"{k_w}")
        if norm not in ("layer", "batch"):
            raise ValueError(f"unknown norm {norm!r}: layer | batch")
        self.dim, self.k_w, self.k_h = dim, k_w, dim // k_w
        self.dropout = dropout
        self.norm = norm
        ks = max(min(kernel_size, self.k_h, 2 * k_w), 1)
        self.ln0, self.ln1, self.ln2 = (self._norm(c)
                                        for c in (1, num_filter, dim))
        self.conv = nn.Conv2d(1, num_filter, ks)
        flat = (2 * k_w - ks + 1) * (self.k_h - ks + 1) * num_filter
        self.fc = CDense(flat, dim)
        self.bias = nn.Parameter(torch.zeros(dim))

    def _norm(self, width: int) -> nn.Module:
        if self.norm == "batch":
            return MaskedBatchNorm(width)
        return nn.LayerNorm(width, eps=1e-6)   # flax's epsilon

    def _apply_norm(self, m: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.norm == "batch":
            return m(x, use_running_average=True)
        # flax's LayerNorm: var = E[x²] − E[x]², and x − E[x] exactly 0 over
        # one channel (ln0), where torch's kernel leaves rounding that
        # 1/sqrt(eps) scales up
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * torch.rsqrt(var + m.eps) * m.weight + m.bias

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """The convolution as flax initialises it (LeCun normal over ``ks²``
        inputs, zero bias) and the zero output bias."""
        _lecun_normal_(self.conv.weight, math.prod(self.conv.kernel_size),
                       generator)
        with torch.no_grad():
            self.conv.bias.zero_()
            self.bias.zero_()

    def forward(self, sub, rel, obj, training: bool = False,
                all_entities: bool = False,
                generator: Optional[torch.Generator] = None):
        b = sub.shape[0]
        # [B, dim, 2] read row-major into the channels-last grid
        h = torch.stack([sub, rel], 2).reshape(b, 2 * self.k_w, self.k_h, 1)
        h = self._apply_norm(self.ln0, h)
        h = self.conv(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h = torch.relu(self._apply_norm(self.ln1, h))
        if training and self.dropout > 0:
            h = dropout(h, self.dropout, generator)
        h = self.fc(h.reshape(b, -1))
        h = torch.relu(self._apply_norm(self.ln2, h))
        if all_entities:
            return h @ obj.T                  # the JAX scorer: no bias here
        return (h * obj + self.bias).sum(-1)


class KGLinkPredictor(nn.Module):
    """Entity embeddings ``ent`` (row ``i`` of the graph reads entity
    ``min(i, num_entities − 1)``, pad rows included) → ``encoder(graph, x,
    training)`` → ``scorer``. An encoder that returns ``(z, rel)``
    (CompGCN with ``return_rel=True``) scores with its own relation
    embeddings; otherwise with the learned table ``rel_w`` ``[num_relations,
    hidden_size]``. ``num_relations`` counts every relation id on the
    graph, the inverses and the self loop included."""

    def __init__(self, encoder: nn.Module, num_entities: int,
                 num_relations: int, hidden_size: int,
                 score_func: str = "distmult"):
        super().__init__()
        self.num_entities = num_entities
        self.encoder = encoder
        self.ent = nn.Embedding(num_entities, hidden_size)
        self.rel_w = nn.Parameter(torch.empty(num_relations, hidden_size))
        if score_func == "conve":
            self.scorer = ConvE(hidden_size)
        elif score_func == "distmult":
            self.scorer = DistMult()
        else:
            raise NotImplementedError(
                f"score_func {score_func!r} (distmult | conve)")

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """``ent`` as flax ``nn.Embed`` (normal, variance 1 /
        ``hidden_size``), ``rel_w`` Glorot uniform."""
        w = self.ent.weight
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=generator)
                    / w.shape[1] ** 0.5)
        glorot_uniform_(self.rel_w, generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def encode(self, graph: Graph, training: bool = False,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(entity embeddings [n_pad, d], relation embeddings [R, d])``."""
        ids = torch.arange(graph.n_pad, device=graph.device).clamp_max(
            self.num_entities - 1)
        z = self.encoder(graph, self.ent(ids), training=training,
                         generator=generator)
        if isinstance(z, tuple):
            return z
        return z, self.rel_w

    def forward(self, graph: Graph, training: bool = False,
                generator: Optional[torch.Generator] = None):
        return self.encode(graph, training, generator)

    def loss_logits(self, graph: Graph, h, r, t, training: bool = False,
                    generator: Optional[torch.Generator] = None):
        """Encode once and score the triples ``(h[i], r[i], t[i])``; with the
        embeddings' L2 penalty ``mean(z²) + mean(rel²)`` over the real
        entities."""
        z, rel = self.encode(graph, training, generator)
        logits = self.scorer(z.index_select(0, h), rel.index_select(0, r),
                             z.index_select(0, t), training=training,
                             generator=generator)
        reg = (z[: self.num_entities] ** 2).mean() + (rel ** 2).mean()
        return logits, reg

    def rank_scores(self, graph: Graph, h, r) -> torch.Tensor:
        """Encode and score ``(h[i], r[i], ·)`` against every row of the
        graph → ``[B, n_pad]``."""
        z, rel = self.encode(graph, False)
        return self.scorer(z.index_select(0, h), rel.index_select(0, r), z,
                           training=False, all_entities=True)
