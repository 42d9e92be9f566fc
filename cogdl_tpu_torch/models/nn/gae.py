"""GAE / VGAE, (variational) graph auto-encoders — the port of
``cogdl_tpu/models/nn/gae.py``: a two-layer GCN encoder and an
inner-product decoder; VGAE encodes a mean and a log standard deviation
and adds their KL term.

``adj_norm = "sym"``: the JAX models normalise inside their forward; here
the wrapper normalises the self-loop graph before it builds the kernels'
structure, and the forward's own ``sym_norm`` is then free. Every
propagation is K1 on the card: GAE's at ``hidden_size`` and ``emb_size``,
VGAE's at ``hidden_size`` and twice at ``emb_size``, and the same again in
``kl``, which encodes once more with training off as the JAX model does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import reset_parameters


class GAE(nn.Module):
    adj_norm = "sym"
    has_kl = False

    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 32, emb_size: int = 16):
        super().__init__()
        self.emb_size = emb_size
        self.conv1 = GCNLayer(in_features, hidden_size, activation="relu")
        self.conv2 = GCNLayer(hidden_size, emb_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def encode(self, graph: Graph, x: torch.Tensor, training: bool = False,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        g = sym_norm(graph)
        return self.conv2(g, self.conv1(g, x, training), training)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The embeddings ``[n_pad, emb_size]``. ``eps``: VGAE's noise in
        training, drawn ahead (:meth:`draw_eps`); drawn from ``generator``
        when not given."""
        if x is None:
            x = graph.x
        if training and self.has_kl and eps is None:
            eps = self.draw_eps(graph, generator)
        return self.encode(graph, x, training, eps)

    def draw_eps(self, graph: Graph,
                 generator: Optional[torch.Generator] = None):
        """VGAE's reparameterisation noise, ``[n_pad, emb_size]`` standard
        normal on the graph's device; None for GAE."""
        if not self.has_kl:
            return None
        return torch.randn(graph.n_pad, self.emb_size, generator=generator,
                           device=graph.device)

    @staticmethod
    def decode_edges(z: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
        """Inner-product decoder logits of the pairs ``(rows[i],
        cols[i])``."""
        return (z.index_select(0, rows.long())
                * z.index_select(0, cols.long())).sum(-1)

    def embed(self, graph: Graph,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encode(graph, graph.x if x is None else x, False)


class VGAE(GAE):
    has_kl = True

    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 32, emb_size: int = 16):
        nn.Module.__init__(self)
        self.emb_size = emb_size
        self.conv1 = GCNLayer(in_features, hidden_size, activation="relu")
        self.conv_mu = GCNLayer(hidden_size, emb_size)
        self.conv_logstd = GCNLayer(hidden_size, emb_size)

    def encode_dist(self, graph: Graph, x: torch.Tensor,
                    training: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        g = sym_norm(graph)
        h = self.conv1(g, x, training)
        return self.conv_mu(g, h, training), self.conv_logstd(g, h, training)

    def encode(self, graph: Graph, x: torch.Tensor, training: bool = False,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mu + eps·exp(clip(logstd, −10, 10))`` in training, else
        ``mu`` (both heads run either way, as in the JAX model)."""
        mu, logstd = self.encode_dist(graph, x, training)
        if training:
            if eps is None:
                raise ValueError("VGAE.encode in training takes its noise "
                                 "eps (draw_eps)")
            return mu + eps * torch.exp(logstd.clamp(-10, 10))
        return mu

    def kl(self, graph: Graph, x: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
        """The mean KL divergence from the unit normal over the real nodes,
        of a second encode with training off."""
        mu, logstd = self.encode_dist(graph, graph.x if x is None else x,
                                      False)
        logstd = logstd.clamp(-10, 10)
        m = graph.node_mask().to(mu.dtype)[:, None]
        kl = -0.5 * ((1 + 2 * logstd - mu ** 2 - torch.exp(2 * logstd))
                     * m).sum()
        return kl / m.sum().clamp_min(1.0)
