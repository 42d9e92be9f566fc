"""MoE-GCN — the port of ``cogdl_tpu/models/nn/moe_gcn.py``: GCN layers
``gcn{i}`` (K1 on the card), each hidden one followed by a residual
mixture-of-experts FFN ``moe{i}``.

``MoEMLP`` routes each row to its top-1 expert by a softmax gate and
computes every expert densely (batched einsums over the expert axis), the
chosen one's output kept through a one-hot and scaled by its gate
probability, as the JAX module does. Its GELU is the tanh approximation
(``jax.nn.gelu``'s default) and its weights take flax's ``glorot_uniform``
rule, under which an ``[E, D, H]`` tensor has fan-in ``D·E`` and fan-out
``H·E`` (``layers.utils.glorot_uniform_``), which is not ``nn.init.xavier_uniform_``'s.

``adj_norm = "sym"`` is a class attribute, as in ``models/nn/sgc.py``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import glorot_uniform_, reset_parameters


class MoEMLP(nn.Module):
    def __init__(self, in_features: int, num_experts: int = 4,
                 hidden_size: int = 64, capacity_factor: float = 1.5):
        super().__init__()
        E, D, H = num_experts, in_features, hidden_size
        self.capacity_factor = capacity_factor
        self.gate = nn.Parameter(torch.empty(D, E))
        self.w1 = nn.Parameter(torch.empty(E, D, H))
        self.b1 = nn.Parameter(torch.zeros(E, H))
        self.w2 = nn.Parameter(torch.empty(E, H, D))
        self.b2 = nn.Parameter(torch.zeros(E, D))
        self.reset_own_parameters()

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """``gate``, ``w1``, ``w2`` flax Glorot uniform, the biases zero."""
        for p in (self.gate, self.w1, self.w2):
            glorot_uniform_(p, generator)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        probs = torch.softmax(x @ self.gate, -1)               # [N, E]
        expert = probs.argmax(-1)                              # top-1
        gate = probs.gather(1, expert[:, None])                # [N, 1]
        onehot = F.one_hot(expert, self.gate.shape[1]).to(x.dtype)
        h = torch.einsum("nd,edh->neh", x, self.w1) + self.b1[None]
        h = F.gelu(h, approximate="tanh")
        y = torch.einsum("neh,ehd->ned", h, self.w2) + self.b2[None]
        return torch.einsum("ne,ned->nd", onehot, y) * gate


class MoEGCN(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 2,
                 num_experts: int = 4, dropout: float = 0.5):
        super().__init__()
        self.num_layers = num_layers
        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"gcn{i}", GCNLayer(
                width, hidden_size, dropout=dropout, activation="relu"))
            self.add_module(f"moe{i}", MoEMLP(hidden_size, num_experts,
                                              hidden_size))
            width = hidden_size
        self.add_module(f"gcn{num_layers - 1}", GCNLayer(width, out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        g = sym_norm(graph)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"gcn{i}")(g, x, training, generator=generator)
            x = x + getattr(self, f"moe{i}")(x, training)
        return getattr(self, f"gcn{self.num_layers - 1}")(
            g, x, training, generator=generator)
