"""Plain MLP block — the port of ``cogdl_tpu/layers/mlp.py``.

``num_layers`` dense layers named ``fc{i}``; each hidden one is followed by
the activation, an optional norm ``norm{i}`` (``act_first`` puts the
activation before it) and dropout drawn from the generator. ``batchnorm``
is flax ``nn.BatchNorm`` over all rows (momentum 0.99, eps 1e-5, the biased
variance), which is ``MaskedBatchNorm`` without a mask; ``layernorm`` is
flax's, eps 1e-6.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .utils import CDense, MaskedBatchNorm, dropout, get_activation


class MLP(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_features: int = 64, num_layers: int = 2,
                 dropout: float = 0.0, activation: Optional[str] = "relu",
                 norm: Optional[str] = None, act_first: bool = False):
        super().__init__()
        if norm not in (None, "batchnorm", "layernorm"):
            raise ValueError(f"unknown norm {norm!r}: batchnorm | layernorm")
        self.num_layers = num_layers
        self.dropout = dropout
        self.activation = activation
        self.norm = norm
        self.act_first = act_first
        width = in_features
        for i in range(num_layers - 1):
            self.add_module(f"fc{i}", CDense(width, hidden_features))
            if norm == "batchnorm":
                self.add_module(f"norm{i}", MaskedBatchNorm(hidden_features))
            elif norm == "layernorm":
                self.add_module(f"norm{i}",
                                nn.LayerNorm(hidden_features, eps=1e-6))
            width = hidden_features
        self.add_module(f"fc{num_layers - 1}", CDense(width, out_features))

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        act = get_activation(self.activation)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"fc{i}")(x)
            if self.act_first:
                x = act(x)
            if self.norm == "batchnorm":
                x = getattr(self, f"norm{i}")(
                    x, use_running_average=not training)
            elif self.norm == "layernorm":
                x = getattr(self, f"norm{i}")(x)
            if not self.act_first:
                x = act(x)
            if self.dropout > 0 and training:
                x = dropout(x, self.dropout, generator)
        return getattr(self, f"fc{self.num_layers - 1}")(x)
