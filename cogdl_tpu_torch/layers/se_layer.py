"""Squeeze-and-excitation over node features — the port of
``cogdl_tpu/layers/se_layer.py``. The squeeze is the mean over all
``n_pad`` rows, pad rows included, as in the JAX layer."""

from __future__ import annotations

import torch
from torch import nn

from .utils import CDense


class SELayer(nn.Module):
    def __init__(self, in_features: int, se_channels: int = 16):
        super().__init__()
        self.fc1 = CDense(in_features, se_channels)
        self.fc2 = CDense(se_channels, in_features)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        s = self.fc2(torch.relu(self.fc1(x.mean(0, keepdim=True))))
        return x * torch.sigmoid(s)
