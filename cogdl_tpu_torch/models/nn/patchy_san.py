"""PATCHY-SAN — the port of ``cogdl_tpu/models/nn/patchy_san.py``:
canonical receptive fields assembled on the host (:func:`assemble_fields`,
the port's own copy) into ``[G, w, k, F]`` tensors, then a 1-D conv net.
No kernel of ours runs.

flax's ``nn.Conv`` is NWC and torch's ``Conv1d`` NCW: the features go in
as ``[G, F, w·k]`` and the conv output is transposed back to ``[G, w,
hidden]`` before the flatten, so that ``fc``'s rows are in the JAX
model's order. ``conv1`` (kernel and stride ``k``) has no padding, which
is what flax's SAME gives there; ``conv2`` (kernel 4) pads ``(1, 2)``, as
lax's SAME does (and torch's ``"same"``, which warns for an even kernel).
A flax conv kernel ``[k, in, out]`` is torch's ``weight`` ``[out, in, k]``
(``models.load_jax_params``)."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...layers.utils import CDense, dropout, reset_parameters


def assemble_fields(graphs: List, width: int = 16, k: int = 8) -> np.ndarray:
    """For each graph, the ``width`` nodes of highest degree (numpy's
    default ``argsort`` of ``-degree``, as the JAX package ranks them), each
    with its ``k − 1`` neighbours of highest degree: an index array
    ``[G, width, k]``. Empty slots point at node 0."""
    fields = []
    for g in graphs:
        E, N = g.num_edges, g.num_nodes
        row = g.row[:E].cpu().numpy()
        col = g.col[:E].cpu().numpy()
        deg = np.bincount(row, minlength=N)
        order = np.argsort(-deg)
        centers = order[:width]
        fld = np.zeros((width, k), np.int64)
        for i, c in enumerate(centers[: min(width, N)]):
            nbrs = col[row == c]
            nbrs = nbrs[np.argsort(-deg[nbrs])][: k - 1]
            seq = np.concatenate([[c], nbrs])
            fld[i, : len(seq)] = seq
        fields.append(fld)
    return np.stack(fields)


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator] = None) -> None:
    """flax ``lecun_normal``: a normal truncated at ±2σ, its σ corrected
    for the truncation, variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class PatchySAN(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 32, width: int = 16, k: int = 8,
                 dropout: float = 0.3):
        super().__init__()
        self.width = width
        self.k = k
        self.dropout = dropout
        self.conv1 = nn.Conv1d(in_features, hidden_size, k, stride=k)
        self.conv2 = nn.Conv1d(hidden_size, hidden_size, 4)
        self.fc = CDense(width * hidden_size, 128)
        self.out = CDense(128, out_features)

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """The convolutions as flax initialises them: LeCun-normal kernels
        over ``kernel size · in`` inputs, zero biases."""
        for conv in (self.conv1, self.conv2):
            _lecun_normal_(conv.weight, conv.in_channels * conv.kernel_size[0],
                           generator)
            with torch.no_grad():
                conv.bias.zero_()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, batch, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``batch``: a dict with ``feats`` ``[G, w, k, F]``, or that
        tensor."""
        feats = batch["feats"] if isinstance(batch, dict) else batch
        G, w, k, feat = feats.shape
        h = feats.reshape(G, w * k, feat).transpose(1, 2)   # [G, F, w·k]
        h = torch.relu(self.conv1(h))                       # [G, hidden, w]
        h = torch.relu(self.conv2(F.pad(h, (1, 2))))
        h = h.transpose(1, 2).reshape(G, -1)                # [G, w·hidden]
        if self.dropout > 0 and training:
            h = dropout(h, self.dropout, generator)
        h = torch.relu(self.fc(h))
        return self.out(h)
