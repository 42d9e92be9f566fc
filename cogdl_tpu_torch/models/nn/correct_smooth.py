"""Correct & Smooth — the port of ``cogdl_tpu/models/nn/correct_smooth.py``:
an MLP predictor (``mlp``) and the label-propagation post-processing
:meth:`CorrectSmoothMLP.postprocess`, run at prediction time by the
``correct_smooth`` wrapper: ``correct_steps`` propagations of the train
residual, then ``smooth_steps`` of the corrected predictions, each one K1
call on the card (loops where the JAX model scans).

The MLP alone reads no graph, so ``calls_spmm`` says that the model
propagates and the wrappers build the kernels' structure for it;
``adj_norm = "sym"`` is a class attribute, as in ``models/nn/sgc.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import MLP
from ...layers.utils import reset_parameters
from ...ops import spmm


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``jax.nn.one_hot``: float rows, all zero for a label outside
    ``[0, num_classes)`` (``F.one_hot`` raises on a negative label)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long().unsqueeze(-1) == classes).float()


class CorrectSmoothMLP(nn.Module):
    adj_norm = "sym"
    calls_spmm = True

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 64, num_layers: int = 3,
                 dropout: float = 0.5, correct_alpha: float = 0.8,
                 smooth_alpha: float = 0.8, correct_steps: int = 50,
                 smooth_steps: int = 50):
        super().__init__()
        self.correct_alpha = correct_alpha
        self.smooth_alpha = smooth_alpha
        self.correct_steps = correct_steps
        self.smooth_steps = smooth_steps
        self.mlp = MLP(in_features, out_features, hidden_features=hidden_size,
                       num_layers=num_layers, dropout=dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x is None:
            x = graph.x
        return self.mlp(x, training, generator)

    def postprocess(self, graph: Graph, logits: torch.Tensor) -> torch.Tensor:
        """C&S: propagate the train nodes' residual errors, add them to the
        probabilities, then smooth the predictions with the train labels
        clamped."""
        g = sym_norm(graph)
        y_onehot = one_hot(graph.y, logits.shape[-1]).to(logits.dtype)
        probs = torch.softmax(logits, -1)
        train = (graph.train_mask & graph.node_mask()).to(
            probs.dtype).unsqueeze(-1)
        err = (y_onehot - probs) * train
        e = err
        for _ in range(self.correct_steps):
            e = self.correct_alpha * spmm(g, e) + (1 - self.correct_alpha) * err
        probs = probs + e   # fixed scale 1, as the JAX model
        base = probs * (1 - train) + y_onehot * train
        h = base
        for _ in range(self.smooth_steps):
            h = self.smooth_alpha * spmm(g, h) + (1 - self.smooth_alpha) * base
        return h
