"""BGRL (bootstrapped graph representation learning) — the port of
``cogdl_tpu/models/nn/bgrl.py``: a student encoder (``enc``: two
bias-free GCN layers, each with masked batch norm, momentum 0.99, and
flax's learnable ``PReLU``) and predictor chase an EMA teacher across two
augmented views, without negatives.

The names are flax's: ``enc.gcn1``, ``enc.bn1``, ``enc.PReLU_0``, …, and
the predictor ``pred1``, ``pred.layers_1`` (the PReLU that flax's
``nn.Sequential`` names inside ``pred``), ``pred2``. ``teacher`` is the
encoder's twin in buffers (``layers.utils.frozen_copy``: its weights and
running statistics), ``ema_step`` the EMA's step count, both in the
``state_dict`` and outside the optimizer; the wrapper moves them. The
model declares no ``adj_norm``: each view drops the raw self-loop weights
and the encoder normalises them, K1 reading them through the structure.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import (
    CDense,
    MaskedBatchNorm,
    PReLU,
    copy_into_,
    frozen_copy,
    reset_parameters,
)


class BGRLEncoder(nn.Module):
    def __init__(self, in_features: int, hidden_size: int, rep_size: int):
        super().__init__()
        self.gcn1 = GCNLayer(in_features, hidden_size, bias=False)
        self.bn1 = MaskedBatchNorm(hidden_size, momentum=0.99)
        self.PReLU_0 = PReLU()
        self.gcn2 = GCNLayer(hidden_size, rep_size, bias=False)
        self.bn2 = MaskedBatchNorm(rep_size, momentum=0.99)
        self.PReLU_1 = PReLU()

    def forward(self, graph: Graph, x: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        g = sym_norm(graph)
        mask = graph.node_mask()   # pad rows must not skew the statistics
        x = self.gcn1(g, x, training)
        x = self.PReLU_0(self.bn1(x, mask, use_running_average=not training))
        x = self.gcn2(g, x, training)
        return self.PReLU_1(self.bn2(x, mask,
                                     use_running_average=not training))


class BGRL(nn.Module):
    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 256, rep_size: Optional[int] = None,
                 pred_hid: Optional[int] = None):
        super().__init__()
        rep = rep_size or hidden_size
        hid = pred_hid or hidden_size
        self.enc = BGRLEncoder(in_features, hidden_size, rep)
        self.pred1 = CDense(rep, hid)
        self.pred = nn.ModuleDict({"layers_1": PReLU()})
        self.pred2 = CDense(hid, rep)
        self.teacher = frozen_copy(self.enc)
        self.register_buffer("ema_step", torch.zeros(()))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-initialise the student from ``generator``, set the teacher to
        it and the EMA's step to 0 (the JAX wrapper's ``init``)."""
        for name, child in self.named_children():
            if name != "teacher":
                reset_parameters(child, generator)
        copy_into_(self.teacher, self.enc)
        with torch.no_grad():
            self.ema_step.zero_()

    def embed(self, graph: Graph, x: Optional[torch.Tensor] = None,
              training: bool = False) -> torch.Tensor:
        return self.enc(graph, graph.x if x is None else x, training)

    def student(self, graph: Graph, x: torch.Tensor,
                training: bool = True) -> torch.Tensor:
        """The online branch: the encoder, then the predictor."""
        h = self.enc(graph, x, training)
        return self.pred2(self.pred["layers_1"](self.pred1(h)))

    @torch.no_grad()
    def teacher_embed(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        """The teacher's encoder on its running statistics, no gradient."""
        return self.teacher(graph, x, False)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.embed(graph, x, training)
