"""GraphMAE2 — the port of ``cogdl_tpu/models/nn/graphmae2.py``: GraphMAE's
masked reconstruction decoded ``num_remasking`` times, each time with an
independent remask by ``dec_mask_token``, plus a latent loss that chases
an EMA teacher (encoder and projector) run on the unmasked inputs.

The submodules carry the flax names: ``enc`` (``gcn{i}``), ``proj``
(``Dense_0``, ``PReLU_0``, ``Dense_1``), ``pred`` (``PReLU_0``,
``Dense_0``), ``dec``, ``enc2dec``; their ``PReLU`` is flax's learnable
scalar that starts at 0.01. ``teacher`` holds ``enc`` and ``proj`` as
buffers (``layers.utils.frozen_copy``): in the ``state_dict``, so the
trainer's best snapshot carries it, and outside the optimizer. The
wrapper moves it toward the student's pre-step weights and draws the masks.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ...data.graph import Graph, sym_norm
from ...layers import GCNLayer
from ...layers.utils import (
    CDense,
    PReLU,
    copy_into_,
    frozen_copy,
    reset_parameters,
)
from .graphmae import sce_loss


class _Projector(nn.Module):
    def __init__(self, in_features: int, mid: int, out: int):
        super().__init__()
        self.Dense_0 = CDense(in_features, mid)
        self.PReLU_0 = PReLU()
        self.Dense_1 = CDense(mid, out)

    def forward(self, x):
        return self.Dense_1(self.PReLU_0(self.Dense_0(x)))


class _Predictor(nn.Module):
    def __init__(self, in_features: int, out: int):
        super().__init__()
        self.PReLU_0 = PReLU()
        self.Dense_0 = CDense(in_features, out)

    def forward(self, x):
        return self.Dense_0(self.PReLU_0(x))


class GM2Encoder(nn.Module):
    def __init__(self, in_features: int, hidden_size: int,
                 num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        width = in_features
        for i in range(num_layers):
            self.add_module(f"gcn{i}", GCNLayer(width, hidden_size,
                                                activation="prelu"))
            width = hidden_size

    def forward(self, graph: Graph, x: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        g = sym_norm(graph)
        for i in range(self.num_layers):
            x = getattr(self, f"gcn{i}")(g, x, training)
        return x


class _Teacher(nn.Module):
    """Frozen twins of the student's encoder and projector."""

    def __init__(self, enc: nn.Module, proj: nn.Module):
        super().__init__()
        self.enc = frozen_copy(enc)
        self.proj = frozen_copy(proj)


class GraphMAE2(nn.Module):
    adj_norm = "sym"

    def __init__(self, in_features: int, out_features: int = 0,
                 hidden_size: int = 256, num_layers: int = 2,
                 mask_rate: float = 0.5, remask_rate: float = 0.5,
                 num_remasking: int = 3, gamma: float = 2.0,
                 lam: float = 1.0):
        super().__init__()
        self.mask_rate = mask_rate
        self.remask_rate = remask_rate
        self.num_remasking = num_remasking
        self.gamma = gamma
        self.lam = lam
        self.enc = GM2Encoder(in_features, hidden_size, num_layers)
        self.proj = _Projector(hidden_size, 256, hidden_size)
        self.pred = _Predictor(hidden_size, hidden_size)
        self.dec = GCNLayer(hidden_size, in_features)
        self.enc2dec = CDense(hidden_size, hidden_size, bias=False)
        self.mask_token = nn.Parameter(torch.zeros(1, in_features))
        self.dec_mask_token = nn.Parameter(torch.zeros(1, hidden_size))
        self.teacher = _Teacher(self.enc, self.proj)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-initialise the student from ``generator`` and set the teacher
        to it (the JAX wrapper's ``init``)."""
        for name, child in self.named_children():
            if name != "teacher":
                reset_parameters(child, generator)
        with torch.no_grad():
            self.mask_token.zero_()
            self.dec_mask_token.zero_()
        self.sync_teacher()

    def sync_teacher(self) -> None:
        copy_into_(self.teacher.enc, self.enc)
        copy_into_(self.teacher.proj, self.proj)

    def encode(self, graph: Graph, x: torch.Tensor,
               training: bool = False) -> torch.Tensor:
        return self.enc(graph, x, training)

    def forward(self, graph: Graph, x: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encode(graph, graph.x if x is None else x, training)

    def embed(self, graph: Graph,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encode(graph, graph.x if x is None else x, False)

    @torch.no_grad()
    def teacher_latent(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        """The EMA branch: the teacher's encoder and projector on the
        unmasked inputs, no gradient."""
        return self.teacher.proj(self.teacher.enc(graph, x, False))

    def student_latent(self, h: torch.Tensor) -> torch.Tensor:
        return self.pred(self.proj(h))

    def mask_inputs(self, x: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """``x`` with the rows of ``mask`` (``[n_pad, 1]``) replaced by
        ``mask_token``."""
        return torch.where(mask, self.mask_token, x)

    def remask_decode(self, graph: Graph, h: torch.Tensor,
                      mask: torch.Tensor, remasks: List[torch.Tensor],
                      training: bool) -> torch.Tensor:
        """Decode once a remask of ``remasks`` (each ``[n_pad, 1]``), the
        remasked rows ``dec_mask_token``; the sum over decodes of the
        scaled cosine error on the nodes of ``mask``."""
        g = sym_norm(graph)
        h = self.enc2dec(h)
        m = mask[:, 0].to(h.dtype)
        total = 0.0
        for rm in remasks:
            rec = self.dec(g, torch.where(rm, self.dec_mask_token, h),
                           training)
            per = sce_loss(rec, graph.x, self.gamma)
            total = total + (per * m).sum() / m.sum().clamp_min(1.0)
        return total
