"""Activation compression — the port of ``act_dense``, ``act_relu`` and the
row-wise int8 quantisation of ``cogdl_tpu/ops/actnn.py`` (ActNN's memory
profile: the backward keeps quantised activations).

  * :class:`ActDense`: ``y = x @ w + b`` keeping ``x`` for the backward as
    int8 with one fp32 scale a row; ``dw = x̂ᵀ g`` reads the dequantised
    ``x̂``, so the weight gradient is quantised, while ``dx = g wᵀ`` uses the
    exact ``w``.
  * :class:`ActReLU`: ReLU keeping only the bool sign mask.

Rounding is half to even, as ``jnp.round`` does. The process-wide switch
(``set_compression``, ``compressed_*``) and the trainer's flag wait in
ROADMAP.md §1."""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 values, fp32 scale a row)`` with ``x ≈ q · scale``."""
    amax = x.abs().amax(-1, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_rowwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class ActDense(torch.autograd.Function):
    """``x @ w + b`` (``w`` ``[in, out]``) with an int8 residual for ``x``."""

    @staticmethod
    def forward(ctx, x, w, b):
        q, scale = quantize_rowwise(x.detach())
        ctx.save_for_backward(q, scale, w)
        return x @ w + b

    @staticmethod
    def backward(ctx, g):
        q, scale, w = ctx.saved_tensors
        dx = g @ w.T
        dw = dequantize_rowwise(q, scale).T @ g
        return dx, dw, g.sum(0)


class ActReLU(torch.autograd.Function):
    """ReLU keeping the bool mask ``x > 0`` for the backward."""

    @staticmethod
    def forward(ctx, x):
        mask = x > 0
        ctx.save_for_backward(mask)
        return torch.where(mask, x, torch.zeros_like(x))

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros_like(g))


def act_dense(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    return ActDense.apply(x, w, b)


def act_relu(x: torch.Tensor) -> torch.Tensor:
    return ActReLU.apply(x)
