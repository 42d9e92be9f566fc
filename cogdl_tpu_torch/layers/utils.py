"""Shared layer helpers — the port of ``cogdl_tpu/layers/utils.py``:
activation lookup, the ``CDense`` linear layer with the JAX package's
initialisation, generator-driven dropout, ``MaskedBatchNorm`` and
``reset_parameters``, which re-initialises a whole model."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
    "prelu": lambda x: F.leaky_relu(x, 0.25),
    "softplus": F.softplus,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def get_activation(name):
    """Activation by name; ``None`` is the identity."""
    if name is None:
        return _ACTIVATIONS["identity"]
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}"
        ) from None


def dropout_keep(shape, rate: float, device,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The keep mask :func:`dropout` draws for a tensor of ``shape``: one
    uniform per element from ``generator``, kept below ``1 - rate``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout drawn from an explicit generator: keep with
    probability ``1 - rate`` and scale kept values by ``1 / (1 - rate)``.
    ``keep``, a mask drawn earlier by :func:`dropout_keep`, is used instead
    of a fresh draw."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if keep is None:
        keep = dropout_keep(x.shape, rate, x.device, generator)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class CDense(nn.Linear):
    """``nn.Linear`` with the JAX package's ``CDense`` initialisation: a
    LeCun-normal weight (variance 1/fan_in, truncated at two standard
    deviations) and a zero bias. ``weight`` is [out, in]; the flax kernel is
    its transpose."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        # flax lecun_normal: truncated normal whose std is corrected for the
        # truncation at ±2σ
        std = math.sqrt(1.0 / self.in_features) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.zero_()


class MaskedBatchNorm(nn.Module):
    """BatchNorm whose batch statistics ignore pad rows.

    Graphs are statically padded; all-zero pad rows would pull the batch mean
    toward 0. Pass the graph's node mask. Running statistics follow flax's
    convention: ``ra = momentum · ra + (1 − momentum) · batch``."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x, mask=None, use_running_average: bool = True):
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            xf = x.float()
            if mask is None:
                mean = xf.mean(0)
                var = xf.var(0, unbiased=False)
            else:
                m = mask.float().unsqueeze(-1)
                n = m.sum().clamp_min(1.0)
                mean = (xf * m).sum(0) / n
                var = ((xf - mean) ** 2 * m).sum(0) / n
            with torch.no_grad():
                mom = self.momentum
                self.mean.mul_(mom).add_((1 - mom) * mean.detach())
                self.var.mul_(mom).add_((1 - mom) * var.detach())
        inv = torch.rsqrt(var + self.epsilon).to(x.dtype)
        return (x - mean.to(x.dtype)) * inv * self.scale + self.bias


def reset_parameters(model: nn.Module,
                     generator: Optional[torch.Generator] = None) -> None:
    """Re-initialise every parameter of ``model`` from ``generator``, module
    by module in ``model.modules()`` order: each ``CDense`` and
    ``MaskedBatchNorm`` by its own ``reset_parameters``, each
    ``nn.LayerNorm`` to ones and zeros, and each module that holds
    parameters of its own beside its children (GAT's attention vectors,
    GENConv's scalars) by its ``reset_own_parameters``."""
    for m in model.modules():
        if isinstance(m, (CDense, MaskedBatchNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        elif hasattr(m, "reset_own_parameters"):
            m.reset_own_parameters(generator)
