"""Shared layer helpers — the port of ``cogdl_tpu/layers/utils.py``:
activation lookup, the ``CDense`` linear layer with the JAX package's
initialisation, generator-driven dropout, ``MaskedBatchNorm`` and
``reset_parameters``, which re-initialises a whole model; flax's
learnable ``PReLU`` and ``frozen_copy``, a module's twin held in buffers
(the EMA teachers of the self-supervised wrappers)."""

from __future__ import annotations

import copy
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
    # jax.nn.leaky_relu's form: at exactly 0 its gradient is 1, where
    # F.leaky_relu's is the slope (a node whose inputs are all zero, such
    # as GraphMAE's masked rows at a zero mask token, sits there)
    "leaky_relu": lambda x: torch.where(x >= 0, x, 0.2 * x),
    "prelu": lambda x: torch.where(x >= 0, x, 0.25 * x),
    "softplus": F.softplus,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def flax_fans(shape):
    """flax ``variance_scaling``'s ``(fan_in, fan_out)`` of a kernel of
    ``shape``: the last two axes are in and out, every axis before them a
    receptive field that multiplies both (an ``[E, D, H]`` tensor: ``D·E``
    and ``H·E``, where ``nn.init.xavier_uniform_`` counts ``D·H`` and
    ``E·H``)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def glorot_uniform_(p: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> None:
    """flax ``glorot_uniform`` in place: uniform in ``±sqrt(6 / (fan_in +
    fan_out))`` with :func:`flax_fans`, one draw an element from
    ``generator``."""
    fan_in, fan_out = flax_fans(tuple(p.shape))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0)
                * limit)


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
        # (a zero-width weight, the placeholder encoder experiment() builds
        # for a features-less KG set, has nothing to draw)
        std = math.sqrt(1.0 / max(self.in_features, 1)) / 0.87962566103423978
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


class PReLU(nn.Module):
    """flax ``nn.PReLU``: one learnable negative slope (``negative_slope``,
    a scalar) that starts at 0.01, where ``torch.nn.PReLU`` starts at
    0.25."""

    def __init__(self, negative_slope_init: float = 0.01):
        super().__init__()
        self.negative_slope_init = negative_slope_init
        self.negative_slope = nn.Parameter(torch.tensor(negative_slope_init))

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.negative_slope.fill_(self.negative_slope_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


def frozen_copy(module: nn.Module) -> nn.Module:
    """A deep copy of ``module`` whose parameters are buffers of the same
    names: in its ``state_dict`` (a snapshot carries it), not in its
    ``parameters()`` (no optimizer sees it). Its forward is the module's."""
    twin = copy.deepcopy(module)
    for m in twin.modules():
        for name, p in list(m._parameters.items()):
            if p is not None:
                del m._parameters[name]
                m.register_buffer(name, p.detach().clone())
    return twin


@torch.no_grad()
def ema_(target: nn.Module, source: nn.Module, beta) -> None:
    """Move every buffer of ``target`` (a :func:`frozen_copy`) toward the
    tensor of the same name in ``source``'s ``state_dict``: ``t ← t·beta +
    (1 − beta)·s``. ``beta`` is a float or a 0-d tensor on their device."""
    src = source.state_dict()
    for name, t in target.named_buffers():
        t.mul_(beta).add_(src[name].detach() * (1.0 - beta))


@torch.no_grad()
def copy_into_(target: nn.Module, source: nn.Module) -> None:
    """Set every buffer of ``target`` (a :func:`frozen_copy`) to the tensor
    of the same name in ``source``'s ``state_dict``."""
    src = source.state_dict()
    for name, t in target.named_buffers():
        t.copy_(src[name])
