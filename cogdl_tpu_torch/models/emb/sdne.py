"""SDNE — the port of ``cogdl_tpu/models/emb/sdne.py``: a deep autoencoder
on the dense adjacency rows with the first-order Laplacian regulariser,
trained full-batch on the device with Adam (the optax defaults)."""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, dense_on, graph_to_scipy


class AE(nn.Module):
    """``enc1 → enc2`` (the embedding ``z``) ``→ dec1 → dec2`` (the
    reconstruction), ReLU after all but the last; the JAX ``_AE``'s four
    Dense layers under the same names."""

    def __init__(self, in_features: int, hidden: int, emb: int):
        super().__init__()
        self.enc1 = nn.Linear(in_features, hidden)
        self.enc2 = nn.Linear(hidden, emb)
        self.dec1 = nn.Linear(emb, hidden)
        self.dec2 = nn.Linear(hidden, in_features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``Dense``'s initialisers: LeCun-normal kernels (a normal of
        variance 1/fan_in truncated at two deviations, rescaled to that
        variance), zero biases."""
        for lin in (self.enc1, self.enc2, self.dec1, self.dec2):
            std = math.sqrt(1.0 / lin.in_features) / .87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                lin.bias.zero_()

    def forward(self, a: torch.Tensor):
        z = F.relu(self.enc2(F.relu(self.enc1(a))))
        return z, self.dec2(F.relu(self.dec1(z)))


def build_ae(model: EmbeddingModel, n: int, device,
             params: Optional[Mapping]) -> AE:
    """The model's autoencoder on ``device``: the JAX package's flax
    ``params`` when given, else drawn from torch's generator seeded with
    the model's seed."""
    from .. import load_jax_params

    ae = AE(n, model.enc_hidden, model.hidden_size)
    if params is not None:
        load_jax_params(ae, params)
    else:
        ae.reset_parameters(torch.Generator().manual_seed(model.seed))
    return ae.to(device)


class SDNE(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, enc_hidden: int = 256,
                 alpha: float = 0.1, beta: float = 5.0, epochs: int = 200,
                 lr: float = 1e-3, seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.enc_hidden = enc_hidden
        self.alpha = alpha
        self.beta = beta
        self.epochs = epochs
        self.lr = lr
        # the flax parameters to start from instead of the port's draw
        self.initial_params: Optional[Mapping] = None

    def loss(self, ae: AE, A: torch.Tensor, b: torch.Tensor,
             deg: torch.Tensor) -> torch.Tensor:
        """The second-order reconstruction (non-zeros weighted ``beta``)
        plus ``alpha`` times the first-order term ``2·tr(ZᵀLZ)/N²``."""
        N = A.shape[0]
        z, rec = ae(A)
        l2nd = (((rec - A) * b) ** 2).mean()
        lap = ((z * (deg[:, None] * z)).sum() - ((A @ z) * z).sum()) / N
        return l2nd + self.alpha * 2.0 * lap / max(N, 1)

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        with self.stage("train", device):
            A = dense_on(graph_to_scipy(graph), device, torch.float32)
            ae = build_ae(self, A.shape[0], device, self.initial_params)
            opt = torch.optim.Adam(ae.parameters(), lr=self.lr, eps=1e-8)
            b = torch.where(A > 0, self.beta, 1.0)
            deg = A.sum(1)
            for _ in range(self.epochs):
                opt.zero_grad(set_to_none=True)
                self.loss(ae, A, b, deg).backward()
                opt.step()
            self.stats["ae_steps"] = self.epochs
            with torch.no_grad():
                return ae(A)[0]
