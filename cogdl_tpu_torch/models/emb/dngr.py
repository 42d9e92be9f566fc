"""DNGR — the port of ``cogdl_tpu/models/emb/dngr.py``: the random-surfing
PPMI matrix formed densely in float64 on the device, then a denoising
autoencoder on its rows (each epoch's Bernoulli keep mask drawn on the
device), trained full-batch with Adam."""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel, dense_on, graph_to_scipy
from .sdne import build_ae


class DNGR(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, enc_hidden: int = 256,
                 step: int = 5, alpha: float = 0.98, epochs: int = 200,
                 lr: float = 1e-3, noise: float = 0.2, seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.enc_hidden = enc_hidden
        self.step = step
        self.alpha = alpha
        self.epochs = epochs
        self.lr = lr
        self.noise = noise
        # the flax parameters to start from instead of the port's draw
        self.initial_params: Optional[Mapping] = None

    def ppmi(self, graph: Graph, device) -> torch.Tensor:
        """The PPMI of ``Σ_{s=1..step}`` random-surfing steps
        ``cur ← α·cur·P + (1 − α)·I``, in float32."""
        A = dense_on(graph_to_scipy(graph), device)
        N = A.shape[0]
        P = A / A.sum(1, keepdim=True).clamp_min(1e-12)
        del A
        eye = torch.eye(N, dtype=torch.float64, device=device)
        M = torch.zeros_like(P)
        cur = eye
        for _ in range(self.step):
            cur = self.alpha * (cur @ P) + (1 - self.alpha) * eye
            M += cur
        del cur, P, eye
        outer = M.sum(1, keepdim=True) @ M.sum(0, keepdim=True)
        M *= M.sum() / outer.clamp_min_(1e-12)
        del outer
        return torch.log(M.clamp_min_(1.0)).float()

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        with self.stage("factorize", device):
            X = self.ppmi(graph, device)
        with self.stage("train", device):
            ae = build_ae(self, X.shape[0], device, self.initial_params)
            opt = torch.optim.Adam(ae.parameters(), lr=self.lr, eps=1e-8)
            draws = self.make_draws("masks", self.seed, device)
            for _ in range(self.epochs):
                keep = draws.bernoulli(1 - self.noise, X.shape)
                opt.zero_grad(set_to_none=True)
                _, rec = ae(X * keep)
                ((rec - X) ** 2).mean().backward()
                opt.step()
            self.stats["ae_steps"] = self.epochs
            with torch.no_grad():
                return ae(X)[0]
