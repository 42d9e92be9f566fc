"""Hin2vec — the port of ``cogdl_tpu/models/emb/hin2vec.py``: uniform walks
(the port's C++ walker) emit ``(u, v, path type)`` triples within a
window, the path type ``type(u)·T·W + type(v)·W + hop``; a node table and a
relation table train on the device with a Hadamard relation scorer and
negative sampling, dense Adam over both as optax runs it (eps 1e-8; the
moments of rows a batch misses decay too).

Every draw comes from one stage's draws, as the JAX model takes them from
one numpy stream: the node table ``normal·0.1``, an epoch's permutation and
a batch's negatives. An epoch is ``max(n // B, 1)`` batches of the
permuted triples, a short batch padded from the permutation's start."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from .base import EmbeddingModel
from .metapath2vec import node_types
from .walks import build_csr, random_walks


def hin2vec_loss(node: torch.Tensor, rel: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor, r: torch.Tensor,
                 vneg: torch.Tensor) -> torch.Tensor:
    """``−(mean log σ(⟨n_u, n_v, σ(rel_r)⟩) + mean log σ(−⟨n_u·σ(rel_r),
    n_neg⟩))`` of one batch."""
    gate = torch.sigmoid(rel[r])
    nu = node[u]
    pos = (nu * node[v] * gate).sum(-1)
    neg = torch.einsum("bd,bkd->bk", nu * gate, node[vneg])
    return -(F.logsigmoid(pos).mean() + F.logsigmoid(-neg).mean())


class Hin2Vec(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, walk_length: int = 20,
                 walk_num: int = 5, window_size: int = 3, negative: int = 4,
                 epochs: int = 2, lr: float = 0.01, batch_size: int = 4096,
                 seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.walk_length = walk_length
        self.walk_num = walk_num
        self.window_size = window_size
        self.negative = negative
        self.epochs = epochs
        self.lr = lr
        self.batch_size = batch_size

    def _walks(self, graph: Graph) -> np.ndarray:
        indptr, indices = build_csr(graph)
        return random_walks(indptr, indices, self.walk_num, self.walk_length,
                            seed=self.seed)

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        N, W = graph.num_nodes, self.window_size
        with self.stage("walks", device):
            walks = self._walks(graph)
        with self.stage("pairs", device):
            node_type = torch.from_numpy(
                node_types(graph).astype(np.int64)).to(device)
            T = int(node_type.max()) + 1
            w = torch.from_numpy(walks).to(device)
            us, vs, rs = [], [], []
            for off in range(1, W + 1):
                u = w[:, :-off].reshape(-1)
                v = w[:, off:].reshape(-1)
                us.append(u)
                vs.append(v)
                rs.append(node_type[u] * T * W + node_type[v] * W + off - 1)
            U, V, R = torch.cat(us), torch.cat(vs), torch.cat(rs)
        with self.stage("train", device):
            draws = self.make_draws("hin2vec", self.seed, device)
            node = (draws.normal((N, self.hidden_size)) * 0.1).float()
            node = node.to(device).requires_grad_()
            rel = torch.zeros(T * T * W, self.hidden_size, device=device,
                              requires_grad=True)
            opt = torch.optim.Adam([node, rel], lr=self.lr, eps=1e-8)
            n, B = U.shape[0], self.batch_size
            steps = 0
            for _ in range(self.epochs):
                perm = draws.permutation(n).to(device)
                for b in range(max(n // B, 1)):
                    sl = perm[b * B: (b + 1) * B]
                    if sl.shape[0] < B:
                        sl = torch.cat([sl, perm[: B - sl.shape[0]]])
                    vneg = draws.integers(0, N, (B, self.negative)).to(device)
                    opt.zero_grad(set_to_none=False)
                    hin2vec_loss(node, rel, U[sl], V[sl], R[sl],
                                 vneg).backward()
                    opt.step()
                    steps += 1
            self.stats["adam_steps"] = steps
            return node.detach()
