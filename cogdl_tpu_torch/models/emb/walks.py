"""Random walks and skip-gram with negative sampling — the port of
``cogdl_tpu/models/emb/walks.py``.

``random_walks`` runs the port's C++ walker (``native.random_walk``) on the
host; ``node2vec_walks`` keeps the JAX package's numpy stream
(``default_rng(seed)``), so its walks are the JAX walker's bit for bit, with
the neighbour test one vectorised lookup of the ``row·N + col`` keys
(:func:`edge_test`) instead of a Python loop of ``searchsorted`` calls
over the candidates. ``walks_to_pairs``
builds and shuffles the pairs on the device and ``train_sgns`` trains the
tables there: dense Adam over both tables as optax runs it (the moments of
rows a batch does not touch decay too).

Every random draw of a stage comes from a :class:`Draws`: torch's generator
on the device, seeded with the stage's seed. The JAX package draws from
numpy and Threefry on the host, which the card cannot replay; its tests
hand in replays of those streams with the same methods.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ... import native
from ...data.graph import Graph


class Draws:
    """One stage's random draws, from torch's generator on ``device``
    seeded with ``seed`` (``stage`` names the stage for a replay)."""

    def __init__(self, stage: str, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device)

    def integers(self, low: int, high: int, shape) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.gen,
                             device=self.device)

    def random(self, shape) -> torch.Tensor:
        """Uniform float64 in [0, 1)."""
        return torch.rand(tuple(shape), generator=self.gen,
                          dtype=torch.float64, device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device)

    def choice(self, p: torch.Tensor, size: int) -> torch.Tensor:
        """``size`` indices drawn with replacement by the probabilities
        ``p`` (float64): uniforms inverted through the cumulative sum."""
        cdf = torch.cumsum(p, 0)
        u = self.random((size,)) * cdf[-1]
        return torch.searchsorted(cdf, u, right=True).clamp_max(
            p.numel() - 1)

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        """Booleans, each True with probability ``p``."""
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.device) < p


def build_csr(graph: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr, indices) over real edges, symmetrised."""
    from .base import graph_to_scipy

    A = graph_to_scipy(graph)
    return A.indptr.astype(np.int64), A.indices.astype(np.int64)


def random_walks(indptr: np.ndarray, indices: np.ndarray, num_walks: int,
                 walk_length: int, seed: int = 0, p_restart: float = 0.0,
                 num_threads: Optional[int] = None) -> np.ndarray:
    """Uniform random walks, ``num_walks`` from every node in turn, by the
    port's C++ walker on ``num_threads`` OpenMP threads (all by default):
    ``int64 [num_walks·N, walk_length]``, column 0 the starts."""
    N = indptr.shape[0] - 1
    starts = np.tile(np.arange(N), num_walks)
    threads = native.max_threads() if num_threads is None else num_threads
    return native.random_walk(indptr, indices, starts, walk_length,
                              seed=seed, num_threads=threads,
                              restart_prob=p_restart)


# the most nodes whose adjacency bitmap (N² bits) the edge test builds
BITMAP_NODES = 1 << 15


def edge_test(indptr: np.ndarray, indices: np.ndarray):
    """A function telling, for keys ``row·N + col``, whether each is an
    entry of the CSR: a lookup in a bitmap of the N² keys up to
    :data:`BITMAP_NODES` nodes, else a ``searchsorted`` of the sorted
    keys over the entries' keys (ascending: rows in order, each sorted)."""
    N = indptr.shape[0] - 1
    keys = np.repeat(np.arange(N, dtype=np.int64), np.diff(indptr)) * N \
        + indices
    if N <= BITMAP_NODES:
        bits = np.zeros((N * N + 7) // 8, np.uint8)
        np.bitwise_or.at(bits, keys >> 3, (1 << (keys & 7)).astype(np.uint8))
        return lambda q: ((bits[q >> 3] >> (q & 7)) & 1).astype(bool)

    def search(q):
        order = np.argsort(q)
        at = np.empty_like(q)
        at[order] = np.searchsorted(keys, q[order])
        return (at < keys.size) & (keys[np.minimum(at, max(keys.size - 1,
                                                             0))] == q)
    return search


def node2vec_walks(indptr: np.ndarray, indices: np.ndarray, num_walks: int,
                   walk_length: int, p: float = 1.0, q: float = 1.0,
                   seed: int = 0) -> np.ndarray:
    """Biased second-order walks (node2vec) by rejection sampling against
    ``max(1, 1/p, 1/q)``, at most 12 tries a step, then a uniform
    neighbour; the JAX walker's draws in its order. ``indices`` must be
    sorted within each row (scipy's CSR is)."""
    rng = np.random.default_rng(seed)
    N = indptr.shape[0] - 1
    starts = np.tile(np.arange(N), num_walks)
    W = starts.shape[0]
    walks = np.empty((W, walk_length), np.int64)
    walks[:, 0] = starts
    deg = np.diff(indptr)
    if walk_length == 1:
        return walks
    E = indices.shape[0]
    is_edge = edge_test(indptr, indices)
    d = deg[starts]
    off = (rng.random(W) * np.maximum(d, 1)).astype(np.int64)
    pos = np.minimum(indptr[starts] + np.minimum(off, np.maximum(d - 1, 0)),
                     max(E - 1, 0))
    cur = np.where(d > 0, indices[pos] if indices.size else starts, starts)
    walks[:, 1] = cur
    prev = starts.copy()
    inv_p, inv_q = 1.0 / p, 1.0 / q
    upper = max(1.0, inv_p, inv_q)
    for t in range(2, walk_length):
        d = deg[cur]
        nxt = cur.copy()
        todo = d > 0
        tries = 0
        while todo.any() and tries < 12:
            idxs = np.nonzero(todo)[0]
            off = (rng.random(idxs.shape[0]) * d[idxs]).astype(np.int64)
            cand = indices[indptr[cur[idxs]] + off]
            # back to prev → 1/p; a neighbour of prev → 1; else 1/q
            w = np.full(idxs.shape[0], inv_q)
            w[cand == prev[idxs]] = inv_p
            w[is_edge(prev[idxs] * N + cand) & (cand != prev[idxs])] = 1.0
            accept = rng.random(idxs.shape[0]) < (w / upper)
            acc_idx = idxs[accept]
            nxt[acc_idx] = cand[accept]
            todo[acc_idx] = False
            tries += 1
        left = np.nonzero(todo)[0]
        if left.size:
            dd = d[left]
            off = (rng.random(left.shape[0]) * np.maximum(dd, 1)).astype(
                np.int64)
            nxt[left] = indices[indptr[cur[left]]
                                + np.minimum(off, np.maximum(dd - 1, 0))]
        prev, cur = cur, nxt
        walks[:, t] = cur
    return walks


def walks_to_pairs(walks, window: int, max_pairs: Optional[int] = None,
                   draws: Optional[Draws] = None,
                   device=None) -> torch.Tensor:
    """``[P, 2]`` (center, context) pairs of the walks within ``window``
    on ``device``: each offset's forward then backward pairs, shuffled by
    ``draws.permutation`` and cut to the first ``max_pairs``."""
    w = torch.as_tensor(walks, device=device)
    L = w.shape[1]
    pieces = []
    for off in range(1, window + 1):
        if off >= L:
            break
        a, b = w[:, :-off].reshape(-1), w[:, off:].reshape(-1)
        pieces += [torch.stack([a, b], 1), torch.stack([b, a], 1)]
    P = torch.cat(pieces, 0)
    perm = draws.permutation(P.shape[0])
    if max_pairs is not None and P.shape[0] > max_pairs:
        perm = perm[:max_pairs]
    return P[perm]


def sgns_loss(emb_in: torch.Tensor, emb_out: torch.Tensor,
              centers: torch.Tensor, contexts: torch.Tensor,
              negatives: torch.Tensor, tie_context: bool) -> torch.Tensor:
    """The negative-sampling loss of one batch: ``−(mean log σ(c·ctx) +
    mean log σ(−c·neg))`` against the context table (the vertex table
    itself when ``tie_context``)."""
    ctx = emb_in if tie_context else emb_out
    c = emb_in[centers]
    pos = (c * ctx[contexts]).sum(-1)
    neg = torch.einsum("bd,bkd->bk", c, ctx[negatives])
    return -(F.logsigmoid(pos).mean() + F.logsigmoid(-neg).mean())


def train_sgns(pairs: torch.Tensor, num_nodes: int, dim: int = 128,
               num_negative: int = 5, batch_size: int = 65536,
               epochs: int = 2, lr: float = 0.025,
               draws: Optional[Draws] = None, tie_context: bool = False,
               stats: Optional[Dict] = None) -> torch.Tensor:
    """Skip-gram with negative sampling on ``pairs``' device: the vertex
    table from ``draws.normal / dim``, the context table zeros, Adam (eps
    1e-8) over both, ``n // B`` full batches an epoch from
    ``draws.permutation``, each with ``draws.integers`` negatives. Returns
    the vertex table; ``stats`` gets the step count."""
    device = pairs.device
    emb_in = (draws.normal((num_nodes, dim)) * (1.0 / dim)).float()
    emb_in = emb_in.to(device).requires_grad_()
    emb_out = torch.zeros(num_nodes, dim, device=device, requires_grad=True)
    opt = torch.optim.Adam([emb_in, emb_out], lr=lr, eps=1e-8)
    n = pairs.shape[0]
    # clamp so that every batch is a full one
    batch_size = min(batch_size, n)
    nb = max(n // batch_size, 1)
    steps = 0
    for _ in range(epochs):
        perm = draws.permutation(n).to(device)
        for b in range(nb):
            sl = perm[b * batch_size: (b + 1) * batch_size]
            if sl.shape[0] < batch_size:
                sl = torch.cat([sl, perm[: batch_size - sl.shape[0]]])
            batch = pairs[sl]
            negatives = draws.integers(0, num_nodes,
                                       (batch_size, num_negative)).to(device)
            opt.zero_grad(set_to_none=False)
            sgns_loss(emb_in, emb_out, batch[:, 0], batch[:, 1], negatives,
                      tie_context).backward()
            opt.step()
            steps += 1
    if stats is not None:
        stats["sgns_steps"] = stats.get("sgns_steps", 0) + steps
    return emb_in.detach()
