"""Shallow-embedding model base — the port of
``cogdl_tpu/models/emb/base.py``: ``graph_to_scipy``, the
``EmbeddingModel`` interface, ``train_embeddings(graph, device) ->
torch.Tensor [num_nodes, dim]`` on ``device``, and ``top_svd``.

:func:`top_svd` replays scikit-learn's ``TruncatedSVD(n_components=dim,
random_state=seed).fit_transform`` (``_randomized_svd``: five power
iterations normalised by LU, ten oversamples, ``transpose="auto"``, then
``svd_flip(u_based_decision=False)`` and ``M·Vᵀ``) without scikit-learn,
every product and factorisation in float64 on the device. Its starting
block is scikit-learn's own draw, ``RandomState(seed).normal`` on the host
(cast to float32 for a float32 input, as scikit-learn casts it). Only the
range each normaliser spans enters the result, so LAPACK's and the card's
pivots give the same embedding.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ...data.graph import Graph

# TruncatedSVD()'s n_iter and n_oversamples
SVD_ITERS = 5
SVD_OVERSAMPLES = 10


def graph_to_scipy(graph: Graph, directed: bool = False) -> sp.csr_matrix:
    """The real edges' weighted adjacency as a scipy CSR matrix on the host;
    symmetrised by the elementwise maximum unless ``directed``."""
    E, N = graph.num_edges, graph.num_nodes
    row = graph.row[:E].cpu().numpy()
    col = graph.col[:E].cpu().numpy()
    w = graph.edge_weight[:E].detach().cpu().numpy()
    A = sp.csr_matrix((w, (row, col)), shape=(N, N))
    if not directed:
        A = A.maximum(A.T)
    return A


def sparse_on(A: sp.spmatrix, device, dtype=torch.float64) -> torch.Tensor:
    """The scipy matrix ``A`` as a coalesced torch sparse COO tensor on
    ``device``."""
    A = A.tocoo()
    idx = torch.from_numpy(np.stack([A.row, A.col]).astype(np.int64))
    return torch.sparse_coo_tensor(
        idx, torch.from_numpy(A.data).to(dtype), A.shape,
        check_invariants=False).coalesce().to(device)


def dense_on(A: sp.spmatrix, device, dtype=torch.float64) -> torch.Tensor:
    """The scipy matrix ``A`` as a dense tensor on ``device``, built there
    from its entries."""
    A = A.tocoo()
    out = torch.zeros(A.shape, dtype=dtype, device=device)
    row = torch.from_numpy(A.row.astype(np.int64)).to(device)
    col = torch.from_numpy(A.col.astype(np.int64)).to(device)
    out.index_put_((row, col), torch.from_numpy(A.data).to(device, dtype),
                   accumulate=True)
    return out


class EmbeddingModel:
    """``train_embeddings(graph, device)`` returns the ``[num_nodes, dim]``
    embedding on ``device`` and leaves in ``stats`` the seconds each
    stage took (``<stage>_s``, the card synchronised at each stage's end)
    and the steps or products it ran. ``draws``
    makes each stage's random draws, ``draws(stage, seed)`` (a
    :class:`cogdl_tpu_torch.models.emb.walks.Draws` by default; the
    tests hand in replays of the JAX package's streams)."""

    def __init__(self, hidden_size: int = 128, seed: int = 0, **kw):
        self.hidden_size = hidden_size
        self.seed = seed
        self.draws = None
        self.stats: Dict[str, float] = {}

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        raise NotImplementedError

    def make_draws(self, stage: str, seed: int, device):
        from .walks import Draws

        return (self.draws or Draws)(stage, seed, device)

    @contextmanager
    def stage(self, name: str, device):
        """Time one stage into ``stats[name + "_s"]`` (added up over
        calls)."""
        t0 = time.perf_counter()
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        key = f"{name}_s"
        self.stats[key] = self.stats.get(key, 0.0) + (
            time.perf_counter() - t0)


def _operands(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A, Aᵀ)``: ``M`` in float64, dense or (from a sparse COO ``M``)
    sparse CSR, and its transpose in the same form."""
    A = M.to(torch.float64)
    if not A.is_sparse:
        return A, A.T
    A = A.coalesce()
    return A.to_sparse_csr(), A.t().coalesce().to_sparse_csr()


def lu_basis(X: torch.Tensor) -> torch.Tensor:
    """``P·L`` of the partially pivoted LU ``X = P·L·U`` of a tall ``X``:
    a well-conditioned basis of ``X``'s range (scipy's ``lu(X,
    permute_l=True)[0]``, pivots as the device picks them; a zero pivot
    of a rank-deficient ``X`` raises no more than LAPACK's does)."""
    LU, piv, _ = torch.linalg.lu_factor_ex(X)
    k = X.shape[1]
    L = torch.tril(LU, -1)
    L[:k].diagonal().fill_(1.0)
    perm = np.arange(X.shape[0])
    for i, p in enumerate(piv.cpu().numpy() - 1):
        perm[[i, p]] = perm[[p, i]]
    PL = torch.empty_like(L)
    PL[torch.from_numpy(perm).to(X.device)] = L
    return PL


def top_svd(M: torch.Tensor, dim: int, seed: int = 0) -> torch.Tensor:
    """Randomized truncated SVD embedding ``U·√Σ`` (NetMF, NetSMF, ProNE,
    GraRep): scikit-learn's ``TruncatedSVD(dim, random_state=seed)`` output
    divided by the square roots of its singular values (at least 1e-12).
    ``M`` is a dense tensor or a sparse COO one, which stays sparse
    (torch's CSR products). Returns ``[M.shape[0], dim]`` on ``M``'s
    device, float32 for a float32 ``M``, float64 otherwise."""
    device = M.device
    n_samples, n_features = M.shape
    if n_features < 2:
        raise ValueError(f"top_svd needs at least 2 columns, got "
                         f"{n_features}")
    if dim > n_features:
        raise ValueError(f"n_components({dim}) must be <= n_features("
                         f"{n_features}).")
    A0, A0t = _operands(M)
    single = M.dtype == torch.float32
    transpose = n_samples < n_features
    A, At = (A0t, A0) if transpose else (A0, A0t)
    size = dim + SVD_OVERSAMPLES
    Q = np.random.RandomState(seed).normal(size=(A.shape[1], size))
    if single:
        Q = Q.astype(np.float32)
    Q = torch.from_numpy(Q).to(device, torch.float64)
    for _ in range(SVD_ITERS):
        Q = lu_basis(A @ Q)
        Q = lu_basis(At @ Q)
    Q, _ = torch.linalg.qr(A @ Q)
    B = (At @ Q).T                      # Qᵀ·A, [size, n_features]
    Uhat, s, Vt = torch.linalg.svd(B, full_matrices=False)
    if transpose:                       # back to M's own orientation
        s, Vt = s[:dim], (Q @ Uhat)[:, :dim].T
    else:
        s, Vt = s[:dim], Vt[:dim]
    # svd_flip(u_based_decision=False): each row of Vᵀ's largest entry
    # (the first of equals) positive
    big = Vt.gather(1, Vt.abs().argmax(1, keepdim=True))
    Vt = Vt * torch.sign(big)
    X = A0 @ Vt.T
    out = X / torch.sqrt(s.clamp_min(1e-12))
    return out.float() if single else out

