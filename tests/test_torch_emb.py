"""The port's homogeneous network embeddings against the JAX package's, on
the CPU, on a seeded 200-node graph of ``chip_smoke.embedding_network``.

Random draws: the port draws on the device from torch's generator; here a
:class:`JaxDraws` replays the JAX package's numpy and Threefry streams
through the same methods, and the JAX uniform walks (its numpy branch,
``cogdl_tpu.native.available`` patched) are injected, so each pair of
runs sees the same draws. Tolerances:

* ``top_svd`` against scikit-learn's ``TruncatedSVD`` (the JAX
  ``top_svd``): float64 inputs elementwise within ``1e-6·max``;
  float32 inputs, which scikit-learn computes in float32, within
  ``1e-4·max``; a repeated singular value by the column norms (the
  singular values) and ``X·Xᵀ``.
* ``node2vec_walks`` and ``walks_to_pairs`` equal to the JAX ones.
* SGNS tables after a few steps, DeepWalk, node2vec and LINE within
  ``1e-5 + 1e-4·max``.
* The deterministic models (NetMF, NetSMF, ProNE, ProNE++, GraRep, SDNE,
  DNGR) within ``1e-4·max``: K1 and the port's float64 products against
  the JAX package's float32 / float64 mix.
* ARPACK starts from a random vector, so Spectral is held by its
  eigenvalues and its vectors up to sign, HOPE by its singular values and
  ``src·dstᵀ``, NetMF's large path by its filtered spectrum and ``U·Uᵀ``.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke as cs
import cogdl_tpu.native as jnative
from cogdl_tpu.data.graph import from_coo as j_from_coo
from cogdl_tpu.models.emb import base as jbase
from cogdl_tpu.models.emb import walks as jwalks
from cogdl_tpu.models.emb.deepwalk import DeepWalk as JDeepWalk
from cogdl_tpu.models.emb.dngr import DNGR as JDNGR
from cogdl_tpu.models.emb.grarep import GraRep as JGraRep
from cogdl_tpu.models.emb.hope import HOPE as JHOPE
from cogdl_tpu.models.emb.line import LINE as JLINE
from cogdl_tpu.models.emb.netmf import NetMF as JNetMF
from cogdl_tpu.models.emb.netsmf import NetSMF as JNetSMF
from cogdl_tpu.models.emb.node2vec import Node2Vec as JNode2Vec
from cogdl_tpu.models.emb.prone import ProNE as JProNE
from cogdl_tpu.models.emb.prone_pp import ProNEpp as JProNEpp
from cogdl_tpu.models.emb.sdne import SDNE as JSDNE
from cogdl_tpu.models.emb.sdne import _AE as JAE
from cogdl_tpu.models.emb.spectral import Spectral as JSpectral
from cogdl_tpu_torch.data.graph import from_coo as t_from_coo
from cogdl_tpu_torch.models import build_model
from cogdl_tpu_torch.models.emb import base as tbase
from cogdl_tpu_torch.models.emb import deepwalk as tdeepwalk
from cogdl_tpu_torch.models.emb import walks as twalks
from cogdl_tpu_torch.models.emb.prone import propagation_graphs
from cogdl_tpu_torch.models.emb.sdne import AE
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
WALK_KW = {"walk_num": 2, "walk_length": 8, "window_size": 3,
           "iteration": 2, "hidden_size": 16}


class JaxDraws:
    """The JAX package's draws of one stage, through the port's
    :class:`~cogdl_tpu_torch.models.emb.walks.Draws` methods: numpy's
    ``default_rng(seed)`` stream, ``jax.random.normal(PRNGKey(seed))``
    for a table, and a ``PRNGKey(seed)`` split once a call for Bernoulli
    masks (DNGR's epochs)."""

    def __init__(self, stage, seed, device):
        self.rng = np.random.default_rng(seed)
        self.key = jax.random.PRNGKey(seed)
        self.device = torch.device(device)

    def _t(self, a):
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def permutation(self, n):
        return self._t(self.rng.permutation(n))

    def integers(self, low, high, shape):
        return self._t(self.rng.integers(low, high, shape))

    def random(self, shape):
        return self._t(self.rng.random(shape))

    def normal(self, shape):
        return self._t(jax.random.normal(self.key, shape))

    def choice(self, p, size):
        p = p.cpu().numpy()
        return self._t(self.rng.choice(p.shape[0], size=size, p=p))

    def bernoulli(self, p, shape):
        self.key, k = jax.random.split(self.key)
        return self._t(jax.random.bernoulli(k, p, shape))


def network(n=200, e=1600, labels=8, seed=0, isolated=0):
    """The JAX and the port's graph of one seeded network (``isolated``
    nodes without an edge appended), and its label matrix."""
    A, groups = cs.embedding_network(n, e, labels, seed)
    A = A.tocoo()
    ei = np.stack([A.row, A.col])
    w = A.data.astype(np.float32)
    N = n + isolated
    return (j_from_coo(ei, num_nodes=N, edge_weight=w),
            t_from_coo(ei, num_nodes=N, edge_weight=w), groups)


def scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def t_model(name, **kw):
    m = build_model(name, **kw)
    m.draws = JaxDraws
    return m


# -- top_svd ------------------------------------------------------------------

def _tensor(M):
    """The port's input: a dense tensor, or a sparse COO one of a scipy
    matrix in its dtype."""
    if sp.issparse(M):
        return tbase.sparse_on(M, CPU, torch.from_numpy(M.data).dtype)
    return torch.from_numpy(M)


def _matrix(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind.startswith("sparse"):
        M = sp.random(*shape, density=0.08, random_state=seed, format="csr",
                      data_rvs=lambda k: rng.random(k) + 0.5)
        return M.astype(np.float32) if kind.endswith("32") else M
    X = rng.normal(size=shape) * np.exp(-np.arange(shape[1]) / 15)[None, :]
    return X.astype(np.float32) if kind.endswith("32") else X


@pytest.mark.parametrize("shape", [(200, 200), (150, 220), (220, 150)])
@pytest.mark.parametrize("kind", ["dense64", "dense32", "sparse64",
                                  "sparse32"])
def test_top_svd_matches_scikit_learn(kind, shape):
    from sklearn.decomposition import TruncatedSVD

    M = _matrix(kind, shape)
    dim, seed = 16, 3
    want = jbase.top_svd(M, dim, seed)
    got = tbase.top_svd(_tensor(M), dim, seed)
    assert got.dtype == (torch.float32 if want.dtype == np.float32
                         else torch.float64)
    s = TruncatedSVD(dim, random_state=seed).fit(M).singular_values_
    assert (np.abs(np.diff(s)) / s[:-1]).min() > 1e-6
    tol = 1e-4 if kind.endswith("32") else 1e-6
    assert scaled(got.numpy(), want) < tol


def test_top_svd_on_a_repeated_singular_value():
    """Two equal singular values: the embedding's columns of that pair
    are any rotation, so compare the singular values (the squared column
    norms) and ``X·Xᵀ``."""
    rng = np.random.default_rng(1)
    U, _ = np.linalg.qr(rng.normal(size=(120, 120)))
    V, _ = np.linalg.qr(rng.normal(size=(90, 90)))
    s = np.exp(-np.arange(90) / 10.0)
    s[3] = s[2]
    M = (U[:, :90] * s) @ V.T
    want = jbase.top_svd(M, 8, 0)
    got = tbase.top_svd(_tensor(M), 8, 0).numpy()
    assert scaled((got ** 2).sum(0), (want ** 2).sum(0)) < 1e-9
    assert scaled(got @ got.T, want @ want.T) < 1e-9


def test_top_svd_refuses_more_components_than_columns():
    M = _tensor(_matrix("sparse64", (150, 220)))
    with pytest.raises(ValueError, match="n_components"):
        tbase.top_svd(M, 300, 0)
    with pytest.raises(ValueError, match="at least 2 columns"):
        tbase.top_svd(M.to_dense()[:, :1], 1, 0)


# -- walks, pairs, SGNS -------------------------------------------------------

@pytest.mark.parametrize("bitmap", [True, False])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.25, 4.0), (4.0, 0.25)])
def test_node2vec_walks_are_the_jax_walks(p, q, bitmap, monkeypatch):
    """Both neighbour tests: the bitmap and, past its size, the sorted
    search."""
    if not bitmap:
        monkeypatch.setattr(twalks, "BITMAP_NODES", 0)
    jg, tg, _ = network(isolated=3)
    indptr, indices = jwalks.build_csr(jg)
    t_ptr, t_idx = twalks.build_csr(tg)
    assert np.array_equal(indptr, t_ptr) and np.array_equal(indices, t_idx)
    want = jwalks.node2vec_walks(indptr, indices, 3, 12, p=p, q=q, seed=5)
    got = twalks.node2vec_walks(t_ptr, t_idx, 3, 12, p=p, q=q, seed=5)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_random_walks_step_along_edges():
    """The C++ walker's walks: every start ``num_walks`` times, each step
    to a neighbour, an isolated node staying put."""
    _, tg, _ = network(isolated=2)
    indptr, indices = twalks.build_csr(tg)
    walks = twalks.random_walks(indptr, indices, 2, 9, seed=1, num_threads=2)
    N = indptr.shape[0] - 1
    assert walks.shape == (2 * N, 9)
    assert np.array_equal(walks[:, 0], np.tile(np.arange(N), 2))
    A = sp.csr_matrix((np.ones(indices.size), indices, indptr), (N, N))
    a, b = walks[:, :-1].ravel(), walks[:, 1:].ravel()
    deg = np.diff(indptr)
    assert np.all(np.where(deg[a] > 0, np.asarray(A[a, b]).ravel() > 0,
                           a == b))


def test_walks_to_pairs_are_the_jax_pairs():
    jg, _, _ = network()
    indptr, indices = jwalks.build_csr(jg)
    walks = jwalks.node2vec_walks(indptr, indices, 2, 6, seed=0)
    for window, cap in ((3, None), (5, 1000), (8, 50)):
        want = jwalks.walks_to_pairs(walks, window, seed=4, max_pairs=cap)
        got = twalks.walks_to_pairs(walks, window, max_pairs=cap,
                                    draws=JaxDraws("pairs", 4, CPU),
                                    device=CPU)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("tie", [False, True])
def test_train_sgns_against_the_jax_steps(tie):
    """Three epochs of three batches (and a batch cut to the pairs when
    it is larger than all of them)."""
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, 60, (700, 2))
    for batch in (200, 4096):
        want = jwalks.train_sgns(pairs, 60, dim=8, num_negative=3,
                                 batch_size=batch, epochs=3, seed=2,
                                 tie_context=tie)
        stats = {}
        got = twalks.train_sgns(torch.from_numpy(pairs), 60, dim=8,
                                num_negative=3, batch_size=batch, epochs=3,
                                draws=JaxDraws("sgns", 2, CPU),
                                tie_context=tie, stats=stats)
        assert stats["sgns_steps"] == 3 * max(700 // min(batch, 700), 1)
        assert np.abs(got.numpy() - want).max() <= 1e-5 + 1e-4 * np.abs(
            want).max()


# -- the models ----------------------------------------------------------------

def _close(got, want, rel=1e-4, atol=0.0):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= atol + rel * np.abs(want).max()


def test_deepwalk_against_jax(monkeypatch):
    jg, tg, _ = network()
    monkeypatch.setattr(jnative, "available", lambda: False)
    jm = JDeepWalk(seed=1, **WALK_KW)
    walks = jm._walks(jg)
    want = jm.train_embeddings(jg)
    monkeypatch.setattr(tdeepwalk, "random_walks",
                        lambda *a, **k: walks)
    m = t_model("deepwalk", seed=1, **WALK_KW)
    _close(m.train_embeddings(tg, CPU), want, atol=1e-5)
    assert m.stats["sgns_steps"] == WALK_KW["iteration"]


def test_node2vec_against_jax():
    jg, tg, _ = network()
    kw = dict(WALK_KW, p=0.25, q=4.0)
    want = JNode2Vec(seed=2, **kw).train_embeddings(jg)
    got = t_model("node2vec", seed=2, **kw).train_embeddings(tg, CPU)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_line_against_jax(order):
    jg, tg, _ = network()
    kw = {"hidden_size": 16, "order": order, "num_samples": 3000,
          "iteration": 2}
    want = JLINE(seed=3, **kw).train_embeddings(jg)
    got = t_model("line", seed=3, **kw).train_embeddings(tg, CPU)
    _close(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="order"):
        t_model("line", order=4).train_embeddings(tg, CPU)


def test_netmf_against_jax():
    jg, tg, _ = network()
    want = JNetMF(hidden_size=16, seed=1).train_embeddings(jg)
    got = t_model("netmf", hidden_size=16, seed=1).train_embeddings(tg, CPU)
    _close(got, want)


def test_netmf_large_path_by_its_spectrum_and_gram():
    """ARPACK's random start: the eigenpairs agree up to signs, so the
    filtered spectrum and ``U·Uᵀ`` (the matrix factorised) agree, and
    so does the embedding of ``log⁺ (vol/b)·U·Uᵀ``."""
    jg, tg, _ = network()
    want = JNetMF(hidden_size=16, is_large=True, rank=24,
                  seed=1).train_embeddings(jg)
    m = t_model("netmf", hidden_size=16, is_large=True, rank=24, seed=1)
    got = m.train_embeddings(tg, CPU)
    _close(got, want, rel=1e-3)
    _close(got @ got.T, want @ want.T, rel=1e-4)


def test_netsmf_against_jax():
    jg, tg, _ = network()
    kw = {"hidden_size": 16, "num_rounds": 6, "window_size": 4}
    want = JNetSMF(seed=4, **kw).train_embeddings(jg)
    got = t_model("netsmf", seed=4, **kw).train_embeddings(tg, CPU)
    _close(got, want)


def test_prone_against_jax_and_its_launch_cases():
    jg, tg, _ = network()
    want = JProNE(hidden_size=16, seed=1).train_embeddings(jg)
    sk.reset_launch_counts()
    got = t_model("prone", hidden_size=16, seed=1).train_embeddings(tg, CPU)
    _close(got, want)
    # the CPU tensors take K1's plain version: no launch
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)


def test_prone_propagation_graphs_are_da_and_a():
    """The structure K1 reads, once with D⁻¹A's weights, once (live) with
    A's: both products equal scipy's."""
    jg, tg, _ = network()
    A = jbase.graph_to_scipy(jg).astype(np.float64)
    da, a = propagation_graphs(tbase.graph_to_scipy(tg), CPU)
    x = np.random.default_rng(0).normal(size=(A.shape[0], 5))
    xp = torch.zeros(da.n_pad, 5)
    xp[: A.shape[0]] = torch.from_numpy(x)
    from cogdl_tpu_torch.ops.spmm import spmm

    deg = np.asarray(A.sum(1)).ravel()
    _close(spmm(da, xp)[: A.shape[0]].double(), (A @ x) / deg[:, None],
           rel=1e-6)
    _close(spmm(a, xp)[: A.shape[0]].double(), A @ x, rel=1e-6)


def test_prone_pp_against_jax():
    """The multi-label graph's ``-var`` proxy and, over ``sbm``'s one
    label a node, the 3-fold logistic regression: the chosen embedding
    and, for the proxy, every score."""
    from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
    from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm

    jg, tg, groups = network()
    dense = np.asarray(groups.todense(), np.float32)
    jg = jg.replace(y=np.concatenate([dense, np.zeros(
        (jg.n_pad - dense.shape[0], dense.shape[1]), np.float32)]))
    tg = tg.replace(y=torch.from_numpy(np.asarray(jg.y)))
    want = JProNEpp(hidden_size=16, max_evals=3, seed=2).train_embeddings(jg)
    m = t_model("prone++", hidden_size=16, max_evals=3, seed=2)
    _close(m.train_embeddings(tg, CPU), want)
    for jgraph, tgraph in ((j_sbm(num_nodes=200), t_sbm(num_nodes=200)),):
        want = JProNEpp(hidden_size=16, max_evals=3,
                        seed=0).train_embeddings(jgraph)
        got = t_model("prone++", hidden_size=16, max_evals=3,
                      seed=0).train_embeddings(tgraph, CPU)
        _close(got, want)


def test_hope_by_its_singular_values_and_products():
    jg, tg, _ = network()
    want = JHOPE(hidden_size=16, seed=0).train_embeddings(jg)
    got = t_model("hope", hidden_size=16).train_embeddings(tg, CPU).numpy()
    assert got.dtype == np.float32
    h = 8
    # the singular values are the columns' squared norms, in svds' order
    _close((got[:, :h] ** 2).sum(0), (want[:, :h] ** 2).sum(0), rel=1e-4)
    _close(got[:, :h] @ got[:, h:].T, want[:, :h] @ want[:, h:].T, rel=1e-4)


def test_grarep_against_jax():
    jg, tg, _ = network()
    want = JGraRep(hidden_size=32, step=3, seed=1).train_embeddings(jg)
    got = t_model("grarep", hidden_size=32, step=3, seed=1).train_embeddings(
        tg, CPU)
    _close(got, want)


def test_spectral_by_eigenvalues_and_vectors_up_to_sign():
    jg, tg, _ = network()
    want = JSpectral(hidden_size=12).train_embeddings(jg)
    m = t_model("spectral", hidden_size=12)
    got = m.train_embeddings(tg, CPU).numpy()
    A = jbase.graph_to_scipy(jg).astype(np.float64)
    dn = 1.0 / np.sqrt(np.asarray(A.sum(1)).ravel())
    L = np.eye(A.shape[0]) - dn[:, None] * A.toarray() * dn[None, :]
    lam = np.diag(want.T.astype(np.float64) @ L @ want.astype(np.float64))
    _close(m.eigenvalues.numpy(), lam, rel=1e-5)
    assert np.all(np.diff(m.eigenvalues.numpy()) > 1e-6)
    signs = np.sign((got * want).sum(0))
    _close(got * signs[None, :], want, rel=1e-4)


def _ae_params(n, hidden, emb, seed):
    import jax.numpy as jnp

    return JAE(hidden, emb).init(jax.random.PRNGKey(seed),
                                 jnp.zeros((2, n)))["params"]


def test_sdne_against_jax():
    jg, tg, _ = network()
    kw = {"hidden_size": 16, "enc_hidden": 32, "epochs": 30}
    want = JSDNE(seed=1, **kw).train_embeddings(jg)
    m = t_model("sdne", seed=1, **kw)
    m.initial_params = _ae_params(200, 32, 16, 1)
    _close(m.train_embeddings(tg, CPU), want)
    # the port's own draw: flax's LeCun-normal scale
    ae = AE(400, 64, 16)
    ae.reset_parameters(torch.Generator().manual_seed(0))
    std = float(ae.enc1.weight.std())
    assert 0.8 / 20 < std < 1.2 / 20 and float(ae.enc1.bias.abs().max()) == 0


def test_dngr_against_jax():
    jg, tg, _ = network()
    kw = {"hidden_size": 16, "enc_hidden": 32, "epochs": 30}
    jm = JDNGR(seed=2, **kw)
    _close(t_model("dngr", seed=2, **kw).ppmi(tg, CPU), jm._ppmi(jg),
           rel=1e-6)
    want = jm.train_embeddings(jg)
    m = t_model("dngr", seed=2, **kw)
    m.initial_params = _ae_params(200, 32, 16, 2)
    _close(m.train_embeddings(tg, CPU), want)
