"""The port's heterogeneous and graph-level embeddings (metapath2vec, PTE,
hin2vec, GATNE, graph2vec, DGK), ``MultiplexEmbeddingWrapper``,
``GraphEmbeddingWrapper`` and the GATNE loader against the JAX package's,
on the CPU: a seeded 200-node ``hetero-sbm`` graph and 40 small graphs of
``random-graphs``.

Random draws: the port draws on the device from torch's generator; here
:class:`JaxDraws` (``tests/test_torch_emb.py``) replays the JAX package's
numpy and Threefry streams through the same methods, GATNE's projection
stage from numpy's ``normal`` as the JAX model draws it, and the JAX
uniform walks (its numpy branch, ``cogdl_tpu.native.available`` patched)
are injected, so each pair of runs sees the same draws. Tolerances:

* metapath2vec's walks and ``wl_features`` equal to the JAX ones;
* the SGNS and Adam tables (metapath2vec, PTE, hin2vec, GATNE) within
  ``1e-5 + 1e-4·max``;
* graph2vec and DGK elementwise within ``1e-4·max`` where consecutive
  singular values differ, and by singular values and subspace otherwise;
* the wrappers' scores, over the same embeddings, within 1e-12.
"""

import os

import numpy as np
import pytest
import torch

import cogdl_tpu.native as jnative
from cogdl_tpu.datasets import gatne_data as j_gatne_data
from cogdl_tpu.datasets.synthetic import hetero_sbm_graph as j_hetero
from cogdl_tpu.datasets.synthetic import random_graphs_dataset as j_graphs
from cogdl_tpu.models.emb import walks as jwalks
from cogdl_tpu.models.emb.dgk import DeepGraphKernel as JDGK
from cogdl_tpu.models.emb.gatne import GATNE as JGATNE
from cogdl_tpu.models.emb.graph2vec import Graph2Vec as JGraph2Vec
from cogdl_tpu.models.emb.graph2vec import wl_features as j_wl_features
from cogdl_tpu.models.emb.hin2vec import Hin2Vec as JHin2Vec
from cogdl_tpu.models.emb.metapath2vec import Metapath2Vec as JMetapath2Vec
from cogdl_tpu.models.emb.pte import PTE as JPTE
from cogdl_tpu.wrappers.heterogeneous import \
    GraphEmbeddingWrapper as JGraphEmbeddingWrapper
from cogdl_tpu.wrappers.heterogeneous import \
    MultiplexEmbeddingWrapper as JMultiplexEmbeddingWrapper
from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.data.graph import from_coo as t_from_coo
from cogdl_tpu_torch.datasets import gatne_data as t_gatne_data
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import hetero_sbm_graph as t_hetero
from cogdl_tpu_torch.datasets.synthetic import \
    random_graphs_dataset as t_graphs
from cogdl_tpu_torch.models import build_model
from cogdl_tpu_torch.models.emb import gatne as tgatne
from cogdl_tpu_torch.models.emb import hin2vec as thin2vec
from cogdl_tpu_torch.models.emb.graph2vec import wl_features
from cogdl_tpu_torch.wrappers.heterogeneous import (
    GraphEmbeddingWrapper,
    MultiplexEmbeddingWrapper,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)
from test_torch_emb import JaxDraws

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
NODES = 200
WALK_KW = {"walk_num": 2, "walk_length": 8, "window_size": 3,
           "hidden_size": 16}


class GatneDraws(JaxDraws):
    """The JAX package's draws, GATNE's projection from numpy's
    ``default_rng(seed).normal`` as the JAX model makes it."""

    def __init__(self, stage, seed, device):
        super().__init__(stage, seed, device)
        self.stage = stage

    def normal(self, shape):
        if self.stage == "proj":
            return self._t(self.rng.normal(size=shape).astype(np.float32))
        return super().normal(shape)


@pytest.fixture
def jax_numpy_branch(monkeypatch):
    """Send the JAX package's uniform walks down their numpy branch."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def hetero(**kw):
    return j_hetero(num_nodes=NODES, **kw), t_hetero(num_nodes=NODES, **kw)


def t_model(name, draws=JaxDraws, **kw):
    m = build_model(name, **kw)
    m.draws = draws
    return m


def _close(got, want, rel=1e-4, atol=0.0):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= atol + rel * np.abs(want).max()


def _svd_match(got, want, rel=1e-4):
    """``got`` against ``want`` column by column within ``rel·max|want|``
    where consecutive singular values (the columns' squared norms) differ
    by more than 1e-6 of the largest; a group of equal ones by its
    singular values and the projector onto its columns."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    vals = (want ** 2).sum(0)
    tie = np.abs(np.diff(vals)) <= 1e-6 * vals.max()
    scale = rel * np.abs(want).max()
    start = 0
    for j in range(want.shape[1]):
        if j + 1 < want.shape[1] and tie[j]:
            continue
        g, w = got[:, start: j + 1], want[:, start: j + 1]
        if j == start:
            assert np.abs(g - w).max() <= scale, j
        else:
            np.testing.assert_allclose((g ** 2).sum(0), (w ** 2).sum(0),
                                       rtol=rel)
            assert np.abs(g @ g.T - w @ w.T).max() <= rel * np.abs(
                w @ w.T).max(), (start, j)
        start = j + 1


# -- metapath2vec -------------------------------------------------------------

@pytest.mark.parametrize("schema", ["0-1-0", "1-2", "2-0-1-0"])
def test_metapath_walks_are_the_jax_walks(schema):
    jg, tg = hetero(num_types=3)
    kw = dict(WALK_KW, walk_length=12, schema=schema)
    want = JMetapath2Vec(seed=3, **kw).metapath_walks(jg)
    got = build_model("metapath2vec", seed=3, **kw).metapath_walks(tg)
    np.testing.assert_array_equal(got, want)


def test_metapath_walks_without_types_or_edges_are_the_jax_walks():
    """No ``node_type`` (every node of type 0) and isolated nodes, which
    stay put and draw nothing; a schema whose first type is absent starts
    from every node."""
    rng = np.random.default_rng(0)
    ei = rng.integers(0, 60, (2, 150))
    from cogdl_tpu.data.graph import from_coo as j_from_coo

    jg, tg = j_from_coo(ei, num_nodes=70), t_from_coo(ei, num_nodes=70)
    for schema in ("0-1", "1-0"):
        kw = dict(WALK_KW, schema=schema)
        np.testing.assert_array_equal(
            build_model("metapath2vec", seed=1, **kw).metapath_walks(tg),
            JMetapath2Vec(seed=1, **kw).metapath_walks(jg))


def test_metapath2vec_against_jax():
    jg, tg = hetero()
    want = JMetapath2Vec(seed=1, **WALK_KW).train_embeddings(jg)
    m = t_model("metapath2vec", seed=1, **WALK_KW)
    _close(m.train_embeddings(tg, CPU), want, atol=1e-5)
    assert m.stats["sgns_steps"] == 2 and "walks_s" in m.stats


# -- PTE ----------------------------------------------------------------------

def test_pte_against_jax():
    jg, tg = hetero()
    kw = {"hidden_size": 16, "num_samples": 6000, "iteration": 2}
    want = JPTE(seed=2, **kw).train_embeddings(jg)
    m = t_model("pte", seed=2, **kw)
    _close(m.train_embeddings(tg, CPU), want, atol=1e-5)
    assert m.stats["sgns_steps"] == 2


# -- hin2vec ------------------------------------------------------------------

@pytest.mark.usefixtures("jax_numpy_branch")
def test_hin2vec_against_jax(monkeypatch):
    jg, tg = hetero()
    kw = dict(WALK_KW, batch_size=512, epochs=2)
    jm = JHin2Vec(seed=4, **kw)
    want = jm.train_embeddings(jg)
    walks = jwalks.random_walks(*jwalks.build_csr(jg), kw["walk_num"],
                                kw["walk_length"], seed=4)
    monkeypatch.setattr(thin2vec, "random_walks", lambda *a, **k: walks)
    m = t_model("hin2vec", seed=4, **kw)
    _close(m.train_embeddings(tg, CPU), want, atol=1e-5)
    n = kw["walk_num"] * NODES * sum(kw["walk_length"] - o
                                     for o in range(1, 4))
    assert m.stats["adam_steps"] == 2 * (n // 512)


@pytest.mark.usefixtures("jax_numpy_branch")
def test_hin2vec_wrap_pads_a_short_last_batch(monkeypatch):
    """Fewer triples than a batch: one batch an epoch, padded from the
    permutation's start, as the JAX loop pads it."""
    jg, tg = hetero()
    kw = dict(WALK_KW, walk_length=3, window_size=1, batch_size=900,
              epochs=1)
    want = JHin2Vec(seed=5, **kw).train_embeddings(jg)
    walks = jwalks.random_walks(*jwalks.build_csr(jg), kw["walk_num"], 3,
                                seed=5)
    monkeypatch.setattr(thin2vec, "random_walks", lambda *a, **k: walks)
    m = t_model("hin2vec", seed=5, **kw)
    _close(m.train_embeddings(tg, CPU), want, atol=1e-5)
    assert m.stats["adam_steps"] == 1


# -- GATNE --------------------------------------------------------------------

@pytest.mark.usefixtures("jax_numpy_branch")
def test_gatne_against_jax(monkeypatch):
    """The base and the per-type skip-grams from the JAX walks of each
    graph (the per-type seeds ``seed + 1 + t``), and the projection."""
    jg, tg = hetero()
    kw = dict(WALK_KW, edge_dim=4, iteration=1)
    want = JGATNE(seed=2, **kw).train_embeddings(jg)
    seeds = []

    def jax_walks(indptr, indices, num_walks, walk_length, seed=0, **k):
        seeds.append(seed)
        return jwalks.random_walks(indptr, indices, num_walks, walk_length,
                                   seed=seed)

    monkeypatch.setattr(tgatne, "random_walks", jax_walks)
    m = t_model("gatne", draws=GatneDraws, seed=2, **kw)
    got = m.train_embeddings(tg, CPU)
    assert sorted(got) == sorted(want) == [0, 1]
    assert seeds == [2, 3, 4]
    for t in want:
        _close(got[t], want[t], atol=1e-5)
        assert got[t].shape == (NODES, 16)


# -- the multiplex wrapper ----------------------------------------------------

def _fixed_embeddings(calls, dim=8):
    """A model stand-in recording the graph it trains on and returning
    the same per-type embeddings in either package."""
    def train_embeddings(graph, device=None):
        calls.append(graph)
        rng = np.random.default_rng(graph.num_edges)
        embs = {t: rng.normal(size=(graph.num_nodes, dim)).astype(np.float32)
                for t in range(2)}
        if device is None:
            return embs
        return {t: torch.from_numpy(e).to(device) for t, e in embs.items()}
    return train_embeddings


def test_multiplex_wrapper_hold_out_matches_jax():
    """The random hold-out: the same train graph, the same negatives, the
    same per-type AUCs."""
    jg, tg = hetero()
    from cogdl_tpu.datasets.dataset import Dataset as JDataset

    wj = JMultiplexEmbeddingWrapper("gatne", JDataset.from_graph(jg),
                                    seed=3)
    wt = MultiplexEmbeddingWrapper("gatne", Dataset.from_graph(tg), seed=3)
    cj, ct = [], []
    wj.model.train_embeddings = _fixed_embeddings(cj)
    wt.model.train_embeddings = _fixed_embeddings(ct)
    want = wj.run_embedding()
    got = wt.run_embedding(CPU)
    (gj,), (gt,) = cj, ct
    assert (gt.num_nodes, gt.num_edges) == (gj.num_nodes, gj.num_edges)
    for f in ("row", "col", "edge_type"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)))
    assert set(want) <= set(got) and {"embed_s", "stats"} <= set(got)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12, k


def _write_gatne(root, nodes=60, seed=0):
    """train / valid / test files of two edge types over string ids, the
    valid and test lines half positives, half negatives; one type absent
    from valid."""
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(seed)
    ids = [f"n{i}" for i in rng.permutation(nodes)]
    with open(os.path.join(raw, "train.txt"), "w") as f:
        for _ in range(300):
            u, v = rng.choice(nodes, 2, replace=False)
            f.write(f"{rng.choice(['r', 'b'])} {ids[u]} {ids[v]}\n")
    for split, types in (("valid", ["r"]), ("test", ["r", "b"])):
        with open(os.path.join(raw, f"{split}.txt"), "w") as f:
            for i in range(40):
                u, v = rng.choice(nodes, 2, replace=False)
                f.write(f"{types[i % len(types)]} {ids[u]} {ids[v]} "
                        f"{i // len(types) % 2}\n")
    return root


def test_gatne_loader_matches_jax(tmp_path):
    root = _write_gatne(str(tmp_path / "amazon"))
    t, j = (t_gatne_data.build("amazon", root),
            j_gatne_data.build("amazon", root))
    assert t.metric == j.metric == "auc"
    gt, gj = t.graph, j.graph
    assert (gt.num_nodes, gt.num_edges) == (gj.num_nodes, gj.num_edges)
    for f in ("row", "col", "edge_type"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)))
    assert gt.meta_get("num_relations") == gj.meta_get("num_relations") == 2
    assert sorted(t.multiplex_eval) == sorted(j.multiplex_eval) == [0, 1]
    for ty, splits in j.multiplex_eval.items():
        for split, pairs in splits.items():
            for a, b in zip(t.multiplex_eval[ty][split], pairs):
                np.testing.assert_array_equal(a, b)
    assert t.multiplex_eval[1]["valid"][0].shape == (2, 0)


def test_gatne_loader_raises_the_jax_message(tmp_path):
    with pytest.raises(FileNotFoundError) as want:
        j_gatne_data.build("twitter", str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        t_gatne_data.build("twitter", str(tmp_path))
    assert str(got.value) == str(want.value)


def test_multiplex_wrapper_official_pairs_match_jax(tmp_path):
    root = _write_gatne(str(tmp_path / "youtube"))
    j = j_gatne_data.build("youtube", root)
    t = t_gatne_data.build("youtube", root)
    wj = JMultiplexEmbeddingWrapper("gatne", j, seed=0)
    wt = MultiplexEmbeddingWrapper("gatne", t, seed=0)
    cj, ct = [], []
    wj.model.train_embeddings = _fixed_embeddings(cj)
    wt.model.train_embeddings = _fixed_embeddings(ct)
    want, got = wj.run_embedding(), wt.run_embedding(CPU)
    assert ct[0] is t.graph
    assert {"auc_type0", "auc_type1"} <= set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12, k


def test_gatne_trains_through_experiment(tmp_path, monkeypatch):
    import cogdl_tpu_torch.datasets as tdatasets

    _write_gatne(str(tmp_path / "amazon"))
    monkeypatch.setattr(tdatasets, "DATA_ROOT", str(tmp_path))
    (res,) = experiment(dataset="amazon", model="gatne", seed=0,
                        device="cpu", walk_num=2, hidden_size=16,
                        edge_dim=4)[("amazon", "gatne")]
    assert 0.0 <= res["test_auc"] <= 1.0 and res["embed_s"] > 0
    assert res["stats"]["sgns_steps"] == 3 * 2


# -- graph2vec and DGK --------------------------------------------------------

def graphs(n=40, **kw):
    return j_graphs(num_graphs=n, **kw), t_graphs(num_graphs=n, **kw)


@pytest.mark.parametrize("feat", ["one-hot", "dense"])
def test_wl_features_are_the_jax_hashes(feat):
    """Over one-hot features (the argmax labels) and dense ones (the
    degree labels), every graph's hash list equals the JAX one."""
    (jgs, _), (tgs, _) = graphs(12, feat_dim=5)
    if feat == "one-hot":
        from cogdl_tpu.data.graph import from_coo as j_from_coo

        rng = np.random.default_rng(0)
        pairs = []
        for g in tgs:
            x = np.eye(5, dtype=np.float32)[rng.integers(0, 5, g.num_nodes)]
            ei = np.stack([g.row[:g.num_edges].numpy(),
                           g.col[:g.num_edges].numpy()])
            pairs.append((j_from_coo(ei, num_nodes=g.num_nodes, x=x),
                          t_from_coo(ei, num_nodes=g.num_nodes, x=x)))
    else:
        pairs = list(zip(jgs, tgs))
    for gj, gt in pairs:
        assert wl_features(gt, 3) == j_wl_features(gj, 3)


@pytest.mark.parametrize("name", ["graph2vec", "dgk"])
def test_graph_embeddings_against_jax(name):
    (jgs, _), (tgs, _) = graphs()
    kw = {"hidden_size": 16, "dim_buckets": 256}
    J = {"graph2vec": JGraph2Vec, "dgk": JDGK}[name]
    want = J(seed=1, **kw).train_graph_embeddings(jgs)
    m = build_model(name, seed=1, **kw)
    got = m.train_graph_embeddings(tgs, CPU)
    assert got.dtype == (torch.float64 if name == "graph2vec"
                         else torch.float32)
    _svd_match(got.numpy(), want)
    assert {"wl_s", "factorize_s"} <= set(m.stats)


def test_graph_wrapper_matches_jax():
    """Over the same embeddings, the 3-fold SVC's mean and spread, as
    scikit-learn's ``cross_val_score`` gives them."""
    (jgs, jl), (tgs, tl) = graphs(60)
    from cogdl_tpu.datasets.dataset import Dataset as JDataset

    emb = np.random.default_rng(0).normal(size=(60, 6))
    emb[:, 0] += np.asarray(tl) * 1.5
    wj = JGraphEmbeddingWrapper("graph2vec",
                                JDataset.from_graphs(jgs, labels=jl))
    wt = GraphEmbeddingWrapper("graph2vec",
                               Dataset.from_graphs(tgs, labels=tl))
    wj.model.train_graph_embeddings = lambda gs: emb
    wt.model.train_graph_embeddings = lambda gs, device: torch.from_numpy(
        emb).to(device)
    want, got = wj.run_embedding(), wt.run_embedding(CPU)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12, k
    assert got["svc_s"] >= 0 and got["embed_s"] >= 0


@pytest.mark.parametrize("name", ["graph2vec", "dgk"])
def test_graph_embedding_trains_through_experiment(name):
    from cogdl_tpu_torch.datasets import build_dataset

    ds = build_dataset("random-graphs", num_graphs=45)
    (res,) = experiment(dataset=ds, model=name, seed=0, device="cpu",
                        hidden_size=8)[(ds.name, name)]
    assert 0.0 <= res["test_acc"] <= 1.0 and res["acc_std"] >= 0.0


@pytest.mark.parametrize("name", ["metapath2vec", "pte", "hin2vec"])
def test_hetero_embeddings_train_through_network_embedding(name):
    """The ``network_embedding`` wrapper's logistic-regression branch: the
    hetero graph has one label a node and a split."""
    from cogdl_tpu_torch.datasets import build_dataset

    ds = build_dataset("hetero-sbm", num_nodes=150)
    kw = {"walk_num": 2, "walk_length": 6, "num_samples": 3000,
          "batch_size": 256}
    (res,) = experiment(dataset=ds, model=name, seed=0, device="cpu",
                        hidden_size=8, **kw)[(ds.name, name)]
    assert 0.0 <= res["test_acc"] <= 1.0 and res["probe_iters"] > 0


def test_default_wrappers_are_the_jax_packages():
    from cogdl_tpu.wrappers import DEFAULT_WRAPPER as JW
    from cogdl_tpu.wrappers import SUPPORTED_WRAPPERS as JS
    from cogdl_tpu_torch.wrappers import DEFAULT_WRAPPER, SUPPORTED_WRAPPERS

    for name in ("metapath2vec", "hin2vec", "pte", "gatne", "graph2vec",
                 "dgk", "gcc"):
        assert DEFAULT_WRAPPER[name] == JW[name], name
    for w in ("multiplex_embedding", "graph_embedding", "gcc"):
        assert SUPPORTED_WRAPPERS[w].rsplit(".", 1)[1] == \
            JS[w].rsplit(".", 1)[1]
    assert set(JS) - set(SUPPORTED_WRAPPERS) == {"distributed"}
