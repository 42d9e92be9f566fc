"""The port's embedding probes without scikit-learn, held against
scikit-learn on the CPU, and the host library's ``random_walk``.

* ``utils/probe.logreg_fit`` minimises ``LogisticRegression()``'s
  objective: its coefficients and intercepts within 1e-3 (relative to the
  largest) of scikit-learn's solution of the same objective converged
  (``tol=1e-10``); against the default call (``max_iter=500``, which stops
  at its own ``tol=1e-4``) its objective is no higher and each split's
  accuracy within one sample; ``logreg_probe`` against the JAX package's.
* ``utils/svm``: ``stratified_kfold`` equal to ``StratifiedKFold(3)``'s
  folds; ``SVC`` decision values within ``1e-2·max|f|`` of
  ``SVC.decision_function``; each fold's accuracy within two samples of
  ``cross_val_score(SVC(), X, y, cv=3)``'s and their mean too.
* ``native.random_walk`` at 1, 3 and 8 threads equal to its numpy replay.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import StratifiedKFold, cross_val_score
from sklearn.svm import SVC as SKSVC

import cogdl_tpu.data.graph as jg
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.utils.probe import logreg_probe as j_logreg_probe
from cogdl_tpu_torch import native
from cogdl_tpu_torch.data.graph import add_self_loops
from cogdl_tpu_torch.data.sampling import graph_csr
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.utils import probe
from cogdl_tpu_torch.utils.svm import (
    SVC,
    cross_val_accuracy,
    stratified_kfold,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def blobs(K, n, F, sep, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, K, n)
    X = rng.normal(size=(K, F))[y] * sep + rng.normal(size=(n, F))
    return (X - X.mean(0)) / X.std(0), y


LOGREG_DATA = [(2, 200, 8, 1.0), (4, 300, 16, 1.0), (3, 500, 32, 0.3),
               (47, 2000, 64, 0.0)]


@pytest.mark.parametrize("K,n,F,sep", LOGREG_DATA)
def test_logreg_solves_sklearns_objective(K, n, F, sep):
    X, y = blobs(K, n, F, sep)
    sk = LogisticRegression(max_iter=500, tol=1e-10).fit(X, y)
    clf = probe.logreg_fit(torch.from_numpy(X), torch.from_numpy(y))
    assert clf.grad_max <= probe.TOL and 0 < clf.n_iter < probe.MAX_ITER
    scale = np.abs(sk.coef_).max()
    np.testing.assert_allclose(clf.coef.numpy(), sk.coef_, rtol=0,
                               atol=1e-3 * scale)
    np.testing.assert_allclose(clf.intercept.numpy(), sk.intercept_,
                               rtol=0, atol=1e-3 * scale)
    np.testing.assert_array_equal(clf.predict(torch.from_numpy(X)).numpy(),
                                  sk.predict(X))


@pytest.mark.parametrize("K,n,F,sep", LOGREG_DATA)
def test_logreg_against_the_default_call(K, n, F, sep):
    """``LogisticRegression(max_iter=500)`` as the JAX probe calls it: the
    port's objective at most scikit-learn's, and each split's accuracy
    within one sample."""
    X, y = blobs(K, n, F, sep)
    half = n // 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = LogisticRegression(max_iter=500).fit(X[:half], y[:half])
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    clf = probe.logreg_fit(Xt[:half], yt[:half])
    objective = probe.Objective(Xt[:half], yt[:half])

    def at(coef, intercept):
        return float(objective(torch.cat([coef.T, intercept[None]])))

    assert at(clf.coef, clf.intercept) <= at(
        torch.from_numpy(sk.coef_), torch.from_numpy(sk.intercept_)) + 1e-12
    for sl in (slice(0, half), slice(half, n)):
        ours = (clf.predict(Xt[sl]).numpy() == y[sl]).mean()
        theirs = sk.score(X[sl], y[sl])
        assert abs(ours - theirs) <= 1.0 / (sl.stop - sl.start) + 1e-12


def test_logreg_warns_when_it_stops_short():
    X, y = blobs(4, 300, 16, 1.0)
    with pytest.warns(RuntimeWarning, match="not converged"):
        clf = probe.logreg_fit(torch.from_numpy(X), torch.from_numpy(y),
                               max_iter=2)
    assert 0 < clf.n_iter <= probe.CHECK_EVERY
    with pytest.raises(ValueError, match="two classes"):
        probe.logreg_fit(torch.from_numpy(X), torch.zeros(300))


def test_logreg_probe_matches_the_jax_probe():
    """The same embeddings (the padded array, pad rows standardised with
    the rest as the JAX probe does) give each split's accuracy within one
    node of the JAX package's ``logreg_probe``."""
    gj = jg.add_self_loops(j_sbm(num_nodes=300, feat_dim=12, seed=3))
    gt = add_self_loops(t_sbm(num_nodes=300, feat_dim=12, seed=3))
    rng = np.random.default_rng(0)
    emb = (np.asarray(gj.x) @ rng.normal(size=(12, 24))
           + rng.normal(size=(gj.x.shape[0], 24))).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_logreg_probe(emb, gj)
    got = probe.logreg_probe(torch.from_numpy(emb), gt)
    for split in ("train", "val", "test"):
        n = int((np.asarray(getattr(gj, f"{split}_mask"))
                 & np.asarray(gj.node_mask())).sum())
        assert abs(got[f"{split}_acc"] - want[f"{split}_acc"]) <= 1.0 / n
    assert got["probe_iters"] > 0 and got["probe_ms"] > 0


LABELS = [np.random.default_rng(0).integers(0, 2, 50),
          np.random.default_rng(1).integers(0, 3, 61),
          np.array([2] * 10 + [0] * 3 + [1] * 7 + [2] * 5),
          np.random.default_rng(2).choice([5, 1, 9], 100, p=[.7, .2, .1]),
          np.array([1, 0] * 20 + [0] * 7)]


@pytest.mark.parametrize("i", range(len(LABELS)))
def test_folds_equal_stratified_kfold(i):
    y = LABELS[i]
    want = np.empty(len(y), int)
    for k, (_, test) in enumerate(StratifiedKFold(3).split(np.zeros(len(y)),
                                                           y)):
        want[test] = k
    np.testing.assert_array_equal(stratified_kfold(y, 3), want)


def test_folds_raise_when_every_class_is_too_small():
    with pytest.raises(ValueError):
        stratified_kfold(np.array([0, 1, 2, 0, 1, 2]), 3)


@pytest.mark.parametrize("K,n,F", [(2, 300, 8), (3, 400, 16), (2, 600, 96)])
def test_svc_matches_sklearn(K, n, F):
    """Decision values (one-vs-one for three classes) within
    ``1e-2·max|f|``; the predictions and, under three folds, each fold's
    accuracy within two samples, the mean too."""
    rng = np.random.default_rng(K + n)
    y = rng.integers(0, K, n)
    X = rng.normal(size=(K, F))[y] * 0.7 + rng.normal(size=(n, F))
    sk = SKSVC(decision_function_shape="ovo").fit(X, y)
    me = SVC().fit(X, y)
    want = sk.decision_function(X)
    got = me.decision_function(X)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    assert (me.predict(X) != sk.predict(X)).sum() <= 2
    ours = cross_val_accuracy(X, y, cv=3)
    theirs = cross_val_score(SKSVC(), X, y, cv=3)
    fold = np.bincount(stratified_kfold(y, 3))
    assert np.all(np.abs(ours - theirs) <= 2.0 / fold + 1e-12)
    assert abs(ours.mean() - theirs.mean()) <= 2.0 / fold.min() + 1e-12


def test_infograph_probe_matches_the_jax_evaluation():
    """``InfoGraphWrapper.evaluate`` from the JAX variables against the JAX
    wrapper's (scikit-learn's SVC under ``cross_val_score``)."""
    from cogdl_tpu.datasets import build_dataset as j_build_dataset
    from cogdl_tpu.models import build_model as j_build_model
    from cogdl_tpu.wrappers.graph_classification import (
        InfoGraphWrapper as JInfoGraphWrapper,
    )
    from cogdl_tpu_torch.datasets import build_dataset
    from cogdl_tpu_torch.models import build_model, load_jax_params
    from cogdl_tpu_torch.wrappers.graph_classification import (
        InfoGraphWrapper,
    )

    jd = j_build_dataset("random-graphs", num_graphs=60)
    td = build_dataset("random-graphs", num_graphs=60)
    kw = dict(in_features=jd.num_features, out_features=2, hidden_size=8)
    wj = JInfoGraphWrapper(j_build_model("infograph", **kw), jd,
                           batch_size=16)
    v = jax.tree.map(np.asarray, wj.init(jax.random.PRNGKey(0)))
    wt = InfoGraphWrapper(build_model("infograph", **kw), td, batch_size=16)
    wt.to_device("cpu")
    load_jax_params(wt.model, v["params"], v["batch_stats"])
    want = wj.evaluate(v)
    got = wt.evaluate()
    fold = np.bincount(stratified_kfold(td.labels, 3)).min()
    assert abs(got["test_acc"] - want["test_acc"]) <= 2.0 / fold
    assert got["val_acc"] == got["test_acc"] and got["probe_ms"] > 0


# -- random_walk -----------------------------------------------------------------

def _csr(num_nodes=300, seed=5):
    g = add_self_loops(t_sbm(num_nodes=num_nodes, feat_dim=4, seed=seed))
    indptr, indices, _ = graph_csr(g)
    # the last 20 nodes lose their edges: walks stay put there
    keep = np.repeat(np.arange(num_nodes), np.diff(indptr)) < num_nodes - 20
    indices = indices[keep]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        np.repeat(np.arange(num_nodes), np.diff(indptr))[keep],
        minlength=num_nodes))])
    return indptr.astype(np.int64), indices.astype(np.int64)


@pytest.mark.parametrize("restart", [0.0, 0.3])
@pytest.mark.parametrize("threads", [1, 3, 8])
def test_random_walk_equals_its_numpy_replay(threads, restart):
    indptr, indices = _csr()
    starts = np.random.default_rng(1).integers(0, indptr.size - 1, 997)
    got = native.random_walk(indptr, indices, starts, 5, seed=2 ** 61 + 7,
                             num_threads=threads, restart_prob=restart)
    want = native.random_walk_reference(indptr, indices, starts, 5,
                                        seed=2 ** 61 + 7,
                                        num_threads=threads,
                                        restart_prob=restart)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], starts)
    # every step an edge of the graph, a restart, or a stay at a dead end
    for t in range(1, 5):
        for a, b, s in zip(got[:, t - 1], got[:, t], starts):
            row = indices[indptr[a]: indptr[a + 1]]
            assert b in row or (row.size == 0 and b == a) or (
                restart > 0 and b == s)


def test_random_walk_depends_on_the_thread_count_and_the_seed():
    indptr, indices = _csr()
    starts = np.arange(200)
    one = native.random_walk(indptr, indices, starts, 4, seed=3,
                             num_threads=1)
    assert not np.array_equal(one, native.random_walk(
        indptr, indices, starts, 4, seed=3, num_threads=8))
    assert not np.array_equal(one, native.random_walk(
        indptr, indices, starts, 4, seed=4, num_threads=1))
    np.testing.assert_array_equal(one, native.random_walk(
        indptr, indices, starts, 4, seed=3, num_threads=1))


def test_random_walk_checks_its_arguments():
    indptr, indices = _csr()
    for kw, msg in ((dict(walk_length=0), "walk_length"),
                    (dict(num_threads=0), "num_threads"),
                    (dict(restart_prob=1.0), "restart_prob"),
                    (dict(starts=np.array([10 ** 6])), "start ids")):
        args = dict(starts=np.arange(4), walk_length=3, seed=0,
                    num_threads=1)
        args.update(kw)
        for fn in (native.random_walk, native.random_walk_reference):
            with pytest.raises(ValueError, match=msg):
                fn(indptr, indices, **args)
