"""The network-embedding probe, wrapper and ``.mat`` loader against the
JAX package's, on the CPU.

* ``f1_scores`` equal to scikit-learn's ``f1_score`` (micro, macro) to
  1e-12, label matrices and label vectors.
* ``f1_label_probe`` against the JAX probe (scikit-learn's one-vs-rest
  ``LogisticRegression(max_iter=300)``, which stops at its own tolerance;
  the port converges): per shuffle, the rows whose (k+1)-th most probable
  label ties the k-th under scikit-learn's fit are left out on both sides
  and counted; micro and macro F1 over the rest within 0.005, and the
  probe's means against the JAX probe's within 0.005.
* ``NetworkEmbeddingWrapper`` both ways on the same embedding: the
  logistic regression over the splits (one label a node, a train mask;
  the zero padding) and the F1 protocol (a label matrix).
* ``datasets/matlab.py`` on a file the test writes: the JAX loader's
  graph array for array, the missing file's message, the six names.
"""

import os

import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression
from sklearn.metrics import f1_score
from sklearn.multiclass import OneVsRestClassifier

import chip_smoke as cs
from cogdl_tpu.datasets import matlab as j_matlab
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.utils import probe as jprobe
from cogdl_tpu.wrappers.network_embedding import (
    NetworkEmbeddingWrapper as JWrapper,
)
from cogdl_tpu_torch import datasets as tdatasets
from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.datasets import matlab as t_matlab
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.utils import probe
from cogdl_tpu_torch.wrappers.network_embedding import (
    NetworkEmbeddingWrapper as TWrapper,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

EMBEDDINGS = ("deepwalk", "node2vec", "line", "netmf", "netsmf", "prone",
              "prone++", "hope", "grarep", "spectral", "sdne", "dngr")


def labelled_embedding(n=1500, labels=12, dim=24, seed=0):
    """A 0/1 label matrix of 1-3 labels a row and an embedding that
    carries them through noise."""
    rng = np.random.default_rng(seed)
    Y = np.zeros((n, labels), np.float32)
    for i in range(n):
        Y[i, rng.choice(labels, rng.integers(1, 4), replace=False)] = 1
    emb = Y @ rng.normal(size=(labels, dim)) + 1.5 * rng.normal(size=(n, dim))
    return emb.astype(np.float32), Y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f1_scores_are_scikit_learns(seed):
    rng = np.random.default_rng(seed)
    true = (rng.random((80, 7)) < 0.3).astype(int)
    true[:, 6] = 0                     # a label with no true member
    pred = (rng.random((80, 7)) < 0.3).astype(int)
    pred[:, 5] = 0
    mi, ma = probe.f1_scores(torch.from_numpy(true), torch.from_numpy(pred))
    assert abs(mi - f1_score(true, pred, average="micro")) < 1e-12
    assert abs(ma - f1_score(true, pred, average="macro",
                             zero_division=0)) < 1e-12
    yt, yp = rng.integers(0, 5, 60), rng.integers(0, 6, 60)
    mi, ma = probe.f1_scores(torch.from_numpy(yt), torch.from_numpy(yp))
    assert abs(mi - f1_score(yt, yp, average="micro")) < 1e-12
    assert abs(ma - f1_score(yt, yp, average="macro",
                             zero_division=0)) < 1e-12


def test_top_k_labels_sets_each_rows_k():
    prob = torch.tensor([[0.1, 0.9, 0.5], [0.3, 0.2, 0.1], [0.2, 0.4, 0.6]])
    pred = probe.top_k_labels(prob, torch.tensor([2, 0, 1]))
    assert pred.tolist() == [[False, True, True], [False, False, False],
                             [False, False, True]]


@pytest.mark.parametrize("seed", [0, 1])
def test_multilabel_probe_against_jax_row_by_row(seed):
    """Each shuffle's split as the JAX probe draws it, scikit-learn's
    one-vs-rest probabilities against the port's, top-k predictions, and
    F1 over the rows without a tie at the k-th label."""
    emb, Y = labelled_embedding(seed=seed)
    Y[:, -1] = 0          # a label no row has (some rows then have none)
    rng = np.random.default_rng(seed)
    Xn = jprobe._standardize(emb)
    X = probe.standardize(torch.from_numpy(emb))
    n = emb.shape[0]
    tied = 0
    mine, theirs = [], []
    for _ in range(5):
        idx = rng.permutation(n)
        tr, te = idx[: int(0.9 * n)], idx[int(0.9 * n):]
        sk = OneVsRestClassifier(LogisticRegression(max_iter=300)).fit(
            Xn[tr], Y[tr]).predict_proba(Xn[te])
        prob = probe.ovr_proba(X[tr], torch.from_numpy(Y[tr]), X[te])
        k = Y[te].sum(1).astype(int)
        srt = -np.sort(-sk, 1)
        tie = np.array([0 < ki < sk.shape[1] and srt[i, ki - 1] == srt[i, ki]
                        for i, ki in enumerate(k)])
        tied += int(tie.sum())
        pred_sk = np.zeros_like(Y[te])
        for i, ki in enumerate(k):
            if ki > 0:
                pred_sk[i, np.argsort(sk[i])[-ki:]] = 1
        pred = probe.top_k_labels(prob, torch.from_numpy(k)).numpy()
        keep = ~tie
        mine.append(probe.f1_scores(torch.from_numpy(Y[te][keep]),
                                    torch.from_numpy(pred[keep])))
        theirs.append((f1_score(Y[te][keep], pred_sk[keep], average="micro"),
                       f1_score(Y[te][keep], pred_sk[keep], average="macro",
                                zero_division=0)))
    assert tied == 0
    diff = np.abs(np.mean(mine, 0) - np.mean(theirs, 0))
    assert np.all(diff < 0.005), (np.mean(mine, 0), np.mean(theirs, 0))
    got = probe.f1_label_probe(torch.from_numpy(emb), torch.from_numpy(Y),
                               seed=seed)
    want = jprobe.f1_label_probe(emb, Y, seed=seed)
    assert abs(got["test_micro_f1"] - want["test_micro_f1"]) < 0.005
    assert abs(got["test_macro_f1"] - want["test_macro_f1"]) < 0.005
    assert got["probe_ms"] > 0


def test_multiclass_probe_against_jax():
    emb, Y = labelled_embedding(n=1200, labels=6)
    y = Y.argmax(1)
    got = probe.f1_label_probe(torch.from_numpy(emb), torch.from_numpy(y),
                               seed=3)
    want = jprobe.f1_label_probe(emb, y, seed=3)
    for key in ("test_micro_f1", "test_macro_f1", "micro_f1_std"):
        assert abs(got[key] - want[key]) < 0.005, key


def test_logreg_fit_on_a_label_matrix_is_each_labels_fit():
    """The summed objective's minimiser is every binary fit's."""
    emb, Y = labelled_embedding(n=400, labels=4, dim=8)
    X = probe.standardize(torch.from_numpy(emb))
    joint = probe.logreg_fit(X, torch.from_numpy(Y))
    assert joint.classes is None and joint.coef.shape == (4, 8)
    for j in range(4):
        one = probe.logreg_fit(X, torch.from_numpy(Y[:, j]).long())
        assert torch.allclose(joint.coef[j], one.coef[0], atol=1e-6)
        assert abs(float(joint.intercept[j] - one.intercept[0])) < 1e-6


def _fixed(emb):
    return lambda graph, device=None: torch.from_numpy(emb)


def test_wrapper_logreg_branch_against_jax():
    """One label a node and a train mask: the embedding zero-padded to
    the padded rows, standardised with them, the logistic regression's
    split accuracies."""
    jg, tg = j_sbm(num_nodes=300), t_sbm(num_nodes=300)
    emb = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
    emb += np.eye(8, dtype=np.float32)[np.asarray(jg.y)[:300] % 8] * 2
    jw = JWrapper("prone", type("D", (), {"graph": jg})(), seed=0)
    jw.model.train_embeddings = lambda g: emb
    want = jw.run_embedding()
    tw = TWrapper("prone", Dataset.from_graph(tg), seed=0)
    tw.model.train_embeddings = _fixed(emb)
    got = tw.run_embedding("cpu")
    for key in ("train_acc", "val_acc", "test_acc"):
        assert abs(got[key] - want[key]) <= 1.0 / 100, key
    assert got["embed_s"] >= 0 and "probe_iters" in got


def test_wrapper_f1_branch_against_jax(tmp_path):
    A, groups = cs.embedding_network(400, 3000, 6, seed=1)
    cs.write_network_mat(str(tmp_path), "ppi-ne", A, groups)
    jds = j_matlab.build("ppi-ne", str(tmp_path / "ppi-ne"))
    tds = t_matlab.build("ppi-ne", str(tmp_path / "ppi-ne"))
    emb, _ = labelled_embedding(n=400, labels=6)
    emb = emb + 2 * np.asarray(groups.todense(), np.float32) @ \
        np.random.default_rng(1).normal(size=(6, emb.shape[1]))
    emb = emb.astype(np.float32)
    jw = JWrapper("netmf", jds, seed=2)
    jw.model.train_embeddings = lambda g: emb
    want = jw.run_embedding()
    tw = TWrapper("netmf", tds, seed=2)
    tw.model.train_embeddings = _fixed(emb)
    got = tw.run_embedding("cpu")
    assert got["test_acc"] == got["test_micro_f1"] == got["val_acc"]
    for key in ("test_micro_f1", "test_macro_f1"):
        assert abs(got[key] - want[key]) < 0.005, key


def test_matlab_loader_against_jax(tmp_path):
    A, groups = cs.embedding_network(150, 900, 5, seed=2)
    path = cs.write_network_mat(str(tmp_path), "blogcatalog", A, groups)
    assert path.endswith(os.path.join("blogcatalog", "raw",
                                      "blogcatalog.mat"))
    root = str(tmp_path / "blogcatalog")
    jd, td = j_matlab.build("blogcatalog", root), t_matlab.build(
        "blogcatalog", root)
    jg, tg = jd.graph, td.graph
    assert (td.name, td.metric) == (jd.name, jd.metric) == (
        "blogcatalog", "microf1")
    assert (tg.num_nodes, tg.num_edges, tg.n_pad, tg.e_pad) == (
        jg.num_nodes, jg.num_edges, jg.n_pad, jg.e_pad)
    for f in ("row", "col", "edge_weight", "y", "row_ptr"):
        assert np.array_equal(getattr(tg, f).numpy(),
                              np.asarray(getattr(jg, f))), f
    assert dict(tg.meta) == dict(jg.meta)
    assert td.num_classes == 5


def test_matlab_names_and_missing_file(tmp_path, monkeypatch):
    names = ("blogcatalog", "wikipedia", "ppi-ne", "dblp-ne", "flickr-ne",
             "youtube-ne")
    for name in names:
        assert tdatasets.SUPPORTED_DATASETS[name].endswith("matlab.build")
    monkeypatch.setattr(tdatasets, "DATA_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        tdatasets.build_dataset("dblp-ne")
    with pytest.raises(FileNotFoundError) as want:
        j_matlab.build("dblp-ne", str(tmp_path / "dblp-ne"))
    assert str(got.value) == str(want.value)
    A, groups = cs.embedding_network(60, 300, 3, seed=0)
    cs.write_network_mat(str(tmp_path), "dblp-ne", A, groups)
    assert tdatasets.build_dataset("dblp-ne").graph.num_nodes == 60


@pytest.mark.parametrize("name", EMBEDDINGS)
def test_experiment_needs_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment(dataset="sbm", model=name)
