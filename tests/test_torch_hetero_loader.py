"""cogdl_tpu_torch's ``han-*`` and ``gtn-*`` loaders against the JAX
package's on tiny files written here: the GTN layout (``edges.pkl``,
``labels.pkl``, ``node_features.pkl``) at three and four relations, and the
HAN ``data.mat`` for the ACM, DBLP and IMDB key sets and for a file whose
metapath keys are found by name; the union graph, every metapath graph and
the node types array for array. A missing file raises, with where to put
it."""

import pickle

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

import cogdl_tpu_torch.datasets as tds
from cogdl_tpu.datasets import hetero as j_hetero
from cogdl_tpu_torch.datasets import build_dataset, hetero
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

FIELDS = ("row_ptr", "row", "col", "edge_weight", "edge_type", "x", "y",
          "train_mask", "val_mask", "test_mask")


def _assert_same(dj, dt):
    assert dj.name == dt.name
    pairs = [(dj.graph, dt.graph, "union")] + [
        (a, b, f"metapath {i}") for i, (a, b) in enumerate(zip(
            dj.graph.extras["metapath_graphs"],
            dt.graph.extras["metapath_graphs"]))]
    assert len(pairs) - 1 == len(dt.graph.extras["metapath_graphs"])
    for gj, gt, tag in pairs:
        for f in FIELDS:
            a, b = getattr(gj, f), getattr(gt, f)
            assert (a is None) == (b is None), (tag, f)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=f"{tag} {f}")
        assert (gj.num_nodes, gj.num_edges) == (gt.num_nodes, gt.num_edges)
        assert dict(gj.meta) == dict(gt.meta), tag
    np.testing.assert_array_equal(np.asarray(dj.graph.extras["node_type"]),
                                  dt.graph.extras["node_type"].numpy())
    ex = dt.graph.extras
    assert ex["metapath_graphs"] is ex["relation_graphs"]


def _write_gtn(raw, n_rel, N=14):
    rng = np.random.default_rng(n_rel)
    edges = [sp.random(N, N, density=0.2, random_state=s, format="csr")
             for s in range(n_rel)]
    with open(raw / "edges.pkl", "wb") as f:
        pickle.dump(edges, f)
    nodes = rng.permutation(N)
    labels = [np.stack([nodes[:7], rng.integers(0, 3, 7)], 1),
              np.stack([nodes[7:10], rng.integers(0, 3, 3)], 1),
              np.stack([nodes[10:], rng.integers(0, 3, N - 10)], 1)]
    with open(raw / "labels.pkl", "wb") as f:
        pickle.dump(labels, f)
    with open(raw / "node_features.pkl", "wb") as f:
        pickle.dump(rng.normal(size=(N, 6)).astype(np.float32), f)


@pytest.mark.parametrize("name,n_rel", [("gtn-acm", 4), ("gtn-dblp", 4),
                                        ("gtn-imdb", 3)])
def test_gtn_loader_gives_the_jax_packages_arrays(tmp_path, name, n_rel):
    raw = tmp_path / "raw"
    raw.mkdir()
    _write_gtn(raw, n_rel)
    dt = hetero.build_gtn(name, str(tmp_path))
    _assert_same(j_hetero.build_gtn(name, str(tmp_path)), dt)
    assert dt.graph.meta_get("num_relations") == n_rel


def _write_han(raw, name, N=12):
    rng = np.random.default_rng(len(name))
    label_key, feat_key, net_keys = hetero.HAN_KEYS.get(
        name, ("label", "feature", ["AB", "BA"]))
    nets = {}
    for i, k in enumerate(net_keys):
        a = (rng.random((N, N)) < 0.3).astype(np.float64)
        np.fill_diagonal(a, 1.0)   # the reference subtracts the identity
        nets[k] = sp.csr_matrix(a) if i % 2 else a
    y = np.zeros((N, 3))
    y[np.arange(N), rng.integers(0, 3, N)] = 1
    feats = rng.normal(size=(N, 5))
    sio.savemat(raw / "data.mat", {
        label_key: y,
        feat_key: sp.csr_matrix(feats) if feat_key == "features" else feats,
        "train_idx": np.arange(7)[None], "val_idx": np.arange(7, 9)[None],
        "test_idx": np.arange(9, N)[None], **nets})
    return len(net_keys)


@pytest.mark.parametrize("name", ["han-acm", "han-dblp", "han-imdb",
                                  "han-other"])
def test_han_loader_gives_the_jax_packages_arrays(tmp_path, name):
    """ACM (PAP, PLP), DBLP (sparse ``features``, net_APA/APCPA/APTPA),
    IMDB (MAM, MDM, MYM), dense and sparse metapath matrices; a name
    outside ``HAN_KEYS`` takes every other key of the file as a
    metapath."""
    raw = tmp_path / "raw"
    raw.mkdir()
    n_paths = _write_han(raw, name)
    dt = hetero.build_han(name, str(tmp_path))
    _assert_same(j_hetero.build_han(name, str(tmp_path)), dt)
    assert len(dt.graph.extras["metapath_graphs"]) == n_paths
    assert int(dt.graph.train_mask.sum()) == 7
    assert hetero.HAN_KEYS == j_hetero.HAN_KEYS


def test_missing_files_raise_with_where_to_put_them(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="node_features.pkl"):
        hetero.build_gtn("gtn-acm", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="data.mat"):
        hetero.build_han("han-acm", str(tmp_path))
    monkeypatch.setattr(tds, "DATA_ROOT", str(tmp_path))
    for name in sorted(tds.SUPPORTED_DATASETS):
        with pytest.raises(FileNotFoundError,
                           match=str(tmp_path / name / "raw")):
            build_dataset(name)
    # the registry is the JAX package's, every loader ported
    from cogdl_tpu.datasets import SUPPORTED_DATASETS as J

    assert set(tds.SUPPORTED_DATASETS) == set(J)


def test_build_dataset_reads_the_data_root(tmp_path, monkeypatch):
    (tmp_path / "han-imdb" / "raw").mkdir(parents=True)
    _write_han(tmp_path / "han-imdb" / "raw", "han-imdb")
    monkeypatch.setattr(tds, "DATA_ROOT", str(tmp_path))
    ds = build_dataset("han-imdb")
    _assert_same(j_hetero.build_han("han-imdb", str(tmp_path / "han-imdb")),
                 ds)
    with pytest.raises(ValueError, match="unknown dataset 'acm-nonesuch'"):
        build_dataset("acm-nonesuch")
