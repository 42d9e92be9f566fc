"""cogdl_tpu_torch's file loaders, registry, ``utils/graph_utils``, the
``Graph`` and ops leftovers and ``pipeline()`` against the JAX package, on
small files written here.

* Every loader's dataset array for array against the JAX loader's on the
  same files: the padded ``row``, ``col``, ``edge_weight``, ``x``, ``y``,
  the three masks, ``meta``, ``metric``, ``split_idx``, ``link_split`` and
  the KG ``triples``; with the branches: CiteSeer's isolated test nodes,
  film's multi-hot features, every GRB ``mode`` and ``feat_norm``, the
  RD2CD class retry, the TU zip layout and degree features, ``NodeDataset``
  from arrays, ``.npz`` and ``.pkl``.
* Every registry name: the same keys as the JAX registry, and without its
  files the JAX loader's error type and message.
* ``graph_utils``, ``reverse`` / ``to_scipy`` / ``to_networkx`` /
  ``subgraph`` / ``edge_subgraph`` / ``local_graph`` and the ops
  (``segment_min``, ``scatter_max_with_argmax``, the ``s_*_e_*`` ops,
  ``s_dot_t``), forward and gradients.
* The pipelines: the stats rows, the ego network's frontier, ProNE's
  embedding and LightGCN's top-k against the JAX pipelines'.
"""

import importlib
import inspect
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu.datasets as jds
import cogdl_tpu.native as jnative
import cogdl_tpu.pipelines as jpipe
import cogdl_tpu.utils.graph_utils as jgu
import cogdl_tpu_torch.data.graph as tg
import cogdl_tpu_torch.datasets as tds
import cogdl_tpu_torch.pipelines as tpipe
import cogdl_tpu_torch.utils.graph_utils as tgu
from cogdl_tpu.datasets import customized as jcustom
from cogdl_tpu_torch import native
from cogdl_tpu_torch.datasets import customized as tcustom
from cogdl_tpu_torch.models import load_jax_params
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# the modules, not the functions of their name that the ops packages export
jseg = importlib.import_module("cogdl_tpu.ops.segment")
jspmm = importlib.import_module("cogdl_tpu.ops.spmm")
tseg = importlib.import_module("cogdl_tpu_torch.ops.segment")
tspmm = importlib.import_module("cogdl_tpu_torch.ops.spmm")

FIELDS = ("row_ptr", "row", "col", "edge_weight", "edge_type", "x", "y",
          "train_mask", "val_mask", "test_mask")


# ---------------------------------------------------------------------------
# comparing the two packages' datasets
# ---------------------------------------------------------------------------

def assert_same_graph(gj, gt, tag=""):
    assert (gj.num_nodes, gj.num_edges, gj.n_pad, gj.e_pad) == (
        gt.num_nodes, gt.num_edges, gt.n_pad, gt.e_pad), tag
    for f in FIELDS:
        a, b = getattr(gj, f), getattr(gt, f)
        assert (a is None) == (b is None), (tag, f)
        if a is not None:
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype, (tag, f, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")
    assert dict(gj.meta) == dict(gt.meta), tag


def _same_tree(a, b, tag):
    if isinstance(a, dict):
        assert set(a) == set(b), tag
        for k in a:
            _same_tree(a[k], b[k], f"{tag}/{k}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), tag
        for i, (u, v) in enumerate(zip(a, b)):
            _same_tree(u, v, f"{tag}[{i}]")
    elif a is None or isinstance(a, (int, float, str)):
        assert a == b, tag
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (tag, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=tag)


def assert_same_dataset(dj, dt):
    assert (dj.name, dj.metric) == (dt.name, dt.metric)
    assert (dj.graph is None) == (dt.graph is None)
    if dj.graph is not None:
        assert_same_graph(dj.graph, dt.graph, dj.name)
    assert (dj.graphs is None) == (dt.graphs is None)
    if dj.graphs is not None:
        assert len(dj.graphs) == len(dt.graphs)
        for i, (a, b) in enumerate(zip(dj.graphs, dt.graphs)):
            assert_same_graph(a, b, f"{dj.name} graph {i}")
        _same_tree(dj.labels, dt.labels, "labels")
    for key in ("split_idx", "link_split", "triples", "candidates",
                "samples"):
        _same_tree(getattr(dj, key, None), getattr(dt, key, None), key)
    assert dj.num_classes == dt.num_classes
    assert dj.num_features == dt.num_features


def load_both(module: str, fn: str, name: str, root, **kw):
    """The dataset of ``name`` from the JAX loader and the port's, both
    on the files under ``root``, compared; returns the port's."""
    jmod = __import__(f"cogdl_tpu.datasets.{module}", fromlist=[fn])
    tmod = __import__(f"cogdl_tpu_torch.datasets.{module}", fromlist=[fn])
    dj = getattr(jmod, fn)(name, str(root), **kw)
    dt = getattr(tmod, fn)(name, str(root), **kw)
    assert_same_dataset(dj, dt)
    return dt


def _raw(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    return raw


# ---------------------------------------------------------------------------
# the writers
# ---------------------------------------------------------------------------

def write_planetoid(raw, name, n=40, f=12, c=3, n_train=6, n_test=8,
                    gaps=0, seed=5):
    """The ``ind.<name>.*`` files of ``n`` nodes, the last ``n_test``
    (beside ``gaps`` ids without a row, CiteSeer's isolated test nodes)
    in a shuffled ``test.index``; sparse and dense feature matrices."""
    rng = np.random.default_rng(seed)
    n_all = n - n_test - gaps

    def dump(part, obj):
        with open(raw / f"ind.{name}.{part}", "wb") as fh:
            pickle.dump(obj, fh)

    def onehot(k):
        y = np.zeros((k, c), np.int32)
        y[np.arange(k), rng.integers(0, c, k)] = 1
        return y

    feats = (rng.random((n, f)) < 0.3) * rng.random((n, f))
    dump("x", sp.csr_matrix(feats[:n_train].astype(np.float32)))
    dump("y", onehot(n_train))
    dump("tx", sp.csr_matrix(feats[:n_test].astype(np.float32)))
    dump("ty", onehot(n_test))
    dump("allx", feats[:n_all].astype(np.float32))
    dump("ally", onehot(n_all))
    graph = {i: list(np.unique(rng.integers(0, n, 3)).tolist())
             for i in range(n)}
    graph[1] = []
    dump("graph", graph)
    test_ids = np.arange(n_all, n)
    if gaps:
        test_ids = np.sort(rng.choice(test_ids[1:-1], n_test - 2,
                                      replace=False))
        test_ids = np.r_[n_all, test_ids, n - 1]
    np.savetxt(raw / f"ind.{name}.test.index", rng.permutation(test_ids),
               fmt="%d")


def write_ogb_node(raw, N=30, multilabel=False, seed=0):
    rng = np.random.default_rng(seed)
    (raw / "split").mkdir(exist_ok=True)
    np.save(raw / "edge_index.npy", rng.integers(0, N, (2, 120)))
    np.save(raw / "node_feat.npy", rng.normal(size=(N, 6)))
    np.save(raw / "labels.npy", rng.integers(0, 2, (N, 5)) if multilabel
            else rng.integers(0, 4, (N, 1)))
    np.save(raw / "split" / "train.npy", np.arange(15))
    np.save(raw / "split" / "valid.npy", np.arange(15, 20))
    np.save(raw / "split" / "test.npy", np.arange(20, N))


def write_ogb_graph(raw, G=7, multilabel=False, split=True, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, 7, G)
    node_ptr = np.r_[0, np.cumsum(sizes)]
    esz = rng.integers(1, 9, G)
    edge_ptr = np.r_[0, np.cumsum(esz)]
    ei = np.concatenate([rng.integers(0, s, (2, e))
                         for s, e in zip(sizes, esz)], 1)
    np.savez(raw / "graphs.npz", node_ptr=node_ptr, edge_ptr=edge_ptr,
             edge_index=ei, node_feat=rng.normal(size=(node_ptr[-1], 4)),
             labels=(rng.integers(0, 2, (G, 3)) if multilabel
                     else rng.integers(0, 2, G)))
    if split:
        (raw / "split").mkdir(exist_ok=True)
        np.save(raw / "split" / "train.npy", np.arange(G - 2))
        np.save(raw / "split" / "valid.npy", np.asarray([G - 2]))
        np.save(raw / "split" / "test.npy", np.asarray([G - 1]))


def write_ogb_link(raw, N=20, feats=True, neg=True, seed=0):
    rng = np.random.default_rng(seed)
    (raw / "split").mkdir(exist_ok=True)
    np.save(raw / "edge_index.npy", rng.integers(0, N, (2, 60)))
    if feats:
        np.save(raw / "node_feat.npy", rng.normal(size=(N, 4)))
    for part in ("valid", "test"):
        np.save(raw / "split" / f"{part}_pos.npy", rng.integers(0, N, (2, 5)))
        if neg or part == "test":
            np.save(raw / "split" / f"{part}_neg.npy",
                    rng.integers(0, N, (2, 5)))


def write_saint(raw, N=30, multilabel=False, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(N, N, density=0.1, random_state=seed, format="csr")
    sp.save_npz(raw / "adj_full.npz", A)
    np.save(raw / "feats.npy", rng.normal(size=(N, 5)))
    cmap = {str(i): (rng.integers(0, 2, 4).tolist() if multilabel
                     else int(rng.integers(0, 3))) for i in range(N)}
    with open(raw / "class_map.json", "w") as f:
        json.dump(cmap, f)
    perm = rng.permutation(N).tolist()
    with open(raw / "role.json", "w") as f:
        json.dump({"tr": perm[:18], "va": perm[18:24], "te": perm[24:]}, f)


def write_tu(folder, prefix, n_graphs=6, node_labels=True, seed=0):
    """TU files ``<prefix>_*.txt``: graphs of 3-7 nodes, a ring and a few
    chords each, both directions, 1-based; labels from 1 and 2 upward."""
    rng = np.random.default_rng(seed)
    edges, ind, nl, off = [], [], [], 0
    for gi in range(n_graphs):
        n = int(rng.integers(3, 8))
        ring = [(off + i, off + (i + 1) % n) for i in range(n)]
        chords = [(off + int(a), off + int(b))
                  for a, b in rng.integers(0, n, (2, 2))]
        for a, b in ring + chords:
            edges += [(a + 1, b + 1), (b + 1, a + 1)]
        ind += [gi + 1] * n
        nl += rng.integers(1, 5, n).tolist()
        off += n
    order = rng.permutation(len(edges))
    with open(f"{folder}/{prefix}_A.txt", "w") as f:
        f.write("".join(f"{edges[i][0]}, {edges[i][1]}\n" for i in order))
    np.savetxt(f"{folder}/{prefix}_graph_indicator.txt", ind, fmt="%d")
    np.savetxt(f"{folder}/{prefix}_graph_labels.txt",
               rng.integers(2, 5, n_graphs), fmt="%d")
    if node_labels:
        np.savetxt(f"{folder}/{prefix}_node_labels.txt", nl, fmt="%d")


def write_kg(raw, dicts=False, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in (("train", 50), ("valid", 10), ("test", 10)):
        with open(raw / f"{split}.txt", "w") as f:
            for _ in range(n):
                f.write(f"e{rng.integers(0, 20)}\tr{rng.integers(0, 4)}\t"
                        f"e{rng.integers(0, 20)}\n")
            f.write("a malformed line\n")
    if dicts:
        with open(raw / "entities.dict", "w") as f:
            f.write("".join(f"{i}\te{(i * 7) % 20}\n" for i in range(12)))
        with open(raw / "relations.dict", "w") as f:
            f.write("r2\t0\nr0\t1\n")


def write_geom(raw, name, N=9, film=False, seed=0):
    rng = np.random.default_rng(seed)
    with open(raw / "out1_node_feature_label.txt", "w") as f:
        f.write("node_id\tfeature\tlabel\n")
        for i in rng.permutation(N):
            if film:
                feat = ",".join(map(str, sorted(rng.choice(932, 3, False))))
            else:
                feat = ",".join(map(str, rng.integers(0, 2, 6)))
            f.write(f"{i}\t{feat}\t{i % 3}\n")
    with open(raw / "out1_graph_edges.txt", "w") as f:
        f.write("node_id\tnode_id\n")
        for s, d in rng.integers(0, N, (25, 2)):
            f.write(f"{s}\t{d}\n")
    for k in range(2):
        perm = rng.permutation(N)
        tr, va, te = (np.isin(np.arange(N), perm[a:b]).astype(np.uint8)
                      for a, b in ((0, 5), (5, 7), (7, N)))
        np.savez(raw / f"{name}_split_0.6_0.2_{k}.npz", train_mask=tr,
                 val_mask=va, test_mask=te)


def write_grb(raw, N=20, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(N, N, density=0.2, random_state=seed, format="csr")
    sp.save_npz(raw / "adj.npz", A)
    np.savez(raw / "features.npz", data=rng.normal(size=(N, 6)))
    np.savez(raw / "labels.npz", data=rng.integers(0, 3, N))
    np.savez(raw / "index.npz",
             index_train=np.arange(10), index_val=np.arange(10, 14),
             index_test=np.arange(14, 20), index_test_easy=np.arange(14, 16),
             index_test_medium=np.arange(16, 18),
             index_test_hard=np.arange(18, 20))


def write_rd2cd(raw, y, seed=0):
    rng = np.random.default_rng(seed)
    N = y.shape[0]
    np.save(raw / "x.npy", rng.normal(size=(N, 5)).astype(np.float32))
    np.save(raw / "y.npy", y)
    np.save(raw / "edge_index.npy", rng.integers(0, N, (2, 80)))


# ---------------------------------------------------------------------------
# the loaders against the JAX loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,gaps", [("cora", 0), ("pubmed", 0),
                                       ("citeseer", 3)])
def test_planetoid(tmp_path, name, gaps):
    """Row-normalised features, test rows placed by ``test.index``, 500
    validation nodes after the training ones (fewer here: the set is
    small), the graph made undirected; CiteSeer's isolated test nodes get
    zero rows."""
    write_planetoid(_raw(tmp_path), name, gaps=gaps)
    dt = load_both("planetoid", "build", name, tmp_path)
    g = dt.graph
    n = g.num_nodes
    assert n == 40 and int(g.train_mask.sum()) == 6
    rows = g.x[:n].sum(1)
    assert torch.all(((rows - 1).abs() < 1e-6) | (rows == 0))
    if gaps:
        assert int((g.x[:n].abs().sum(1) == 0).sum()) >= gaps


@pytest.mark.parametrize("name,multilabel", [("ogbn-arxiv", False),
                                             ("ogbn-proteins", True)])
def test_ogb_node(tmp_path, name, multilabel):
    write_ogb_node(_raw(tmp_path), multilabel=multilabel)
    dt = load_both("ogb", "build_node", name, tmp_path)
    assert dt.graph.meta_get("multilabel", False) == multilabel
    if multilabel:
        assert dt.num_classes == 5
        assert dt.graph.meta_get("metric") == "multilabel_f1"


@pytest.mark.parametrize("multilabel,split", [(False, True), (True, True),
                                              (False, False)])
def test_ogb_graph(tmp_path, multilabel, split):
    write_ogb_graph(_raw(tmp_path), multilabel=multilabel, split=split)
    dt = load_both("ogb", "build_graph", "ogbg-molhiv", tmp_path)
    assert (dt.split_idx is not None) == split
    assert dt.metric == ("multilabel_f1" if multilabel else "accuracy")


@pytest.mark.parametrize("feats,neg", [(True, True), (False, False)])
def test_ogb_link(tmp_path, feats, neg):
    write_ogb_link(_raw(tmp_path), feats=feats, neg=neg)
    dt = load_both("ogb", "build_link", "ogbl-collab", tmp_path)
    assert dt.metric == "auc" and set(dt.link_split) == {"valid", "test"}
    assert (dt.link_split["valid"][1] is None) == (not neg)


@pytest.mark.parametrize("name,multilabel", [("flickr", False),
                                             ("ppi", True)])
def test_saint(tmp_path, name, multilabel):
    write_saint(_raw(tmp_path), multilabel=multilabel)
    dt = load_both("saint", "build", name, tmp_path)
    assert dt.metric == ("microf1" if multilabel else "accuracy")
    assert dt.graph.meta_get("multilabel") == multilabel


@pytest.mark.parametrize("layout", ["flat", "zip", "canonical-flat",
                                    "no-node-labels"])
def test_tu(tmp_path, layout):
    """Flat ``raw/<NAME>_*``, the upstream zip's ``raw/<CANON>/<CANON>_*``
    and flat canonical names; node labels one-hot, else degrees. Each
    graph's edges array for array (the port splits them by one sort)."""
    raw = _raw(tmp_path)
    name = "mutag" if layout in ("flat", "no-node-labels") else "imdb-b"
    if layout == "zip":
        (raw / "IMDB-BINARY").mkdir()
        write_tu(raw / "IMDB-BINARY", "IMDB-BINARY")
    elif layout == "canonical-flat":
        write_tu(raw, "IMDB-BINARY")
    else:
        write_tu(raw, "MUTAG", node_labels=layout == "flat")
    dt = load_both("tu", "build", name, tmp_path)
    assert len(dt.graphs) == 6 and dt.labels.min() == 0
    if layout == "no-node-labels":
        assert dt.num_features == 1


@pytest.mark.parametrize("dicts", [False, True])
def test_kg(tmp_path, dicts):
    write_kg(_raw(tmp_path), dicts=dicts)
    dt = load_both("kg", "build", "fb15k237", tmp_path)
    assert dt.metric == "mrr" and dt.triples["train"].shape == (50, 3)


@pytest.mark.parametrize("name,split,film", [("texas", 1, False),
                                             ("film", 0, True),
                                             ("cora_geom", 1, False)])
def test_geom(tmp_path, name, split, film):
    """The directed graph (row = destination), the published split by
    number, film's 932-wide multi-hot features, and the ``_geom`` sets'
    files found under the base name."""
    base = name[:-5] if name.endswith("_geom") else name
    write_geom(_raw(tmp_path), base, film=film)
    dt = load_both("geom", "build", name, tmp_path, split=split)
    if film:
        assert dt.num_features == 932
        assert set(np.unique(dt.graph.x.numpy())) == {0.0, 1.0}


@pytest.mark.parametrize("mode", ["easy", "medium", "hard", "full"])
@pytest.mark.parametrize("feat_norm", [None, "linearize", "arctan", "tanh",
                                       "standardize"])
def test_grb(tmp_path, mode, feat_norm):
    write_grb(_raw(tmp_path))
    dt = load_both("grb", "build", "grb-cora", tmp_path, mode=mode,
                   feat_norm=feat_norm)
    assert int(dt.graph.test_mask.sum()) == (6 if mode == "full" else 2)


def test_grb_refuses_unknown_mode_and_norm(tmp_path):
    from cogdl_tpu_torch.datasets import grb

    with pytest.raises(ValueError, match="mode"):
        grb.build("grb-cora", str(tmp_path), mode="extreme")
    with pytest.raises(ValueError, match="feat_norm"):
        grb.build("grb-cora", str(tmp_path), feat_norm="l2")


def test_grb_weights_reach_k1_as_live_weights(tmp_path):
    """GCN over the GRB graph: the structure K1 reads, built from the
    normalised file weights, gives the logits of the plain route."""
    from cogdl_tpu_torch.models import build_model
    from cogdl_tpu_torch.ops.cuda import prepare_spmm
    from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper

    write_grb(_raw(tmp_path))
    from cogdl_tpu_torch.datasets import grb

    g = grb.build("grb-cora", str(tmp_path)).graph
    assert not torch.all(g.edge_weight[:g.num_edges] == 1.0)
    m = build_model("gcn", in_features=6, out_features=3, dropout=0.0)
    m.reset_parameters(torch.Generator().manual_seed(0))
    w = NodeClfWrapper(m)
    plain = w.prepare_graph(g)
    out = m(plain, training=False)
    kernel = m(prepare_spmm(plain), training=False)
    torch.testing.assert_close(kernel, out, rtol=1e-5, atol=1e-6)


def _rd2cd_y_needing_a_retry():
    """Labels whose rarest class (one node) falls outside train under
    the reference's seed, so that the split draws again."""
    from cogdl_tpu_torch.datasets import rd2cd

    y = np.r_[np.full(3, -1), np.arange(27) % 2].astype(np.int64)
    labeled = np.nonzero(y != -1)[0]
    perm = labeled[np.random.default_rng(rd2cd.SPLIT_SEED).permutation(
        labeled.size)]
    y[perm[-1]] = 2     # the last of the permutation: a test node
    return y


@pytest.mark.parametrize("retry", [False, True])
def test_rd2cd(tmp_path, retry):
    from cogdl_tpu_torch.datasets import rd2cd

    rng = np.random.default_rng(0)
    y = (_rd2cd_y_needing_a_retry() if retry
         else np.r_[np.full(3, -1), rng.integers(0, 3, 27)])
    write_rd2cd(_raw(tmp_path), y)
    dt = load_both("rd2cd", "build", "Github", tmp_path)
    g = dt.graph
    tr = g.train_mask[:30].numpy()
    assert not tr[y == -1].any()
    assert set(g.y[:30].numpy()[tr]) == set(np.unique(y[y != -1]))
    first = np.random.default_rng(rd2cd.SPLIT_SEED).permutation(27)
    # the reference's seed alone gives the split without a retry
    assert retry != np.isin(np.arange(27), first[:16]).all() or not retry


def test_dgraphfin(tmp_path):
    rng = np.random.default_rng(0)
    N = 40
    raw = _raw(tmp_path)
    tr = rng.choice(N, 10, replace=False)
    rest = np.setdiff1d(np.arange(N), tr)
    x = rng.normal(size=(N, 17)).astype(np.float32)
    x[:, 3] = 1.0                       # a column without spread
    np.savez(raw / "dgraphfin.npz", x=x, y=rng.integers(0, 4, N),
             edge_index=rng.integers(0, N, (90, 2)),
             train_mask=tr, valid_mask=rest[:10], test_mask=rest[10:20])
    for normalize in (True, False):
        dt = load_both("dgraphfin", "build", "dgraphfin", tmp_path,
                       normalize=normalize)
        assert dt.num_classes == int(
            dt.graph.y[torch.from_numpy(tr)].max()) + 1


def test_oagbert_eval(tmp_path):
    raw = _raw(tmp_path)
    with open(raw / "._SUCCESS", "w") as f:
        f.write("physics\n\nbiology\n")
    for part in ("part-1.jsonl", "part-0.jsonl"):
        with open(raw / part, "w") as f:
            f.write(json.dumps({"title": part, "label": "physics"}) + "\n\n")
    (raw / "notes.txt").write_text("skipped")
    dt = load_both("oagbert_eval", "build", "l0fos", tmp_path)
    assert dt.graph is None and dt.candidates == ["physics", "biology"]
    assert list(dt.samples) == ["part-0.jsonl", "part-1.jsonl"]


# -- user data ------------------------------------------------------------

def _node_data(masks=False):
    rng = np.random.default_rng(0)
    d = {"edge_index": rng.integers(0, 30, (2, 90)),
         "x": rng.normal(size=(30, 4)).astype(np.float32),
         "y": rng.integers(0, 3, 30)}
    if masks:
        m = rng.random(30) < 0.5
        d.update(train_mask=m, val_mask=~m, test_mask=m & (rng.random(30)
                                                           < 0.5))
    return d


@pytest.mark.parametrize("source", ["arrays", "npz", "pkl", "pkl-masks",
                                    "no-labels"])
def test_node_dataset(tmp_path, source):
    d = _node_data(masks=source == "pkl-masks")
    if source == "no-labels":
        d.pop("y")
        d.pop("x")
    if source.startswith("pkl"):
        kw = {"path": str(tmp_path / "d.pkl")}
        with open(kw["path"], "wb") as f:
            pickle.dump(d, f)
    elif source == "npz":
        kw = {"path": str(tmp_path / "d.npz")}
        np.savez(kw["path"], **d)
    else:
        kw = dict(d)
    dj = jcustom.NodeDataset(seed=3, **kw)
    dt = tcustom.NodeDataset(seed=3, **kw)
    assert_same_dataset(dj, dt)


def test_graph_dataset_and_random_graph():
    gj = [jcustom.generate_random_graph(12, 30, 4, seed=i) for i in range(3)]
    gt = [tcustom.generate_random_graph(12, 30, 4, seed=i) for i in range(3)]
    assert_same_dataset(jcustom.GraphDataset(gj, labels=[0, 1, 0]),
                        tcustom.GraphDataset(gt, labels=[0, 1, 0]))


# -- the registry ---------------------------------------------------------

def test_registry_has_the_jax_names_and_modules():
    assert set(tds.SUPPORTED_DATASETS) == set(jds.SUPPORTED_DATASETS)
    assert len(tds.SUPPORTED_DATASETS) == 105
    for name, path in jds.SUPPORTED_DATASETS.items():
        assert tds.SUPPORTED_DATASETS[name] == path.replace(
            "cogdl_tpu.", "cogdl_tpu_torch.", 1)


@pytest.mark.parametrize("name", sorted(jds.SUPPORTED_DATASETS))
def test_missing_files_raise_the_jax_loaders_error(tmp_path, monkeypatch,
                                                   name):
    monkeypatch.setattr(jds, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(tds, "DATA_ROOT", str(tmp_path))
    with pytest.raises(Exception) as want:
        jds.build_dataset(name)
    with pytest.raises(Exception) as got:
        tds.build_dataset(name)
    assert got.type is want.type is FileNotFoundError
    assert str(got.value) == str(want.value)


def test_unknown_name_lists_the_registry_and_the_synthetic_names():
    with pytest.raises(ValueError) as got:
        tds.build_dataset("no-such-set")
    msg = str(got.value)
    assert msg.startswith("unknown dataset 'no-such-set'; registry: ")
    assert str(sorted(tds.SUPPORTED_DATASETS)) in msg
    assert tds.OFFLINE_NAMES in msg


def test_build_dataset_reads_the_data_root(tmp_path, monkeypatch):
    write_saint(_raw(tmp_path / "flickr"))
    monkeypatch.setattr(jds, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(tds, "DATA_ROOT", str(tmp_path))
    assert_same_dataset(jds.build_dataset("flickr"),
                        tds.build_dataset("flickr"))


# ---------------------------------------------------------------------------
# graph_utils, the Graph leftovers, the ops leftovers
# ---------------------------------------------------------------------------

def _coo(seed=0, n=25, e=90):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), n


def test_coo2csr_library_and_replay_and_the_jax_numpy_branch(monkeypatch):
    """The port's library call, its numpy replay and the JAX function on
    its numpy branch (pinned: the JAX library may be absent or
    half-built in a test worker) give the same arrays."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    row, col, n = _coo()
    want = jgu.coo2csr(row, col, n)
    for got in (tgu.coo2csr(row, col, n), native.coo2csr(row, col, n),
                native.coo2csr_reference(row, col, n)):
        for a, b in zip(got, want):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    empty = native.coo2csr(np.zeros(0), np.zeros(0), 3)
    np.testing.assert_array_equal(empty[0], np.zeros(4, np.int64))
    assert empty[1].size == empty[2].size == 0
    with pytest.raises(ValueError, match="row ids"):
        native.coo2csr(np.asarray([0, 5]), np.asarray([1, 1]), 5)


def test_graph_utils_conversions_match(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    row, col, n = _coo(1)
    w = np.random.default_rng(1).random(row.size)
    ptr, idx, _ = tgu.coo2csr(row, col, n)
    for a, b in zip(tgu.csr2coo(ptr, idx), jgu.csr2coo(ptr, idx)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tgu.coo2csc(row, col, n), jgu.coo2csc(row, col, n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tgu.csr2csc(ptr, idx, n), jgu.csr2csc(ptr, idx, n)):
        np.testing.assert_array_equal(a, b)
    ei = np.stack([row, col])
    np.testing.assert_array_equal(tgu.add_remaining_self_loops(ei, n),
                                  jgu.add_remaining_self_loops(ei, n))
    np.testing.assert_array_equal(
        tgu.symmetric_normalization(row, col, w, n),
        jgu.symmetric_normalization(row, col, w, n))


def _graphs(seed=0, n=30, e=110):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e))
    args = dict(num_nodes=n,
                edge_weight=rng.uniform(0.5, 2.0, e).astype(np.float32),
                edge_type=rng.integers(0, 3, e),
                x=rng.normal(size=(n, 4)).astype(np.float32),
                y=rng.integers(0, 3, n).astype(np.int32),
                train_mask=rng.random(n) < 0.5, val_mask=rng.random(n) < 0.3,
                test_mask=rng.random(n) < 0.2, meta={"name": "g"})
    return jg.from_coo(ei, **args), tg.from_coo(ei, **args)


def test_reverse_and_exports_match():
    gj, gt = _graphs()
    assert_same_graph(jg.reverse(gj), tg.reverse(gt))
    assert (tg.to_scipy(gt) != jg.to_scipy(gj)).nnz == 0
    a, b = tg.to_networkx(gt), jg.to_networkx(gj)
    assert sorted(a.nodes) == sorted(b.nodes)
    assert sorted(a.edges(data="weight")) == sorted(b.edges(data="weight"))


def test_to_networkx_raises_without_networkx(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_networkx(name, *a, **k):
        if name == "networkx":
            raise ImportError("No module named 'networkx'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_networkx)
    _, gt = _graphs()
    with pytest.raises(ImportError):
        tg.to_networkx(gt)


@pytest.mark.parametrize("nodes", [[4, 1, 7, 20, 13, 2], list(range(30))[::-3]])
def test_subgraph_matches(nodes):
    gj, gt = _graphs(1)
    assert_same_graph(jg.subgraph(gj, nodes), tg.subgraph(gt, nodes))


@pytest.mark.parametrize("relabel", [True, False])
def test_edge_subgraph_matches(relabel):
    gj, gt = _graphs(2)
    idx = [3, 17, 40, 41, 99, 0]
    assert_same_graph(jg.edge_subgraph(gj, idx, relabel),
                      tg.edge_subgraph(gt, idx, relabel))
    assert tg.edge_subgraph(gt, [], True) is gt


def test_local_graph_is_a_scoped_copy():
    gj, gt = _graphs()
    w = torch.ones_like(gt.edge_weight)
    with tg.local_graph(gt, edge_weight=w) as g2:
        with jg.local_graph(gj, edge_weight=jnp.asarray(w.numpy())) as j2:
            assert_same_graph(j2, g2)
    assert not torch.equal(gt.edge_weight, w)


def _grad_pair(jfn, tfn, inputs):
    """Forward and the gradient of ``Σ out·r`` (``r`` a fixed random
    cotangent) through both functions, for every float input."""
    outs_j = jfn(*[jnp.asarray(a) for a in inputs])
    r = np.random.default_rng(9).normal(size=np.shape(outs_j)).astype(
        np.float32)
    ts = [torch.tensor(a, requires_grad=a.dtype == np.float32)
          for a in inputs]
    out_t = tfn(*ts)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(outs_j),
                               rtol=1e-5, atol=1e-5)
    floats = [i for i, a in enumerate(inputs) if a.dtype == np.float32]
    gj = jax.grad(lambda *fs: jnp.sum(jfn(*[
        fs[floats.index(i)] if i in floats else jnp.asarray(a)
        for i, a in enumerate(inputs)]) * r), argnums=tuple(range(len(
            floats))))(*[jnp.asarray(inputs[i]) for i in floats])
    (out_t * torch.from_numpy(r)).sum().backward()
    for i, g in zip(floats, gj):
        np.testing.assert_allclose(ts[i].grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(40,), (40, 3)])
def test_segment_min_matches(shape):
    rng = np.random.default_rng(0)
    data = rng.normal(size=shape).astype(np.float32)
    ids = np.sort(rng.integers(0, 9, shape[0]))
    ids[ids == 4] = 5                    # segment 4 empty
    for empty in (0.0, -2.5):
        _grad_pair(lambda d, i: jseg.segment_min(d, i, 10,
                                                 empty_value=empty),
                   lambda d, i: tseg.segment_min(d, i, 10, empty_value=empty),
                   [data, ids.astype(np.int32)])


@pytest.mark.parametrize("shape", [(40,), (40, 3)])
def test_scatter_max_with_argmax_matches(shape):
    rng = np.random.default_rng(1)
    data = rng.normal(size=shape).astype(np.float32)
    data[7] = data[6]                    # a tie: the lower index wins
    ids = np.sort(rng.integers(0, 9, shape[0])).astype(np.int32)
    ids[ids == 2] = 3
    mj, aj = jseg.scatter_max_with_argmax(jnp.asarray(data), jnp.asarray(ids),
                                          10)
    mt, at = tseg.scatter_max_with_argmax(torch.from_numpy(data),
                                          torch.from_numpy(ids), 10)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert at.dtype == torch.int32
    _grad_pair(lambda d, i: jseg.scatter_max_with_argmax(d, i, 10)[0],
               lambda d, i: tseg.scatter_max_with_argmax(d, i, 10)[0],
               [data, ids])


OPS = ["s_add_e_sum", "s_mul_e_sum", "s_sub_e_sum", "s_add_e_mean",
       "s_mul_e_mean"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("edge_dims", [1, 2])
def test_message_ops_match(op, edge_dims):
    """Each op over a graph with pad edges whose edge features are not
    zero, with ``[E]`` and ``[E, F]`` edge features."""
    gj, gt = _graphs(3)
    rng = np.random.default_rng(4)
    src = rng.normal(size=(gt.n_pad, 5)).astype(np.float32)
    edge = rng.normal(size=(gt.e_pad,) + ((5,) if edge_dims == 2 else ())
                      ).astype(np.float32)
    assert gt.e_pad > gt.num_edges
    _grad_pair(lambda s, e: getattr(jspmm, op)(gj, s, e),
               lambda s, e: getattr(tspmm, op)(gt, s, e), [src, edge])


def test_max_aggregation_and_s_dot_t_match():
    gj, gt = _graphs(5)
    rng = np.random.default_rng(6)
    src = rng.normal(size=(gt.n_pad, 4)).astype(np.float32)
    dst = rng.normal(size=(gt.n_pad, 4)).astype(np.float32)
    edge = rng.normal(size=(gt.e_pad, 4)).astype(np.float32)
    _grad_pair(lambda s, e: jspmm._s_op_e_agg("add", "max", gj, s, e),
               lambda s, e: tspmm._s_op_e_agg("add", "max", gt, s, e),
               [src, edge])
    _grad_pair(lambda s, d: jspmm.s_dot_t(gj, s, d),
               lambda s, d: tspmm.s_dot_t(gt, s, d), [src, dst])
    with pytest.raises(ValueError):
        tspmm._s_op_e_agg("div", "sum", gt, torch.from_numpy(src),
                          torch.from_numpy(edge))


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

def test_pipeline_apps_and_device():
    assert set(tpipe.SUPPORTED_APPS) == set(jpipe.SUPPORTED_APPS)
    with pytest.raises(ValueError, match="unknown app"):
        tpipe.pipeline("nonesuch", device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tpipe.pipeline("oagbert", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tpipe.pipeline("dataset-stats")
    p = tpipe.pipeline("dataset-stats", device="cpu", dataset="sbm")
    assert p.device == torch.device("cpu")


def test_dataset_stats_rows_match(tmp_path, monkeypatch):
    write_saint(_raw(tmp_path / "flickr"))
    write_tu(_raw(tmp_path / "mutag"), "MUTAG")
    monkeypatch.setattr(jds, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(tds, "DATA_ROOT", str(tmp_path))
    names = ["sbm", "flickr", "mutag", "random-graphs"]
    want = jpipe.pipeline("dataset-stats")(names)
    got = tpipe.pipeline("dataset-stats", device="cpu")(names)
    assert got == want
    assert tpipe.pipeline("stats", device="cpu", dataset="sbm")() == \
        jpipe.pipeline("stats", dataset="sbm")()


@pytest.fixture
def no_matplotlib(monkeypatch):
    """``import matplotlib`` raises, as where it is not installed."""
    import builtins

    real = builtins.__import__

    def imp(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", imp)


@pytest.mark.parametrize("seed,depth", [(-1, 3), (5, 2), (0, 1), (7, 6)])
def test_dataset_visual_frontier_matches(no_matplotlib, capsys, seed, depth):
    """The outermost frontier as the JAX pipeline's (a set: its order
    follows Python sets); without matplotlib both skip the plot and say
    so, and nothing else changes."""
    kw = dict(seed=seed, depth=depth)
    want = jpipe.pipeline("dataset-visual")("sbm", **kw)
    got = tpipe.pipeline("dataset-visual", device="cpu")("sbm", **kw)
    assert got == sorted(want)
    assert capsys.readouterr().out.count("matplotlib unavailable") == 2


def test_dataset_visual_saves_the_plot(tmp_path):
    pytest.importorskip("matplotlib")
    want = jpipe.pipeline("dataset-visual")(
        "sbm", seed=5, depth=1, out_file=str(tmp_path / "j.png"))
    got = tpipe.pipeline("dataset-visual", device="cpu")(
        "sbm", seed=5, depth=1, out_file=str(tmp_path / "t.png"))
    assert got == sorted(want)
    assert (tmp_path / "t.png").stat().st_size > 0


def test_generate_embedding_prone_matches():
    """ProNE over an edge list, within the tolerance that holds the
    ProNE model to the JAX one (``1e-4·max|·|``,
    ``tests/test_torch_emb.py``); and over a dataset."""
    import chip_smoke as cs

    A, _ = cs.embedding_network(200, 1600, 8, 0)
    A = A.tocoo()
    ei = np.stack([A.row, A.col])
    kw = dict(hidden_size=16, seed=1)
    want = jpipe.pipeline("generate-emb")(edge_index=ei, **kw)
    got = tpipe.pipeline("generate-emb", device="cpu")(edge_index=ei, **kw)
    assert got.shape == want.shape
    assert float((got - torch.from_numpy(np.asarray(want))).abs().max()) <= \
        1e-4 * float(np.abs(want).max())
    via = tpipe.pipeline("generate-emb", device="cpu", model="prone",
                         model_kwargs=kw)(dataset="sbm")
    assert via.shape == (400, 16)


def test_recommendation_topk_matches_with_the_jax_weights():
    """The JAX pipeline's trained LightGCN weights carried into the port's
    model: the same top-k items for every user whose top k + 1 scores do
    not tie; the metrics the trainer's."""
    jrec = jpipe.pipeline("recommendation")(
        "rec-synthetic", topk=5, epochs=2)
    variables = inspect.getclosurevars(jrec).nonlocals["variables"]
    trec = tpipe.pipeline("recommendation", device="cpu")(
        "rec-synthetic", topk=5, epochs=1)
    assert {"val_recall", "test_recall", "train_step_ms"} <= set(
        trec.metrics)
    load_jax_params(trec.model, jax.tree.map(np.asarray,
                                             variables["params"]))
    users = np.arange(0, 40)
    want, got = jrec(users), trec(users)
    ds = tds.build_dataset("rec-synthetic")
    nu = ds.graph.meta_get("num_users")
    with torch.no_grad():
        emb = trec.model(tg.sym_norm(ds.graph), training=False)
        scores = emb[torch.from_numpy(users)] @ emb[nu:ds.graph.num_nodes].T
        top = torch.topk(scores, 6, dim=1).values
    untied = (top[:, :-1] > top[:, 1:]).all(1).numpy()
    assert untied.sum() >= 30
    np.testing.assert_array_equal(got[untied], want[untied])
    assert got.min() >= nu
