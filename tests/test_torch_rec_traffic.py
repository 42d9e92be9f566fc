"""cogdl_tpu_torch's recommendation and traffic slice (LightGCN, STGCN,
STGAT, the ``recommendation`` and ``traffic_prediction`` wrappers, the rec
and PeMS loaders, both generators) and the accumulating evaluators against
the JAX package on the CPU.

The generators and loaders give the JAX package's arrays. The models carry
the JAX initial variables (``load_jax_params``): forward at 1e-5 and the
gradients of a loss at 1e-4, over the plain graph and over the kernels'
structure (the CPU runs K1's and K3's plain versions over it; the traffic
models over the unions of road-graph copies the wrapper builds). The BPR
loss and its gradients hold at the JAX wrapper's draws for a key. Recall
and NDCG equal the JAX loop's exactly on weights whose top ``k + 1`` scores
do not tie, which each such test asserts first. Through
``experiment(device="cpu")`` the train loss of every epoch is the JAX
trainer's within 1e-4, given the JAX trainer's initial weights (carried
across by ``load_jax_params``) and, for LightGCN, its BPR draws: the
port draws both from torch's generator, which cannot give JAX's numbers."""

import copy
import functools
import json
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogdl_tpu.datasets import rec as j_rec
from cogdl_tpu.datasets import traffic_pems as j_pems
from cogdl_tpu.datasets.dataset import Dataset as JDataset
from cogdl_tpu.datasets.synthetic import bipartite_rec_graph as j_rec_graph
from cogdl_tpu.datasets.synthetic import traffic_graph as j_traffic
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.utils import evaluator as j_ev
from cogdl_tpu.wrappers import fetch_wrapper as j_fetch_wrapper
from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.data.batch import block_union
from cogdl_tpu_torch.data.graph import sym_norm
from cogdl_tpu_torch.datasets import SUPPORTED_DATASETS, build_dataset
from cogdl_tpu_torch.datasets import rec as t_rec
from cogdl_tpu_torch.datasets import traffic_pems as t_pems
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import (
    bipartite_rec_graph as t_rec_graph,
)
from cogdl_tpu_torch.datasets.synthetic import traffic_graph as t_traffic
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops import spmm
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.trainer.trainer import Trainer
from cogdl_tpu_torch.utils import evaluator as t_ev
from cogdl_tpu_torch.wrappers import DEFAULT_WRAPPER, fetch_wrapper
from cogdl_tpu_torch.wrappers.recommendation import RecommendationWrapper
from cogdl_tpu_torch.wrappers.sampled_node_classification import (
    reads_kernel_structure,
)
from cogdl_tpu_torch.wrappers.traffic_prediction import (
    TrafficPredictionWrapper,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)
from test_torch_zoo_models import _Recorder

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
LOSS_TOL = 1e-4
REC = dict(num_users=40, num_items=30, avg_interactions=6, num_tastes=3,
           seed=2)
TRAFFIC = dict(num_nodes=12, num_steps=60, seed=1)
# the traffic models at narrow widths
TRAFFIC_MODELS = {"stgcn": dict(hidden_size=8, spatial_channels=4),
                  "stgat": dict(hidden_size=8, nhead=2)}
BATCH = 3


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def same_graph(gt, gj):
    for f in ("row_ptr", "row", "col", "edge_weight"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert (gt.num_nodes, gt.num_edges) == (gj.num_nodes, gj.num_edges)
    assert dict(gt.meta) == dict(gj.meta)


# -- generators and loaders ---------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(num_nodes=7, num_steps=30,
                                         feat_dim=2, seed=3),
                                dict(num_nodes=228, num_steps=200)])
def test_traffic_graph_equals_jax(kw):
    gt, gj = t_traffic(**kw), j_traffic(**kw)
    same_graph(gt, gj)
    np.testing.assert_array_equal(gt.x.numpy(), np.asarray(gj.x))
    series = gt.extras["series"]
    np.testing.assert_array_equal(series.numpy(),
                                  np.asarray(gj.extras["series"]))
    # a window of the series lines up with the graph's rows
    assert series.shape[1] == gt.n_pad


@pytest.mark.parametrize("kw", [{}, REC, dict(REC, num_tastes=1, seed=5)])
def test_bipartite_rec_graph_equals_jax(kw):
    same_graph(t_rec_graph(**kw), j_rec_graph(**kw))


def _write_rec(raw, pair_format: bool, seed: int):
    rng = np.random.default_rng(seed)
    nu, ni = 9, 7
    off = nu if pair_format else 0
    files = ("train", "test", "valid") if pair_format else ("train", "test")
    for name in files:
        with open(raw / f"{name}.txt", "w") as f:
            for u in range(nu):
                items = rng.choice(ni, size=int(rng.integers(1, 4)),
                                   replace=False)
                if pair_format:
                    f.writelines(f"{u} {i + off}\n" for i in items)
                    if name == "test" and u == 2:
                        f.write(f"{u} {items[0] + off}\n")   # a repeat
                else:
                    f.write(f"{u} " + " ".join(map(str, items)) + "\n")
            f.write("\n")


@pytest.mark.parametrize("name", ["yelp2018", "ali"])
def test_rec_loader_equals_jax(tmp_path, name):
    raw = tmp_path / "raw"
    raw.mkdir()
    _write_rec(raw, name == "ali", seed=len(name))
    dt, dj = t_rec.build(name, str(tmp_path)), j_rec.build(name,
                                                           str(tmp_path))
    same_graph(dt.graph, dj.graph)
    assert dt.metric == dj.metric == "recall"
    for key in ("eval_user_items", "valid_user_items"):
        a, b = getattr(dt, key), getattr(dj, key)
        assert list(a) == list(b)
        for u in a:
            np.testing.assert_array_equal(a[u], b[u])


def test_pems_loader_equals_jax(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    N, T = 6, 40
    W = rng.random((N, N)) * (rng.random((N, N)) < 0.5)
    with open(raw / f"W_{N}.csv", "w") as f:
        f.write(",".join(f"s{i}" for i in range(N)) + "\n")
        for r in W:
            f.write(",".join(str(v) for v in r) + "\n")
    with open(raw / f"V_{N}.csv", "w") as f:
        f.write("timestamp," + ",".join(f"s{i}" for i in range(N)) + "\n")
        for t in range(T):
            vals = [str(v) for v in rng.random(N) * 60]
            vals[t % N] = "" if t % 7 == 0 else vals[t % N]
            f.write(f"t{t}," + ",".join(vals) + "\n")
    dt = t_pems.build("pems-stgcn", str(tmp_path), num_stations=N)
    dj = j_pems.build("pems-stgcn", str(tmp_path), num_stations=N)
    same_graph(dt.graph, dj.graph)
    np.testing.assert_array_equal(dt.graph.x.numpy(), np.asarray(dj.graph.x))
    np.testing.assert_array_equal(dt.graph.extras["series"].numpy(),
                                  np.asarray(dj.graph.extras["series"]))
    assert dt.series_scale == dj.series_scale and dt.metric == "mae"


@pytest.mark.parametrize("name", ["yelp2018", "amazon-rec", "pems-stgat"])
def test_loaders_raise_on_missing_files(tmp_path, name):
    build = t_pems.build if name.startswith("pems") else t_rec.build
    with pytest.raises(FileNotFoundError, match="Missing"):
        build(name, str(tmp_path))


def test_the_ports_dataset_names_resolve():
    """Every loader name of the port is a JAX registry name, and the new
    ones reach their loader (which raises for the missing files); the two
    synthetic names build."""
    from cogdl_tpu.datasets import SUPPORTED_DATASETS as J

    assert set(SUPPORTED_DATASETS) <= set(J)
    for name in ("yelp2018", "ali", "amazon-rec", "pems-stgcn",
                 "pems-stgat"):
        assert SUPPORTED_DATASETS[name].rsplit(".", 2)[1] == \
            J[name].rsplit(".", 2)[1]
        with pytest.raises(FileNotFoundError):
            build_dataset(name)
    assert build_dataset("traffic-synthetic").metric == "mae"
    assert build_dataset("rec-synthetic").graph.meta_get("num_users") == 200


# -- the recommendation wrapper -----------------------------------------------

def _rec_dataset(official: bool):
    """The rec graph in both packages, with official positives the test
    draws (repeats included) when ``official``."""
    gt, gj = t_rec_graph(**REC), j_rec_graph(**REC)
    dt, dj = Dataset.from_graph(gt, "rec"), JDataset.from_graph(gj, "rec")
    if official:
        rng = np.random.default_rng(7)
        pos = {u: rng.integers(0, REC["num_items"], int(rng.integers(0, 4)))
               for u in range(0, REC["num_users"], 2)}
        dt.eval_user_items = dj.eval_user_items = pos
    return dt, dj


def _rec_pair(official=False, topk=5, hidden=8, structure=False,
              scale=None):
    """Both wrappers over the rec graph, prepared, the port's model with
    the JAX initial variables; with ``scale``, the embeddings drawn from
    normal(0, scale) by numpy instead."""
    dt, dj = _rec_dataset(official)
    jm = j_build_model("lightgcn", hidden_size=hidden, num_layers=3)
    wj = j_fetch_wrapper("recommendation")(jm, dj, topk=topk)
    gj = wj.prepare_graph(dj.graph)
    variables = _host(wj.init(jax.random.PRNGKey(0), gj))
    if scale is not None:
        emb = variables["params"]["emb"]
        variables["params"]["emb"] = np.random.default_rng(11).normal(
            0.0, scale, emb.shape).astype(np.float32)
    tm = build_model("lightgcn", hidden_size=hidden, num_layers=3)
    wt = RecommendationWrapper(tm, dt, topk=topk)
    gt = wt.prepare_graph(dt.graph)
    if structure:
        gt = prepare_spmm(gt)
    load_jax_params(tm, variables["params"])
    return wj, gj, variables, wt, gt


@pytest.mark.parametrize("official", [False, True])
def test_rec_prepared_graph_and_sets_equal_jax(official):
    """The graph after the hold-out (or as it is, with official
    positives), the users evaluated, their targets and the items each has
    in the graph."""
    wj, gj, _, wt, gt = _rec_pair(official)
    for f in ("row_ptr", "row", "col"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)))
    assert gt.num_edges == gj.num_edges and gt.e_pad == gj.e_pad
    assert gt.meta_get("norm") == "sym"
    assert list(wt.eval_users) == sorted(wj._eval_pos)
    nu = wt.num_users

    def as_sets(pairs):
        slot, item, ptr = (np.asarray(p) for p in pairs)
        return [set(item[ptr[i]: ptr[i + 1]].tolist())
                for i in range(len(wt.eval_users))]

    targets, seen = as_sets(wt._targets), as_sets(wt._seen)
    for i, u in enumerate(wt.eval_users):
        want = wj._eval_pos[u] - nu
        assert targets[i] == set(want.tolist())
        assert wt.target_count[i] == want.size
        assert seen[i] == {j - nu for j in wj._user_pos.get(u, ())}
    if not official:
        assert len(wt.eval_users) > 20 and gt.num_edges < t_rec_graph(
            **REC).num_edges


def test_holdout_matches_the_jax_loop_on_repeated_edges():
    """Repeated interactions: a user counts its distinct items, and every
    copy of the held-out pair goes, both ways."""
    from cogdl_tpu.data.graph import from_coo as j_from_coo
    from cogdl_tpu_torch.data.graph import from_coo

    nu, ni = 4, 5
    pairs = np.array([[0, 5], [0, 6], [0, 6], [1, 7], [1, 7], [2, 5],
                      [2, 8], [3, 8], [2, 8]])
    ei = np.stack([np.r_[pairs[:, 0], pairs[:, 1]],
                   np.r_[pairs[:, 1], pairs[:, 0]]])
    meta = {"num_users": nu, "num_items": ni}
    gj = j_from_coo(ei, num_nodes=nu + ni, meta=meta)
    gt = from_coo(ei, num_nodes=nu + ni, meta=meta)
    kw = dict(hidden_size=4, num_layers=1)
    wj = j_fetch_wrapper("recommendation")(j_build_model("lightgcn", **kw))
    wt = RecommendationWrapper(build_model("lightgcn", **kw))
    pj, pt = wj.prepare_graph(gj), wt.prepare_graph(gt)
    np.testing.assert_array_equal(pt.row.numpy(), np.asarray(pj.row))
    np.testing.assert_array_equal(pt.col.numpy(), np.asarray(pj.col))
    assert list(wt.eval_users) == sorted(wj._eval_pos) == [0, 2]


@pytest.mark.parametrize("structure", [False, True])
def test_lightgcn_forward_and_bpr_grads_equal_jax(structure):
    """The embeddings at 1e-5; the BPR loss at the JAX wrapper's draws for
    a key at 1e-5 and its gradient at 1e-4."""
    wj, gj, v, wt, gt = _rec_pair(structure=structure)
    emb_j = np.asarray(wj.model.apply(v, gj))
    close(wt.model(gt), emb_j)
    key = jax.random.PRNGKey(3)
    r2, r3 = jax.random.split(key)
    eidx = jax.random.randint(r2, (4096,), 0, gj.num_edges)
    neg = jax.random.randint(r3, (4096,), wj.num_users,
                             wj.num_users + wj.num_items)

    def loss_j(params):
        return wj.loss({"params": params}, gj, key)[0]

    lj, gr = jax.value_and_grad(loss_j)(v["params"])
    lt = wt.loss_at(gt, (_t(eidx), _t(neg)))
    lt.backward()
    close(lt, lj)
    close(wt.model.emb.grad, gr["emb"], GRAD_RTOL, GRAD_ATOL)
    assert eidx.shape[0] == wt.draws(gt, torch.Generator())[0].shape[0]


def _untied(scores_j, seen, k):
    """The smallest gap between a user's top ``k + 1`` scores of the items
    it has not seen: positive when none tie."""
    gaps = []
    for row, s in zip(scores_j, seen):
        top = np.sort(np.delete(row, s))[::-1][: k + 1]
        gaps.append(np.min(-np.diff(top)))
    return min(gaps)


@pytest.mark.parametrize("official,topk", [(False, 5), (True, 5),
                                           (False, 40)])
def test_recall_and_ndcg_equal_the_jax_loop(monkeypatch, official, topk):
    """The JAX loop's recall and NDCG to the bit, on weights whose top
    ``k + 1`` unseen scores differ by more than the two packages'
    embeddings can move them (a table drawn from normal(0, 1)); ``topk``
    past the item count too. The chunks of users cut at 7."""
    from cogdl_tpu_torch.wrappers import recommendation as rec_mod

    wj, gj, v, wt, gt = _rec_pair(official, topk=topk, scale=1.0)
    emb = np.asarray(wj.model.apply(v, gj))
    nu = wj.num_users
    users = sorted(wj._eval_pos)
    scores = emb[users] @ emb[nu: nu + wj.num_items].T
    seen = [np.asarray(sorted(wj._user_pos.get(u, ())), np.int64) - nu
            for u in users]
    # a score moves by at most hidden·(2·diff·max|emb| + diff²) between
    # the packages, so no gap of twice that can close
    diff = float(np.abs(wt.model(gt).detach().numpy() - emb).max())
    moves = emb.shape[1] * (2 * diff * float(np.abs(emb).max()) + diff ** 2)
    assert _untied(scores, seen, min(topk, wj.num_items - 1)) > 4 * moves
    want = wj.evaluate(v, gj)
    monkeypatch.setattr(rec_mod, "SCORE_CHUNK", 7 * wj.num_items)
    got = wt.evaluate(gt)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    assert 0.0 < got["test_recall"] <= 1.0


def test_lightgcn_initialises_for_its_graph():
    """``emb`` takes the graph's ``n_pad`` rows from normal(0, 0.1), the
    same for the same seed; a table of other rows raises."""
    _, _, _, wt, gt = _rec_pair()
    m = wt.model
    m.reset_parameters(torch.Generator().manual_seed(0), gt)
    a = m.emb.detach().clone()
    assert a.shape == (gt.n_pad, 8) and abs(float(a.std()) - 0.1) < 0.02
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(a, m.emb)
    other = build_model("lightgcn", hidden_size=8, num_nodes=gt.n_pad - 8)
    with pytest.raises(ValueError, match="initialise it"):
        other(gt)


# -- the traffic models -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_traffic_ref(name):
    """The JAX model's side, once a model: its variables, the input
    window, the loss's weights, the output and the gradients of
    ``Σ (out · w)²``."""
    gj = j_traffic(**TRAFFIC)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, 12, gj.n_pad, 1)).astype(np.float32)
    w = rng.normal(size=(BATCH, gj.n_pad, 1)).astype(np.float32)
    jm = j_build_model(name, in_features=1, out_features=1,
                       **TRAFFIC_MODELS[name])
    # jitted: a few seconds where the eager vmapped layers take tens
    v = _host(jax.jit(lambda k: jm.init({"params": k, "dropout": k}, gj,
                                        jnp.asarray(x)))(
        jax.random.PRNGKey(1)))

    def out_j(params):
        return jm.apply({"params": params}, gj, jnp.asarray(x))

    def loss_j(params):
        return jnp.sum((out_j(params) * w) ** 2)

    return (v, x, w, np.asarray(jax.jit(out_j)(v["params"])),
            _host(jax.jit(jax.grad(loss_j))(v["params"])))


def assert_grads(model, name, grads_j):
    """``model``'s gradients against the JAX tree ``grads_j`` at 1e-4."""
    want = build_model(name, in_features=1, out_features=1,
                       **TRAFFIC_MODELS[name])
    load_jax_params(want, grads_j)
    got = dict(model.named_parameters())
    for k, p in want.named_parameters():
        close(got[k].grad, p.detach(), GRAD_RTOL, GRAD_ATOL, msg=k)


@pytest.mark.parametrize("structure", [None, False, True])
@pytest.mark.parametrize("name", sorted(TRAFFIC_MODELS))
def test_traffic_models_match_jax(name, structure):
    """Forward at 1e-5 and the gradients of a squared loss at 1e-4: the
    model's own unions (None), the wrapper's without and with the
    kernels' structure."""
    v, x, w, out_j, grads_j = _jax_traffic_ref(name)
    gt = t_traffic(**TRAFFIC)
    tm = build_model(name, in_features=1, out_features=1,
                     **TRAFFIC_MODELS[name])
    load_jax_params(tm, v["params"])
    if structure is not None:
        gt = tm.prepare_unions(gt, BATCH, 12, structure=structure)
    out = tm(gt, _t(x))
    close(out, out_j)
    ((out * _t(w)) ** 2).sum().backward()
    assert_grads(tm, name, grads_j)


def test_union_rows_line_up_with_the_windows():
    """The union of ``c`` copies: ``spmm`` over it equals ``spmm`` over
    each slice of ``[c, n_pad, F]``, pad rows included; ``n_pad`` and the
    edges are ``c`` times the graph's, no pad edge, K1's structure built
    over it gives the same; a model builds a copy count's union once."""
    g = sym_norm(t_traffic(**TRAFFIC))
    c = 5
    u = block_union(g, c)
    assert (u.n_pad, u.num_nodes) == (c * g.n_pad,) * 2
    assert (u.e_pad, u.num_edges) == (c * g.num_edges,) * 2
    assert u.meta_get("copies") == c and u.meta_get("norm") == "sym"
    x = torch.randn(c, g.n_pad, 3, generator=torch.Generator().manual_seed(0))
    want = torch.stack([spmm(g, xi) for xi in x])
    torch.testing.assert_close(spmm(u, x.reshape(-1, 3)).view(c, g.n_pad, 3),
                               want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(spmm(prepare_spmm(u), x.reshape(-1, 3)),
                               want.reshape(-1, 3), rtol=1e-6, atol=1e-6)
    m = build_model("stgcn", in_features=1, **TRAFFIC_MODELS["stgcn"])
    assert m.spatial_steps(12) == [10, 6]
    assert m.slice_union(g, 20) is m.slice_union(g, 20)
    with pytest.raises(ValueError, match="node rows"):
        m(g, torch.zeros(1, 12, g.n_pad - 1, 1))


def test_stgat_keeps_k3_under_its_head_limit():
    """STGAT's layer runs over the union at its own ``nhead`` heads (the
    slices are not folded into heads), and with no attention dropout."""
    m = build_model("stgat", in_features=1, hidden_size=32, nhead=4)
    assert m.gat0.nhead == 4 and m.gat0.out_features == 8
    assert m.gat0.attn_drop == 0.0


# -- the traffic wrapper ------------------------------------------------------

def _traffic_wrappers(name="stgcn", batch_size=4, structure=False):
    gj, gt = j_traffic(**TRAFFIC), t_traffic(**TRAFFIC)
    kw = dict(in_features=1, out_features=1, **TRAFFIC_MODELS[name])
    wj = j_fetch_wrapper("traffic_prediction")(j_build_model(name, **kw),
                                               batch_size=batch_size, seed=3)
    pj = wj.prepare_graph(gj)
    v = _host(jax.jit(lambda k: wj.init(k, pj))(jax.random.PRNGKey(2)))
    wt = TrafficPredictionWrapper(build_model(name, **kw),
                                  batch_size=batch_size, seed=3)
    pt = wt.prepare_graph(gt)
    if structure:
        pt = wt.model.prepare_unions(pt, batch_size, 12, structure=True)
    load_jax_params(wt.model, v["params"])
    return wj, pj, v, wt, pt


@functools.lru_cache(maxsize=None)
def _jax_wrapper_ref(name):
    """The JAX wrapper's side, once a model: the loss of its second
    training batch and its gradients, and its metrics."""
    wj, pj, v, _, _ = _traffic_wrappers(name)
    batch = wj.train_batches(pj)[1]

    def loss_j(params):
        return wj.loss({"params": params}, batch, jax.random.PRNGKey(0),
                       training=True)[0]

    lj, gr = jax.jit(jax.value_and_grad(loss_j))(v["params"])
    return float(lj), _host(gr), wj.evaluate(v, pj)


def test_windows_split_and_batches_equal_jax():
    """Each split's windows and targets, sliced on the device, equal the
    JAX wrapper's arrays; the training batches are its permutation's,
    whole batches only; the model's unions are built for the batch's slice
    counts."""
    wj, pj, _, wt, pt = _traffic_wrappers()
    for split, (X, Y) in wj._splits.items():
        lo, hi = wt.splits[split]
        assert hi - lo == X.shape[0]
        x, y = wt.windows(torch.arange(lo, hi))
        np.testing.assert_array_equal(x.numpy(), X)
        np.testing.assert_array_equal(y.numpy(), Y)
    bj, bt = wj.train_batches(pj), wt.train_batches(pt)
    assert len(bt) == len(bj) == wt.splits["train"][1] // 4
    for (_, xj, yj), (g, starts) in zip(bj, bt):
        x, y = wt.windows(starts)
        np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    assert sorted(u.meta_get("copies") for u in
                  pt.extras["slice_unions"]) == [4 * 6, 4 * 10]
    assert pt.meta_get("norm") == "sym"


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", sorted(TRAFFIC_MODELS))
def test_traffic_loss_and_metrics_equal_jax(name, structure):
    """The masked MSE of a batch at 1e-5 and its gradients at 1e-4; MAE
    and RMSE over the validation and test batches at 1e-5."""
    lj, grads_j, want = _jax_wrapper_ref(name)
    _, _, _, wt, pt = _traffic_wrappers(name, structure=structure)
    lt = wt.loss((pt, wt.train_batches(pt)[1][1]), None)
    lt.backward()
    close(lt, lj)
    assert_grads(wt.model, name, grads_j)
    have = wt.evaluate(pt)
    assert set(have) == set(want) == {"val_mae", "val_rmse", "test_mae",
                                      "test_rmse"}
    for k in want:
        assert abs(have[k] - want[k]) <= 1e-5 * abs(want[k]), k


def test_a_series_too_short_for_a_batch():
    """Fewer training windows than a batch: one batch of all of them, and
    no evaluation batch (the metrics 0), as in the JAX wrapper."""
    wj, pj, v, wt, pt = _traffic_wrappers(batch_size=64)
    (_, xj, _), = wj.train_batches(pj)
    (_, starts), = wt.train_batches(pt)
    assert starts.tolist() == list(range(xj.shape[0]))
    assert wt.evaluate(pt) == wj.evaluate(v, pj)


# -- through experiment() -----------------------------------------------------

TRAFFIC_CURVES = {"stgcn": dict(hidden_size=8, spatial_channels=4),
                  "stgat": dict(hidden_size=8)}


def _jax_initial_params(monkeypatch, j_cls, t_cls):
    """Record the initial variables the JAX trainer's wrapper of class
    ``j_cls`` makes, and have the port's wrapper of class ``t_cls`` load
    them after its own ``init``: the same run's start in both packages."""
    box = []
    j_init, t_init = j_cls.init, t_cls.init

    def record(self, rng, graph):
        box.append(_host(j_init(self, rng, graph)["params"]))
        return j_init(self, rng, graph)

    def load(self, generator, graph):
        t_init(self, generator, graph)
        load_jax_params(self.model, box[-1])

    monkeypatch.setattr(j_cls, "init", record)
    monkeypatch.setattr(t_cls, "init", load)


@pytest.mark.parametrize("model", sorted(TRAFFIC_CURVES))
def test_traffic_loss_curve_matches_the_jax_trainer(monkeypatch, model):
    """``experiment()`` against ``cogdl_tpu.experiments.train`` on
    ``traffic-synthetic`` from the JAX trainer's initial weights, in the
    batch order each draws for the seed (the same): the same train loss
    at every epoch and the same test MAE."""
    from cogdl_tpu.datasets.dataset import Dataset as JD
    from cogdl_tpu.wrappers.traffic_prediction import (
        TrafficPredictionWrapper as JTraffic,
    )

    epochs = 3
    run = dict(epochs=epochs, eval_step=1, patience=100, seed=2,
               batch_size=8, **TRAFFIC_CURVES[model])
    data = dict(num_nodes=20, num_steps=150)
    _jax_initial_params(monkeypatch, JTraffic, TrafficPredictionWrapper)
    rec = _Recorder()
    res_j = j_train(JD.from_graph(j_traffic(**data), "traffic",
                                  metric="mae"), model, logger=rec, **run)
    ds = Dataset.from_graph(t_traffic(**data), "traffic", metric="mae")
    steps = _step_losses(monkeypatch)
    (res,) = experiment(dataset=ds, model=model, device="cpu",
                        **run)[("traffic", model)]
    per_epoch = np.asarray(steps).reshape(epochs, -1).mean(1)
    np.testing.assert_allclose(per_epoch, rec.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert abs(res["test_mae"] - res_j["test_mae"]) <= LOSS_TOL


def _step_losses(monkeypatch):
    steps = []
    real_step = Trainer.train_step

    def step(self, *a):
        loss = real_step(self, *a)
        steps.append(float(loss))
        return loss

    monkeypatch.setattr(Trainer, "train_step", step)
    return steps


def _jax_bpr_draws(seed: int, wrapper, graph):
    """The JAX wrapper's ``randint`` draws at each step of the JAX
    trainer's run of ``seed`` (the step keys split off after the init
    key), over ``wrapper``'s prepared ``graph``."""
    rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    while True:
        rng, key = jax.random.split(rng)
        r2, r3 = jax.random.split(key)
        yield tuple(torch.from_numpy(np.asarray(d).astype(np.int64)) for d in (
            jax.random.randint(r2, (4096,), 0, graph.num_edges),
            jax.random.randint(r3, (4096,), wrapper.num_users,
                               wrapper.num_users + wrapper.num_items)))


def test_lightgcn_loss_curve_matches_the_jax_trainer(monkeypatch):
    """LightGCN on the rec graph through ``experiment()`` against the JAX
    trainer, from its initial table and at its BPR draws (injected through
    ``draws``): the same loss at every epoch, and the same recall at the
    end."""
    from cogdl_tpu.wrappers.recommendation import (
        RecommendationWrapper as JRec,
    )

    epochs = 4
    run = dict(epochs=epochs, eval_step=1, patience=100, seed=3,
               weight_decay=0.0, hidden_size=8)
    _jax_initial_params(monkeypatch, JRec, RecommendationWrapper)
    rec = _Recorder()
    res_j = j_train(JDataset.from_graph(j_rec_graph(**REC), "rec"),
                    "lightgcn", logger=rec, **run)
    streams = {}

    def draws(self, graph, generator):
        if self not in streams:
            streams[self] = _jax_bpr_draws(run["seed"], self, graph)
        return next(streams[self])

    monkeypatch.setattr(RecommendationWrapper, "draws", draws)
    steps = _step_losses(monkeypatch)
    (res,) = experiment(dataset=Dataset.from_graph(t_rec_graph(**REC),
                                                   "rec"),
                        model="lightgcn", device="cpu", **run)[("rec",
                                                                "lightgcn")]
    np.testing.assert_allclose(steps, rec.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert res["test_recall"] == res_j["test_recall"]


def test_bpr_draws_come_from_the_generator_on_the_graphs_device():
    """The wrapper's draws: edge slots over the graph's real edges and
    items over the item rows, as int64 on the graph's device, the same
    for the same generator state and others for another."""
    _, _, _, wt, gt = _rec_pair()
    a = wt.draws(gt, torch.Generator().manual_seed(1))
    b = wt.draws(gt, torch.Generator().manual_seed(1))
    c = wt.draws(gt, torch.Generator().manual_seed(2))
    eidx, neg = a
    assert eidx.shape == neg.shape == (4096,)
    assert eidx.dtype == neg.dtype == torch.int64
    assert eidx.device == neg.device == gt.device
    assert 0 <= int(eidx.min()) and int(eidx.max()) < gt.num_edges
    assert wt.num_users <= int(neg.min())
    assert int(neg.max()) < wt.num_users + wt.num_items
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(eidx, c[0]) and not torch.equal(neg, c[1])
    # the loss at the draws is the wrapper's loss at that generator state
    assert float(wt.loss_at(gt, a).detach()) == float(
        wt.loss(gt, torch.Generator().manual_seed(1)).detach())


@pytest.mark.parametrize("model", ["lightgcn", "stgcn", "stgat"])
def test_wrappers_initialise_from_the_generator(model):
    """``init`` draws every parameter from ``generator``: the same seed
    gives the same weights, another seed others; biases start at zero and
    LayerNorm scales at one, as flax starts them."""
    if model == "lightgcn":
        _, _, _, wt, gt = _rec_pair()
    else:
        kw = dict(in_features=1, out_features=1, **TRAFFIC_MODELS[model])
        wt = TrafficPredictionWrapper(build_model(model, **kw), batch_size=4)
        gt = wt.prepare_graph(t_traffic(**TRAFFIC))

    def weights(seed):
        wt.init(torch.Generator().manual_seed(seed), gt)
        return {k: p.detach().clone()
                for k, p in wt.model.named_parameters()}

    a, b, c = weights(0), weights(0), weights(1)
    assert a and set(a) == set(b) == set(c)
    for k in a:
        assert torch.isfinite(a[k]).all(), k
        assert torch.equal(a[k], b[k]), k
        if k.endswith("bias"):
            assert not a[k].any(), k
        elif k.startswith("ln") or ".ln." in k:
            assert torch.equal(a[k], torch.ones_like(a[k])), k
        else:
            assert not torch.equal(a[k], c[k]), k


def test_a_model_keeps_only_the_last_graphs_unions():
    """A model called on graphs without their unions keeps the unions of
    the last such graph only: the same union on a second call on it, a
    new one after a call on another graph."""
    m = build_model("stgcn", in_features=1, **TRAFFIC_MODELS["stgcn"])
    g1 = t_traffic(**TRAFFIC)
    g2 = t_traffic(**dict(TRAFFIC, seed=2))
    u1 = m.slice_union(g1, 4)
    assert m.slice_union(g1, 4) is u1 and m.slice_union(g1, 8) is not u1
    u2 = m.slice_union(g2, 4)
    assert u2 is not u1 and m._union_cache[0] is g2
    assert set(m._union_cache[1]) == {4}
    assert m.slice_union(g1, 4) is not u1


# -- the JAX package from the port's initial weights --------------------------

def port_weights_as_flax(model, params):
    """The flax tree ``params`` (the JAX model's) holding ``model``'s
    weights: ``load_jax_params`` run on a tree of element numbers shows
    where each flax element lands among the port's parameters, and the
    port's values are gathered back through it."""
    leaves, treedef = jax.tree.flatten(_host(params))
    starts = np.cumsum([0] + [leaf.size for leaf in leaves])
    probe = copy.deepcopy(model)
    with torch.no_grad():
        for p in probe.parameters():
            p.fill_(-1.0)
    load_jax_params(probe, treedef.unflatten([
        np.arange(a, a + leaf.size, dtype=np.float32).reshape(leaf.shape)
        for a, leaf in zip(starts, leaves)]))
    where = torch.cat([p.detach().reshape(-1) for p in probe.parameters()])
    values = torch.cat([p.detach().reshape(-1).cpu()
                        for p in model.parameters()])
    where = where.numpy().astype(np.int64)
    # every flax element has one place in the port, and every place one
    assert sorted(where) == list(range(starts[-1]))
    flat = np.empty(starts[-1], np.float32)
    flat[where] = values.numpy()
    return treedef.unflatten([flat[a: a + leaf.size].reshape(leaf.shape)
                              for a, leaf in zip(starts, leaves)])


def runs_from_the_ports_weights(t_dataset, j_dataset, model, seed,
                                weights=None, **run):
    """One traffic model's run through the port's ``experiment()`` on the
    CPU from its own initial weights for ``seed`` (or from ``weights``,
    ``{parameter name: array}``, loaded over them), and the JAX trainer's
    run of the same seed from those weights (its wrapper's ``init``
    replaced): ``(port result, JAX result, the port's step losses, the
    JAX trainer's epoch losses, the port's initial model)``. A traffic step draws nothing and both
    wrappers order the batches from the seed alike, so the runs differ by
    their arithmetic only."""
    from cogdl_tpu.wrappers.traffic_prediction import (
        TrafficPredictionWrapper as JTraffic,
    )

    start, steps = [], []
    t_init, j_init = TrafficPredictionWrapper.init, JTraffic.init
    real_step = Trainer.train_step

    def record(self, generator, graph):
        t_init(self, generator, graph)
        if weights is not None:
            with torch.no_grad():
                for k, p in self.model.named_parameters():
                    p.copy_(torch.from_numpy(weights[k]))
        start.append(copy.deepcopy(self.model))

    def step(self, *a):
        loss = real_step(self, *a)
        steps.append(float(loss))
        return loss

    def from_port(self, rng, graph):
        v = j_init(self, rng, graph)
        return {**v, "params": port_weights_as_flax(start[-1], v["params"])}

    with mock.patch.object(TrafficPredictionWrapper, "init", record), \
            mock.patch.object(Trainer, "train_step", step):
        (res,) = next(iter(experiment(dataset=t_dataset, model=model,
                                      seed=seed, device="cpu",
                                      **run).values()))
    rec = _Recorder()
    with mock.patch.object(JTraffic, "init", from_port):
        res_j = j_train(j_dataset, model, seed=seed, logger=rec, **run)
    return res, res_j, steps, rec.losses, start[-1]


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("model", sorted(TRAFFIC_CURVES))
def test_the_jax_package_trains_from_the_ports_initial_weights(model, given):
    """The bridge the card's quality bars are computed through: the JAX
    trainer started from the port's torch-drawn weights for a seed (or
    from weights given for it, here another seed's) gives the port's
    train loss at every epoch and its test MAE within 1e-4."""
    from cogdl_tpu.datasets.dataset import Dataset as JD
    from cogdl_tpu_torch.experiments import _setup_variant

    epochs = 2
    data = dict(num_nodes=20, num_steps=150)
    run = dict(epochs=epochs, eval_step=1, patience=100, batch_size=8,
               **TRAFFIC_CURVES[model])
    ds = Dataset.from_graph(t_traffic(**data), "traffic", metric="mae")
    weights = None
    if given:
        w, net, _ = _setup_variant(ds, model, 9, None, dict(run))
        w.init(torch.Generator().manual_seed(9), w.prepare_graph(ds.graph))
        weights = {k: p.detach().numpy().copy()
                   for k, p in net.named_parameters()}
    res, res_j, steps, losses_j, start = runs_from_the_ports_weights(
        ds, JD.from_graph(j_traffic(**data), "traffic", metric="mae"),
        model, seed=5, weights=weights, **run)
    if given:
        for k, p in start.named_parameters():
            assert np.array_equal(p.detach().numpy(), weights[k]), k
    np.testing.assert_allclose(np.asarray(steps).reshape(epochs, -1).mean(1),
                               losses_j, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert abs(res["test_mae"] - res_j["test_mae"]) <= LOSS_TOL


def test_port_weights_as_flax_inverts_load_jax_params():
    """Loading the gathered tree back gives the port's weights exactly."""
    v, _, _, _, _ = _jax_traffic_ref("stgat")
    tm = build_model("stgat", in_features=1, out_features=1,
                     **TRAFFIC_MODELS["stgat"])
    tm.reset_parameters(torch.Generator().manual_seed(3), window=12)
    back = build_model("stgat", in_features=1, out_features=1,
                       **TRAFFIC_MODELS["stgat"])
    load_jax_params(back, port_weights_as_flax(tm, v["params"]))
    for (k, a), (_, b) in zip(tm.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), k


def quality_reference(label: str, seeds, weights=None):
    """For each seed of ``chip_smoke.py``'s quality run ``label``
    (``REC_TRAFFIC_QUALITY_RUNS``): the JAX package's test metric and the
    port's own on the CPU. A traffic model's JAX run starts from the
    port's initial weights for the seed, those this torch draws, or
    ``weights[seed]`` (``{parameter name: array}``, as
    ``chip_smoke.quality_initial_weights`` gives them on another
    machine); LightGCN's are each package's own runs (its BPR draws are
    made on the card, which the JAX package cannot replay).
    ``REC_TRAFFIC_JAX_SCORE`` holds the mean of the JAX package's over the
    seeds."""
    import chip_smoke as cs

    dataset, model, kw, key, _, _ = cs.REC_TRAFFIC_QUALITY_RUNS[label]
    out = {"label": label, "seeds": list(seeds), "jax": [], "port": []}
    for seed in seeds:
        if model == "lightgcn":
            res_j = j_train(dataset, model, seed=seed, **kw)
            (res,) = next(iter(experiment(dataset=dataset, model=model,
                                          seed=seed, device="cpu",
                                          **kw).values()))
        else:
            res, res_j, _, _, _ = runs_from_the_ports_weights(
                dataset, dataset, model, seed,
                None if weights is None else weights[seed], **kw)
        out["jax"].append(float(res_j[key]))
        out["port"].append(float(res[key]))
    return out


@pytest.mark.parametrize("dataset,model,kw", [
    ("rec-synthetic", "lightgcn", dict(hidden_size=8)),
    ("traffic-synthetic", "stgcn", dict(batch_size=8, hidden_size=8,
                                        spatial_channels=4)),
    ("traffic-synthetic", "stgat", dict(batch_size=8, hidden_size=8)),
])
def test_experiment_runs_each_name_on_the_cpu(dataset, model, kw):
    """Each name on its default wrapper through ``experiment()``, no kernel
    launched on the CPU; the same call without ``device`` raises where
    torch sees no card."""
    sk.reset_launch_counts()
    (res,) = experiment(dataset=dataset, model=model, epochs=1, eval_step=1,
                        device="cpu", **kw)[(dataset, model)]
    assert np.isfinite(res["train_loss"])
    metric = "test_recall" if model == "lightgcn" else "test_mae"
    assert 0.0 <= res[metric] < 5.0
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            experiment(dataset=dataset, model=model, epochs=1, **kw)


def test_models_carry_the_kernel_flags_and_defaults():
    """LightGCN and STGCN normalise inside their forward (``adj_norm``)
    and propagate (``calls_spmm``); STGAT reads the graph as it is through
    its GAT layer; the defaults and BEST_CONFIGS are the JAX package's."""
    from cogdl_tpu.configs import BEST_CONFIGS as J
    from cogdl_tpu.wrappers import DEFAULT_WRAPPER as JW
    from cogdl_tpu_torch.configs import BEST_CONFIGS as T

    for name, norm in (("lightgcn", "sym"), ("stgcn", "sym"),
                       ("stgat", None)):
        m = build_model(name, in_features=1, out_features=1)
        assert reads_kernel_structure(m), name
        assert getattr(m, "adj_norm", None) == norm, name
        assert DEFAULT_WRAPPER[name] == JW[name]
    for name in ("lightgcn", "stgcn"):
        assert T[name] == J[name]
    for name in ("recommendation", "traffic_prediction"):
        assert fetch_wrapper(name).__name__ == j_fetch_wrapper(
            name).__name__


# -- the accumulating evaluators ----------------------------------------------

@pytest.mark.parametrize("name", ["accuracy", "acc", "microf1", "mae"])
def test_evaluators_equal_jax(name):
    """Three calls with and without masks accumulate as the JAX classes
    do; ``clear`` starts over; an empty evaluator gives 0."""
    rng = np.random.default_rng(len(name))
    ej, et = j_ev.build_evaluator(name), t_ev.build_evaluator(name)
    assert type(et).__name__ == type(ej).__name__
    assert et.evaluate() == ej.evaluate() == 0.0
    for i in range(3):
        n = 20 + i
        if name == "mae":
            a = rng.normal(size=(n, 3)).astype(np.float32)
            b = rng.normal(size=(n, 3)).astype(np.float32)
        elif name == "microf1":
            a = rng.normal(size=(n, 4)).astype(np.float32)
            b = rng.integers(0, 2, (n, 4))
        else:
            a = rng.normal(size=(n, 5)).astype(np.float32)
            b = rng.integers(0, 5, n)
        mask = None if i == 1 else rng.random(n) < 0.6
        got = et(_t(a), _t(b), None if mask is None else _t(mask))
        want = ej(jnp.asarray(a), jnp.asarray(b),
                  None if mask is None else jnp.asarray(mask))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), i
    et.clear()
    assert et.evaluate() == 0.0
    with pytest.raises(KeyError):
        t_ev.build_evaluator("recall")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_rec_traffic.py LABEL FIRST END
    # [WEIGHTS.npz]: quality_reference over seeds FIRST .. END - 1, one
    # JSON line; WEIGHTS.npz holds the initial weights as
    # "LABEL/SEED/NAME" arrays (chip_smoke.quality_initial_weights)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    label, first, end = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    given = None
    if len(sys.argv) > 4:
        given = {}
        with np.load(sys.argv[4]) as npz:
            for key in npz.files:
                lab, seed, name = key.split("/", 2)
                if lab == label:
                    given.setdefault(int(seed), {})[name] = npz[key]
    print(json.dumps(quality_reference(label, range(first, end), given)))
