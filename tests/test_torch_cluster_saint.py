"""cogdl_tpu_torch's cluster and GraphSAINT path against the JAX package on
the CPU: ``bfs_partition`` and its cache, ``ClusterLoader``, the SAINT
samplers, ``random_partition_batches``, the GraphSAINT estimator and
subgraphs, ``SAINTLayer`` and ``GraphSAINT``, the ``cluster`` and
``graphsaint`` wrappers' loss curves against the JAX trainer, and the
kernel structure the prefetch worker builds for each batch.

Both packages get the same graphs (the port's ``sbm_graph`` draws the JAX
package's arrays) and the same numpy seeds; the samplers are numpy in both,
so their arrays are compared for equality."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu_torch.data.graph as tg
from cogdl_tpu.data import sampling as js
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.layers.saint_layer import SAINTLayer as JSAINTLayer
from cogdl_tpu.models.nn.gcn import GCN as JGCN
from cogdl_tpu.models.nn.graphsaint import GraphSAINT as JGraphSAINT
from cogdl_tpu.wrappers.sampled_node_classification import (
    GraphSAINTWrapper as JGraphSAINTWrapper,
)
from cogdl_tpu_torch.data import sampling as ts
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.layers import SAINTLayer
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.trainer.trainer import Trainer
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from cogdl_tpu_torch.wrappers.sampled_node_classification import (
    ClusterNodeClfWrapper,
    GraphSAINTWrapper,
    reads_kernel_structure,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 on both sides with the same weights, summed in other orders: forward
# 1e-5, grads 1e-4
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
# the symmetric normalisation sums degrees in another order in each
# package: fp32, a few ulps (tests/test_torch_graph.py)
W_RTOL, W_ATOL = 1e-6, 1e-7
# per-epoch mean losses after a few Adam steps from the same weights over
# the same batches (tests/test_torch_sampling.py's tolerance)
LOSS_RTOL = 1e-4
NODE_FIELDS = ("x", "y", "train_mask")
EDGE_FIELDS = ("row_ptr", "row", "col", "edge_weight")


@pytest.fixture(scope="module")
def graphs():
    """The JAX package's sbm graph with self loops and sym norm, and the
    port's Graph carrying the same arrays (weights included, bit for
    bit)."""
    gj = jg.sym_norm(jg.add_self_loops(j_sbm(num_nodes=300, seed=1)))
    fields = {f: torch.from_numpy(np.array(getattr(gj, f)))
              for f in EDGE_FIELDS + NODE_FIELDS}
    gt = tg.Graph(num_nodes=gj.num_nodes, num_edges=gj.num_edges,
                  meta=gj.meta, **fields)
    return gj, gt


def _assert_same_batch(bj, bt, exact_weights=True):
    assert (bj.num_nodes, bj.num_edges, bj.n_pad, bj.e_pad) == (
        bt.num_nodes, bt.num_edges, bt.n_pad, bt.e_pad)
    # prepare_spmm, which the worker runs for a model that reads it, adds
    # spmm_panel_rows
    meta_t = {k: v for k, v in bt.meta if k != "spmm_panel_rows"}
    assert dict(bj.meta) == meta_t
    for f in ("row_ptr", "row", "col") + NODE_FIELDS:
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)), err_msg=f)
    w_t, w_j = bt.edge_weight.numpy(), np.asarray(bj.edge_weight)
    if exact_weights:
        np.testing.assert_array_equal(w_t, w_j)
    else:
        np.testing.assert_allclose(w_t, w_j, rtol=W_RTOL, atol=W_ATOL)


# -- the samplers --------------------------------------------------------------

@pytest.mark.parametrize("weights", [None, "degree", "array"])
def test_bfs_partition_matches_jax(graphs, weights):
    gj, gt = graphs
    if weights == "array":
        weights = np.random.default_rng(4).integers(1, 5, gj.num_nodes)
    kw = dict(seed=3, weights=weights, node_slack=1.3)
    part = ts.bfs_partition(gt, 7, **kw)
    np.testing.assert_array_equal(part, js.bfs_partition(gj, 7, **kw))
    assert part.min() == 0 and part.max() == 6


def test_bfs_partition_cache_names_the_file_as_jax_and_round_trips(
        graphs, tmp_path, monkeypatch):
    """The same graph and parameters give the same file name in both
    packages (the digest hashes the int32 edge arrays); a second call reads
    the file instead of partitioning; nothing is written outside
    ``cache_dir``."""
    gj, gt = graphs
    weights = np.arange(gj.num_nodes) % 3 + 1
    for w in (None, "degree", weights):
        part_t = ts.bfs_partition_cached(gt, 5, seed=2, weights=w,
                                         cache_dir=str(tmp_path / "t"))
        part_j = js.bfs_partition_cached(gj, 5, seed=2, weights=w,
                                         cache_dir=str(tmp_path / "j"))
        np.testing.assert_array_equal(part_t, part_j)
    names = sorted(os.listdir(tmp_path / "t"))
    assert len(names) == 3 and names == sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path)) == ["j", "t"]
    monkeypatch.setattr(ts, "bfs_partition", lambda *a, **k: pytest.fail(
        "partitioned again despite the cache"))
    again = ts.bfs_partition_cached(gt, 5, seed=2, weights="degree",
                                    cache_dir=str(tmp_path / "t"))
    np.testing.assert_array_equal(
        again, js.bfs_partition(gj, 5, seed=2, weights="degree"))
    # the digest is memoized per edge-array identity
    digest = ts._structure_digest(gt.row, gt.col, gt.num_edges)
    assert ts._DIGEST_CACHE[(id(gt.row), id(gt.col), gt.num_edges)][2] == digest


def test_cluster_loader_matches_jax_over_two_epochs(graphs):
    gj, gt = graphs
    lj = js.ClusterLoader(gj, n_clusters=6, batch_size=2, seed=3)
    lt = ts.ClusterLoader(gt, n_clusters=6, batch_size=2, seed=3)
    np.testing.assert_array_equal(lt.part, lj.part)
    assert lt.n_pad == lj.n_pad
    for _ in range(2):
        bjs, bts = list(lj.epoch()), list(lt.epoch())
        assert len(bts) == len(bjs) == 3
        for bj, bt in zip(bjs, bts):
            _assert_same_batch(bj, bt)
        assert lt.e_pad == lj.e_pad
    assert sum(b.num_nodes for b in bts) == gt.num_nodes


def test_random_partition_batches_match_jax(graphs):
    gj, gt = graphs
    bjs = list(js.random_partition_batches(gj, 4, seed=6))
    bts = list(ts.random_partition_batches(gt, 4, seed=6))
    assert len(bts) == len(bjs) == 4
    for bj, bt in zip(bjs, bts):
        _assert_same_batch(bj, bt)


def test_saint_samplers_match_jax(graphs):
    gj, gt = graphs
    rj, rt = np.random.default_rng(8), np.random.default_rng(8)
    csr = ts.graph_csr(gt)
    for _ in range(3):
        np.testing.assert_array_equal(ts.saint_node_subgraph(gt, 50, rt),
                                      js.saint_node_subgraph(gj, 50, rj))
        walk_j = js.saint_walk_subgraph(gj, 20, 3, rj)
        np.testing.assert_array_equal(ts.saint_walk_subgraph(gt, 20, 3, rt),
                                      walk_j)
        # a kept CSR gives the same draws
        np.testing.assert_array_equal(
            ts.saint_walk_subgraph(gt, 20, 3, np.random.default_rng(1),
                                   csr=csr),
            js.saint_walk_subgraph(gj, 20, 3, np.random.default_rng(1)))


# -- the GraphSAINT estimator and subgraphs ------------------------------------

SAMPLERS = {"walk": dict(sampler="walk", walk_roots=24, walk_length=3),
            "node": dict(sampler="node", sample_size=90)}


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_graphsaint_estimator_and_subgraphs_match_jax(sampler):
    """``prepare_graph``'s ``norm_loss`` and ``norm_aggr`` equal, and the
    subgraphs of two epochs equal, ``extras["norm_loss"]`` and ``meta``
    included (weights to the normalisation's few ulps)."""
    kw = dict(SAMPLERS[sampler], batches_per_epoch=3, est_samples=12,
              seed=5)
    gj = j_sbm(num_nodes=300, seed=1)
    gt = t_sbm(num_nodes=300, seed=1)
    mkw = dict(in_features=gt.num_features, out_features=4, hidden_size=8)
    wj = JGraphSAINTWrapper(JGraphSAINT(**mkw), **kw)
    wt = GraphSAINTWrapper(build_model("graphsaint", **mkw), **kw)
    pj, pt = wj.prepare_graph(gj), wt.prepare_graph(gt)
    np.testing.assert_array_equal(wt._norm_loss, wj._norm_loss)
    np.testing.assert_array_equal(wt._norm_aggr, wj._norm_aggr)
    for _ in range(2):
        bjs, bts = wj.train_batches(pj), list(wt.train_batches(pt))
        assert len(bts) == len(bjs) == 3
        for bj, bt in zip(bjs, bts):
            _assert_same_batch(bj, bt, exact_weights=False)
            np.testing.assert_array_equal(bt.extras["norm_loss"].numpy(),
                                          np.asarray(bj.extras["norm_loss"]))
            assert dict(bt.meta)["norm"] == "sym"


# -- SAINTLayer and GraphSAINT -------------------------------------------------

def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_grads(tm, grads_j, build):
    ref = build()
    load_jax_params(ref, _host(grads_j))
    ref_params = dict(ref.named_parameters())
    for pname, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[pname].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=pname)


class _SAINTLayerNet(torch.nn.Module):
    """One SAINTLayer under the flax name ``layer``."""

    def __init__(self, **kw):
        super().__init__()
        self.layer = SAINTLayer(**kw)

    def forward(self, graph, x):
        return self.layer(graph, x)


# the layer's width: a LayerNorm over a few ReLU outputs, most of them 0,
# divides by a near-zero deviation and amplifies rounding without bound
OUT = 16


@pytest.mark.parametrize("bias", ["norm", "bias"])
@pytest.mark.parametrize("aggr", ["concat", "mean"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_saint_layer_matches_jax(graphs, order, aggr, bias):
    gj, gt = graphs
    x = np.random.default_rng(order).normal(
        size=(gj.n_pad, gj.x.shape[1])).astype(np.float32)
    cfg = dict(order=order, aggr=aggr, bias=bias, dropout=0.0)
    jl = JSAINTLayer(OUT, **cfg)
    params = jl.init(jax.random.PRNGKey(order), gj, jnp.asarray(x))["params"]
    width = OUT * (order + 1) if aggr == "concat" else OUT
    probe = np.random.default_rng(10 + order).normal(
        size=(gj.n_pad, width)).astype(np.float32)

    def loss_j(p):
        out = jl.apply({"params": p}, gj, jnp.asarray(x))
        return jnp.sum(out * probe), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)

    def build():
        return _SAINTLayerNet(in_features=x.shape[1], out_features=OUT,
                              **cfg)

    tm = build()
    load_jax_params(tm, {"layer": _host(params)})
    out_t = tm(gt, torch.from_numpy(x))
    (out_t * torch.from_numpy(probe)).sum().backward()
    assert out_t.shape[1] == width
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    _assert_grads(tm, {"layer": grads_j}, build)


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("architecture", ["1-1-0", "2-0"])
def test_graphsaint_matches_jax(graphs, architecture, structure):
    """Logits and parameter grads of a masked cross-entropy, dropout 0,
    with the JAX weights carried by ``load_jax_params`` (no special case:
    ``layer{i}/order{o}/kernel``, ``layer{i}/norm{o}/scale`` and
    ``classifier/kernel`` map by name). ``structure``: the graph carries
    ``prepare_spmm``'s structure, so ``A·h`` takes K1's plain version."""
    from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
    from cogdl_tpu_torch.ops.cuda import prepare_spmm
    from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy

    gj, gt = graphs
    kw = dict(in_features=gj.x.shape[1], out_features=4, hidden_size=6,
              architecture=architecture, dropout=0.0)
    jm = JGraphSAINT(**kw)
    params = jm.init(jax.random.PRNGKey(1), gj, gj.x)["params"]
    assert set(params["layer0"]) >= {"order0", "norm0"}

    def loss_j(p):
        logits = jm.apply({"params": p}, gj, gj.x)
        return j_mce(logits, gj.y, gj.train_mask), logits

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    tm = build_model("graphsaint", **kw)
    load_jax_params(tm, _host(params))
    g = prepare_spmm(gt) if structure else gt
    out_t = tm(g, g.x)
    masked_cross_entropy(out_t, g.y, g.train_mask).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    _assert_grads(tm, grads_j, lambda: build_model("graphsaint", **kw))


def test_graphsaint_reset_parameters_is_seeded():
    kw = dict(in_features=6, out_features=3, hidden_size=4)
    a, b = build_model("graphsaint", **kw), build_model("graphsaint", **kw)
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(9))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(a.layer0.norm1.weight, torch.ones(4))
    assert a.classifier.in_features == 4   # layer 2 is order 0: 4 wide


# -- the wrappers through experiment() against the JAX trainer ----------------

class _Recorder:
    """A JAX trainer logger that keeps each eval point's train loss."""

    def __init__(self):
        self.losses = []

    def start(self):
        pass

    def note(self, metrics, step):
        self.losses.append(metrics["train_loss"])

    def finish(self):
        pass


CURVES = {
    "graphsaint": ("graphsaint", None, JGraphSAINT,
                   dict(walk_roots=24, walk_length=2, batches_per_epoch=3,
                        est_samples=6, hidden_size=8), 3),
    "cluster-gcn": ("gcn", "cluster", JGCN,
                    dict(n_clusters=8, cluster_batch=2, hidden_size=16), 4),
}


@pytest.mark.parametrize("case", sorted(CURVES))
def test_wrapper_loss_curve_matches_the_jax_trainer(monkeypatch, case):
    """``experiment(model="graphsaint")`` and ``experiment(model="gcn",
    wrapper="cluster")`` against ``cogdl_tpu.experiments.train`` from the
    JAX initial weights, dropout 0: the same per-epoch mean train losses,
    which holds the batches, their weights (``norm_aggr``), the loss's
    ``norm_loss`` weighting and the draws' order over epochs."""
    model, wrapper, jcls, extra, per_epoch = CURVES[case]
    kw = dict(epochs=3, eval_step=1, patience=100, seed=0, dropout=0.0,
              **extra)
    if wrapper:
        kw["wrapper"] = wrapper
    rec = _Recorder()
    res_j = j_train("sbm", model, logger=rec, **kw)
    # the JAX trainer's initial weights: the second half of split(key(seed))
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    gj = j_sbm()
    mkw = {k: v for k, v in extra.items() if k == "hidden_size"}
    params = _host(jcls(in_features=gj.x.shape[1], out_features=4,
                        dropout=0.0, **mkw).init(
        {"params": init_rng, "dropout": init_rng}, gj, gj.x,
        training=False)["params"])
    monkeypatch.setattr(NodeClfWrapper, "init",
                        lambda self, gen, graph: load_jax_params(self.model,
                                                                 params))
    steps = []
    real_step = Trainer.train_step

    def step(self, *a):
        loss = real_step(self, *a)
        steps.append(float(loss))
        return loss

    monkeypatch.setattr(Trainer, "train_step", step)
    res_t = experiment(dataset="sbm", model=model, device="cpu", **kw)
    (res_t,) = res_t[("sbm", model)]
    assert len(steps) == 3 * per_epoch
    means = [np.mean(steps[i * per_epoch: (i + 1) * per_epoch])
             for i in range(3)]
    np.testing.assert_allclose(means, rec.losses, rtol=LOSS_RTOL)
    assert res_t["train_loss"] == pytest.approx(rec.losses[-1], rel=LOSS_RTOL)
    assert res_t["best_epoch"] == res_j["best_epoch"]


# -- the worker's batches carry the kernel structure of their final weights ---

@pytest.mark.parametrize("name,model,kw", [
    ("cluster", "gcn", {}),
    ("graphsaint", "graphsage", {"aggr": "sum", "walk_roots": 24}),
])
def test_batches_carry_the_structure_of_their_final_weights(name, model, kw):
    """The worker applies the model's normalisation before ``prepare_spmm``
    (the cluster batches come unnormalised: GCN normalises them), so the
    structure's weights are the batch's ``edge_weight`` in CSR and CSC
    order, and the model's own normalisation in its forward leaves the
    batch as it is."""
    from cogdl_tpu_torch.wrappers import fetch_wrapper

    gt = t_sbm(num_nodes=300, seed=1)
    net = build_model(model, in_features=gt.num_features, out_features=4,
                      **{k: v for k, v in kw.items() if k == "aggr"})
    assert reads_kernel_structure(net)
    w = fetch_wrapper(name)(net, **{k: v for k, v in kw.items()
                                    if k != "aggr"})
    g = w.prepare_graph(gt)
    batches = list(w.train_batches(g))
    assert batches and len(w.host_ms) == len(batches)
    for b in batches:
        ex = b.extras
        E = b.num_edges
        assert dict(b.meta)["norm"] == "sym"
        assert tg.sym_norm(b) is b
        w_final = b.edge_weight[:E]
        torch.testing.assert_close(ex["spmm_fw_w"], w_final, rtol=0, atol=0)
        torch.testing.assert_close(
            ex["spmm_bw_w"], w_final[ex["spmm_bw_orig"].long()], rtol=0,
            atol=0)
    assert all(ms is not None and ms > 0 for _, ms in w.host_ms)


def test_graphsaint_builds_the_full_graph_structure_after_its_sym_norm(
        monkeypatch):
    """With a model that has no normalisation of its own (GraphSAGE), the
    full graph's structure holds the wrapper's symmetric weights (the
    device gate of ``with_structure`` is opened on the CPU)."""
    from cogdl_tpu_torch.ops.cuda import prepare_spmm

    monkeypatch.setattr(NodeClfWrapper, "with_structure",
                        staticmethod(prepare_spmm))
    gt = t_sbm(num_nodes=300, seed=1)
    net = build_model("graphsage", in_features=gt.num_features,
                      out_features=4, aggr="sum")
    g = GraphSAINTWrapper(net, walk_roots=24, est_samples=4).prepare_graph(gt)
    assert dict(g.meta)["norm"] == "sym"
    torch.testing.assert_close(g.extras["spmm_fw_w"],
                               g.edge_weight[: g.num_edges], rtol=0, atol=0)
    unnormalised = tg.add_self_loops(gt).edge_weight[: g.num_edges]
    assert not torch.equal(g.extras["spmm_fw_w"], unnormalised)


def test_cpu_runs_launch_no_kernel_and_learn():
    sk.reset_launch_counts()
    for model, wrapper in (("graphsaint", None), ("gcn", "cluster")):
        res = experiment(dataset="sbm", model=model, wrapper=wrapper,
                         epochs=20, eval_step=5, device="cpu")
        (res,) = res[("sbm", model)]
        assert res["test_acc"] > 0.9, (model, res)
    assert sk.spmm_csr.launches == 0
