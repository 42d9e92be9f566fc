"""cogdl_tpu_torch's device sampler, GraphSAGE and GAT over its blocks and
the device-sampled wrapper, against the JAX package on the CPU.

``jax.random`` and ``torch`` draw other numbers, so parity is held where
the draws are shared: the port's sampler fed the JAX sampler's own per-hop
uniforms (rebuilt from the same key) gives a bit-equal frame and blocks,
and both packages' models over the same (carried) blocks with the JAX
weights injected give the same logits and grads. Two independent samples
are compared only through what they must both satisfy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu_torch.data.graph as tg
from cogdl_tpu.data import device_sampling as jds
from cogdl_tpu.datasets.synthetic import powerlaw_graph as j_powerlaw
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.models.nn.gat import GAT as JGAT
from cogdl_tpu.models.nn.graphsage import GraphSAGE as JGraphSAGE
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu_torch.data import device_sampling as tds
from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph as t_powerlaw
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.experiments import train
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.trainer.trainer import Trainer
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from cogdl_tpu_torch.wrappers import fetch_wrapper
from cogdl_tpu_torch.wrappers.sampled_node_classification import (
    ClusterNodeClfWrapper,
    DeviceSampledNodeClfWrapper,
    GraphSAINTWrapper,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 on both sides over identical blocks and weights: the dense layers and
# the reshape-reduces sum in other orders. Forward 1e-5; grads 1e-4 (sums
# over the frame's rows of products that cancel)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
B, FANOUTS = 8, (2, 2)
# the test-accuracy bar of tests/test_device_sampling.py
MIN_TEST_ACC = 0.55


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def graphs():
    gj = jg.add_self_loops(j_sbm(num_nodes=300, seed=1))
    gt = tg.add_self_loops(t_sbm(num_nodes=300, seed=1))
    return gj, gt


def _zero_degree_graphs():
    """Node 3 has no edge (no self loops); the pad rows of x, the table's
    sink row among them, hold non-zero values in both packages, as under
    ``device_features`` (it is what a dead slot reads)."""
    ei = np.array([[0, 1, 2, 0, 1], [1, 2, 0, 2, 0]])
    x = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    kw = dict(num_nodes=4, y=np.arange(4) % 2, train_mask=np.ones(4, bool),
              meta={"num_classes": 2})
    gj = jg.from_coo(ei, **kw)
    gt = tg.from_coo(ei, **kw)
    assert gj.n_pad == gt.n_pad == 8
    return gj.replace(x=jnp.asarray(x)), gt.replace(x=torch.from_numpy(x))


def _jax_draws(key, batch, fanouts):
    """The per-hop uniforms ``sample_blocks_device`` draws from ``key``."""
    sizes = jds.plan_sizes(batch, fanouts)
    draws = []
    for k, f in enumerate(fanouts):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(
            np.array(jax.random.uniform(sub, (sizes[k], f)))))
    return draws


def _both(gj, gt, seeds, key, fanouts):
    """The JAX sampler's blocks from ``key`` and the port's from the same
    draws."""
    bj, fj = jds.sample_blocks_device(gj, jnp.asarray(seeds), key, fanouts)
    bt, ft = tds.sample_blocks_from_draws(
        gt, torch.from_numpy(seeds), _jax_draws(key, len(seeds), fanouts))
    return bj, fj, bt, ft


@pytest.mark.parametrize("batch,fanouts", [(1, ()), (8, (2, 2)), (5, (3,)),
                                           (16, (4, 3)), (3, (2, 1, 2))])
def test_plan_sizes_match(batch, fanouts):
    assert tds.plan_sizes(batch, fanouts) == jds.plan_sizes(batch, fanouts)


@pytest.mark.parametrize("fanouts,key", [((2, 2), 3), ((3,), 0),
                                         ((2, 1, 2), 7)])
def test_frame_and_blocks_bit_equal_to_jax_sampler(graphs, fanouts, key):
    gj, gt = graphs
    seeds = (np.arange(B, dtype=np.int32) * 37) % gt.num_nodes
    bj, fj, bt, ft = _both(gj, gt, seeds, jax.random.PRNGKey(key), fanouts)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert ft.dtype == torch.int32 and len(bt) == len(bj) == len(fanouts)
    for a, b in zip(bj, bt):
        for name in ("row_ptr", "row", "col", "edge_weight"):
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(a, name)),
                                          err_msg=name)
        assert (b.n_pad, b.e_pad, b.num_nodes, b.num_edges) == (
            a.n_pad, a.e_pad, a.num_nodes, a.num_edges)
        assert b.meta == a.meta
    for name in ("seed_y", "seed_train_mask"):
        np.testing.assert_array_equal(bt[0].extras[name].numpy(),
                                      np.asarray(bj[0].extras[name]))
    assert bt[0].extras["x_table"] is gt.x
    np.testing.assert_array_equal(
        tds.frame_features(bt).numpy(),
        np.asarray(jnp.take(bj[0].extras["x_table"], bj[0].extras["frame"],
                            axis=0, mode="clip")))


def test_block_structure_is_built_once():
    a = tds._block_structure(B, FANOUTS, torch.device("cpu"))
    assert tds._block_structure(B, FANOUTS, torch.device("cpu")) is a
    n_pad, blocks = a
    sizes = tds.plan_sizes(B, FANOUTS)
    assert n_pad == jg._bucket(sizes[-1] + 1)
    # outermost first: the last hop's frontier, then the seeds'
    assert [(n, f) for n, f, *_ in blocks] == [(sizes[1], 2), (sizes[0], 2)]


def test_hop_sources_arithmetic():
    """Given the draws: the slot's offset is trunc(u·deg) capped at deg − 1,
    the position capped at the last edge, a destination with no edge takes
    itself, and an id past the table is clamped as JAX's ``mode="clip"``."""
    row_ptr = torch.tensor([0, 3, 3, 1000, 1000], dtype=torch.int32)
    col = torch.arange(1000, dtype=torch.int32) + 5
    cur = torch.tensor([0, 1, 2, 3, 9], dtype=torch.int32)
    u = torch.tensor([[0.0, 0.5, 0.99999994]] * 5)
    src, alive = tds.hop_sources(row_ptr, col, cur, u)
    assert alive.tolist() == [True, False, True, False, False]
    off2 = [int(np.float32(v) * np.float32(997)) for v in u[0].tolist()]
    assert src.tolist() == [[5, 6, 7], [1, 1, 1],
                            [3 + o + 5 for o in off2], [3, 3, 3], [9, 9, 9]]
    assert src.dtype == torch.int32


def test_zero_degree_destination(graphs):
    """A seed without an edge: its slots are dead (weight 0, the frame's
    sink column) and expand around itself; GraphSAGE's mean over it is 0;
    both packages agree bit for bit on the blocks."""
    gj, gt = _zero_degree_graphs()
    seeds = np.array([3, 0], np.int32)
    bj, fj, bt, ft = _both(gj, gt, seeds, jax.random.PRNGKey(0), (3,))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    blk = bt[0]
    np.testing.assert_array_equal(blk.col.numpy(), np.asarray(bj[0].col))
    sink = blk.n_pad - 1
    assert blk.col[:3].tolist() == [sink] * 3
    assert blk.edge_weight[:3].tolist() == [0.0] * 3
    assert ft[2:5].tolist() == [3, 3, 3]          # expands around itself
    assert blk.edge_weight[3:6].tolist() == [1.0] * 3
    from cogdl_tpu_torch.ops import aggregate

    agg = aggregate(blk, tds.frame_features(bt), "mean")
    assert float(agg[0].abs().max()) == 0.0 and float(agg[1].abs().sum()) > 0


@pytest.mark.parametrize("batch,shuffle", [(8, True), (7, False),
                                           (200, True)])
def test_epoch_seeds_match_jax(graphs, batch, shuffle):
    """The same shuffles (numpy ``default_rng(seed)``), the same
    wrap-padded last batch, over two epochs."""
    gj, gt = graphs
    sj = jds.DeviceNeighborSampler(gj, FANOUTS, batch_size=batch, seed=4)
    st = tds.DeviceNeighborSampler(gt, FANOUTS, batch_size=batch, seed=4)
    assert len(st) == len(sj)
    for _ in range(2):
        a, b = sj.epoch_seeds(shuffle), st.epoch_seeds(shuffle)
        np.testing.assert_array_equal(b, a)
        assert b.dtype == np.int32 and b.shape == (len(st), batch)
    train = set(np.nonzero(gt.train_mask[: gt.num_nodes].numpy())[0])
    assert set(b.ravel().tolist()) <= train


def test_sampler_refuses_an_empty_train_split(graphs):
    _, gt = graphs
    empty = gt.replace(train_mask=torch.zeros_like(gt.train_mask))
    with pytest.raises(ValueError, match="no seed nodes"):
        tds.DeviceNeighborSampler(empty, FANOUTS)


def _carried(gj, gt, key=5, fanouts=FANOUTS):
    """JAX blocks for B seeds and the same arrays carried into the port's
    Graphs (not resampled)."""
    seeds = (np.arange(B, dtype=np.int32) * 11) % gt.num_nodes
    bj, _ = jds.sample_blocks_device(gj, jnp.asarray(seeds),
                                     jax.random.PRNGKey(key), fanouts)
    bt = []
    for b in bj:
        t = {name: torch.from_numpy(np.array(getattr(b, name)))
             for name in ("row_ptr", "row", "col", "edge_weight")}
        extras = (None if not b.extras else
                  {k: torch.from_numpy(np.array(v))
                   for k, v in b.extras.items()})
        bt.append(tg.Graph(num_nodes=b.num_nodes, num_edges=b.num_edges,
                           meta=b.meta, extras=extras, **t))
    xj = jnp.take(bj[0].extras["x_table"], bj[0].extras["frame"], axis=0,
                  mode="clip")
    return list(bj), xj, bt, tds.frame_features(bt)


MODELS = {
    "sage-mean": ("graphsage", JGraphSAGE, {"aggr": "mean"}),
    "sage-sum": ("graphsage", JGraphSAGE, {"aggr": "sum"}),
    "sage-gcn": ("graphsage", JGraphSAGE, {"aggr": "gcn"}),
    "sage-max": ("graphsage", JGraphSAGE, {"aggr": "max"}),
    "sage-3-layers": ("graphsage", JGraphSAGE, {"num_layers": 3}),
    "gat": ("gat", JGAT, {"nhead": 2}),
    "gat-3-layers": ("gat", JGAT, {"nhead": 2, "num_layers": 3,
                                   "nhead_last": 2}),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_over_carried_blocks_match(graphs, name):
    """Logits and parameter grads of the seed rows' cross-entropy over the
    same blocks with the same weights (dropout 0)."""
    gj, gt = graphs
    model, jcls, cfg = MODELS[name]
    kw = dict(in_features=gt.num_features, out_features=4, hidden_size=6,
              dropout=0.0, **cfg)
    if model == "gat":
        kw["attn_drop"] = 0.0
    fanouts = (2, 2, 2) if kw.get("num_layers") == 3 else FANOUTS
    bj, xj, bt, xt = _carried(gj, gt, fanouts=fanouts)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    jm = jcls(**kw)
    variables = jm.init({"params": jax.random.PRNGKey(2),
                         "dropout": jax.random.PRNGKey(2)}, bj, xj,
                        training=False)
    tm = build_model(model, **kw)
    load_jax_params(tm, _host(variables["params"]))
    ex_j, ex_t = bj[0].extras, bt[0].extras

    def loss_j(params):
        logits = jm.apply({"params": params}, bj, xj, training=False)
        return j_mce(logits[:B], ex_j["seed_y"],
                     ex_j["seed_train_mask"]), logits

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    out_t = tm(bt, xt, training=False)
    masked_cross_entropy(out_t[:B], ex_t["seed_y"],
                         ex_t["seed_train_mask"]).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    ref = build_model(model, **kw)
    load_jax_params(ref, _host(grads_j))
    ref_params = dict(ref.named_parameters())
    for pname, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[pname].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=pname)


def test_gat_dead_destination_reads_the_sink_row_in_both_packages():
    """A destination whose slots are all dead gets the mean of its slots'
    rows, the frame's sink row, which here holds non-zero values; both
    packages agree (a reference behaviour, kept)."""
    gj, gt = _zero_degree_graphs()
    seeds = np.array([3, 0], np.int32)
    bj, _, bt, _ = _both(gj, gt, seeds, jax.random.PRNGKey(0), (3,))
    xj = jnp.take(gj.x, bj[0].extras["frame"], axis=0, mode="clip")
    kw = dict(in_features=6, out_features=2, num_layers=1, nhead_last=2,
              dropout=0.0, attn_drop=0.0)
    jm = JGAT(**kw)
    variables = jm.init(jax.random.PRNGKey(0), list(bj), xj, training=False)
    tm = build_model("gat", **kw)
    load_jax_params(tm, _host(variables["params"]))
    with torch.no_grad():
        out_t = tm(list(bt), tds.frame_features(bt))
        h_sink = tm.layer0.W(gt.x[-1:]).view(2, 2)
    out_j = np.asarray(jm.apply(variables, list(bj), xj, training=False))
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    assert float(h_sink.abs().max()) > 0
    torch.testing.assert_close(out_t[0], h_sink.mean(0), rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def test_gat_fanout_route_attention_dropout_follows_the_generator(graphs):
    _, gt = graphs
    bt, _ = tds.sample_blocks_device(gt, torch.arange(B, dtype=torch.int32),
                                     torch.Generator().manual_seed(0),
                                     FANOUTS)
    m = build_model("gat", in_features=gt.num_features, out_features=4,
                    dropout=0.0, attn_drop=0.5)
    m.reset_parameters(torch.Generator().manual_seed(0))
    x = tds.frame_features(bt)
    outs = [m(list(bt), x, training=True,
              generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert torch.equal(m(list(bt), x), m(list(bt), x))   # eval: no dropout


def test_powerlaw_device_features_match_the_jax_structure():
    """``device_features``: the host generator's edges in both packages, x
    over every padded row (pad rows random), masks split within the real
    nodes."""
    gj = j_powerlaw(500, avg_degree=6, feat_dim=8, num_classes=5, seed=2,
                    device_features=True)
    gt = t_powerlaw(500, avg_degree=6, feat_dim=8, num_classes=5, seed=2,
                    device_features=True, device="cpu")
    for name in ("row_ptr", "row", "col"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)))
    assert gt.x.shape == (gt.n_pad, 8) and gt.y.shape == (gt.n_pad,)
    assert float(gt.x[gt.num_nodes:].abs().sum()) > 0
    assert int(gt.y.max()) < 5 and gt.y.dtype == torch.int32
    node = gt.node_mask()
    assert not bool((gt.train_mask & ~node).any())
    assert torch.equal(gt.val_mask, ~gt.train_mask & node)
    assert torch.equal(gt.test_mask, gt.val_mask)
    assert 0.03 < float(gt.train_mask.float().sum()) / 500 < 0.2
    again = t_powerlaw(500, avg_degree=6, feat_dim=8, num_classes=5, seed=2,
                       device_features=True, device="cpu")
    assert torch.equal(again.x, gt.x)


def test_device_features_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_powerlaw(100, device_features=True)


@pytest.mark.parametrize("model,kw", [
    ("graphsage", {"hidden_size": 32}),
    ("gat", {"hidden_size": 8, "nhead": 4, "dropout": 0.0,
             "attn_drop": 0.0}),
])
def test_device_sampled_wrapper_learns(model, kw):
    """The bar and the set-up of tests/test_device_sampling.py."""
    res = train("sbm", model, wrapper="neighbor_sampling_device", seed=0,
                epochs=25, eval_step=5, fanouts=(5, 5), batch_size=64,
                lr=1e-2, device="cpu", **kw)
    assert res["test_acc"] > MIN_TEST_ACC, res


class _Counting(DeviceSampledNodeClfWrapper):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.steps, self.seeds = 0, []

    def loss(self, batch, generator=None, training=True):
        self.steps += 1
        self.seeds.append(batch["seeds"].clone())
        return super().loss(batch, generator, training)


def test_one_optimizer_step_per_seed_row_with_new_seeds_each_epoch(graphs):
    _, gt = graphs
    model = build_model("graphsage", in_features=gt.num_features,
                        out_features=4, hidden_size=8)
    w = _Counting(model, fanouts=FANOUTS, batch_size=16, seed=3)
    res = Trainer(epochs=3, device="cpu", seed=0).run(w, gt)
    per_epoch = len(w._sampler)
    assert w.steps == 3 * per_epoch and per_epoch > 1
    first, second = w.seeds[:per_epoch], w.seeds[per_epoch: 2 * per_epoch]
    assert not all(torch.equal(a, b) for a, b in zip(first, second))
    # the trainer's per-batch step time and the epoch's mean loss
    assert res["train_step_ms"] > 0 and np.isfinite(res["train_loss"])


def test_wrapper_seed_follows_the_variant_seed():
    from cogdl_tpu_torch.experiments import _setup_variant
    from cogdl_tpu_torch.datasets import build_dataset

    ds = build_dataset("sbm")
    w, _, tk = _setup_variant(ds, "graphsage", 7, "neighbor_sampling_device",
                              {"fanouts": (3, 3)})
    assert w.seed == 7 and tk["seed"] == 7 and w.fanouts == (3, 3)


@pytest.mark.parametrize("name", ["cluster", "graphsaint"])
def test_subgraph_wrappers_resolve_and_train_an_epoch(name):
    cls = {"cluster": ClusterNodeClfWrapper,
           "graphsaint": GraphSAINTWrapper}[name]
    assert fetch_wrapper(name) is cls
    res = train("sbm", "graphsage", wrapper=name, epochs=1, device="cpu")
    assert np.isfinite(res["train_loss"]) and 0.0 <= res["test_acc"] <= 1.0


def test_an_unported_wrapper_raises():
    # the JAX package's multi-device wrapper waits for item 16
    with pytest.raises(ValueError, match="not yet ported"):
        fetch_wrapper("distributed")
    with pytest.raises(ValueError, match="not yet ported"):
        train("sbm", "graphsage", wrapper="distributed", epochs=1,
              device="cpu")


def test_sampled_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("sbm", "graphsage", wrapper="neighbor_sampling_device",
              epochs=1)
