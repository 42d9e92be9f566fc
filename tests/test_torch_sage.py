"""cogdl_tpu_torch ``aggregate``, ``SAGELayer`` and ``GraphSAGE`` against the
JAX package on the CPU, with the JAX weights injected through
``load_jax_params``: forward, ``inference`` and parameter gradients, and the
``experiment()`` entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu.ops as jops
import cogdl_tpu_torch.data.graph as tg
import cogdl_tpu_torch.ops as tops
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.layers import SAGELayer as JSAGELayer
from cogdl_tpu.models.nn.graphsage import GraphSAGE as JGraphSAGE
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.layers import SAGELayer
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 on both sides, dropout 0; the two packages sum a row's neighbours and
# a dense layer's products in different orders: 1e-5 relative on O(1)-O(10)
# values, forward and grads
RTOL, ATOL = 1e-5, 1e-5

AGGREGATORS = ("mean", "sum", "max", "gcn")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def graphs():
    gj = jg.add_self_loops(j_sbm(num_nodes=150, feat_dim=16, seed=2))
    gt = tg.add_self_loops(t_sbm(num_nodes=150, feat_dim=16, seed=2))
    return gj, gt


@pytest.mark.parametrize("kernel_structure", [False, True])
@pytest.mark.parametrize("how", ["sum", "mean", "max"])
def test_aggregate_matches(graphs, how, kernel_structure):
    gj, gt = graphs
    if kernel_structure:
        gt = prepare_spmm(gt)   # "sum" then takes K1's plain version
    x = np.random.default_rng(0).standard_normal(
        (gj.n_pad, 7)).astype(np.float32)
    out_j = jops.aggregate(gj, jnp.asarray(x), how)
    out_t = tops.aggregate(gt, torch.from_numpy(x), how)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)


def test_aggregate_rejects_unknown_reduction(graphs):
    with pytest.raises(ValueError):
        tops.aggregate(graphs[1], graphs[1].x, "median")


def _regular_block(n=5, f=3, n_src=12, n_pad=16, e_pad=24, seed=0):
    """A hand-made regular-fanout block as the device sampler lays it out:
    destination ``r`` owns slots ``[r·f, (r+1)·f)``; dead slots point at the
    sink row with weight 0; pad edges sit in the sink row."""
    rng = np.random.default_rng(seed)
    sink = n_pad - 1
    e_real = n * f
    alive = rng.random(e_real) < 0.7
    alive[:f] = False                    # one destination with no live slot
    rows = np.full(e_pad, sink, np.int32)
    rows[:e_real] = np.repeat(np.arange(n, dtype=np.int32), f)
    cols = np.full(e_pad, sink, np.int32)
    cols[:e_real] = np.where(alive, rng.integers(0, n_src, e_real), sink)
    w = np.zeros(e_pad, np.float32)
    w[:e_real] = alive
    rp = (np.minimum(np.arange(n_pad + 1), n) * f).astype(np.int32)
    rp[-1] = e_pad
    x = rng.standard_normal((n_pad, 6)).astype(np.float32)
    x[n_src:] = 0.0                      # pad rows and the sink hold zeros
    meta = (("fanout", f), ("frontier", n))
    kw = dict(num_nodes=n_src, num_edges=e_real, meta=meta)
    gj = jg.Graph(row_ptr=jnp.asarray(rp), row=jnp.asarray(rows),
                  col=jnp.asarray(cols), edge_weight=jnp.asarray(w), **kw)
    gt = tg.Graph(row_ptr=torch.from_numpy(rp), row=torch.from_numpy(rows),
                  col=torch.from_numpy(cols),
                  edge_weight=torch.from_numpy(w), **kw)
    return gj, gt, x


@pytest.mark.parametrize("how", ["sum", "mean"])
def test_aggregate_regular_fanout_branch(how):
    gj, gt, x = _regular_block()
    out_j = np.asarray(jops.aggregate(gj, jnp.asarray(x), how))
    out_t = tops.aggregate(gt, torch.from_numpy(x), how)
    assert out_t.shape == (gt.n_pad, x.shape[1])
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=RTOL, atol=ATOL)
    # the branch is a reshape-reduce of the same sum the segment route takes
    plain = gt.replace(meta=())
    if how == "sum":
        np.testing.assert_allclose(
            out_t.numpy(), tops.aggregate(plain, torch.from_numpy(x),
                                          "sum").numpy(), rtol=RTOL, atol=ATOL)
    assert float(out_t[0].abs().max()) == 0.0     # no live slot
    assert float(out_t[5:].abs().max()) == 0.0    # past the frontier


def test_aggregate_regular_fanout_grad():
    _, gt, x = _regular_block()
    xt = torch.from_numpy(x).requires_grad_(True)
    tops.aggregate(gt, xt, "mean").square().sum().backward()
    ref = torch.from_numpy(x).requires_grad_(True)
    n, f = 5, 3
    msg = ref[gt.col[: n * f].long()].reshape(n, f, -1)
    ew = gt.edge_weight[: n * f].reshape(n, f, 1)
    ((msg * ew).sum(1) / ew.sum(1).clamp_min(1.0)).square().sum().backward()
    torch.testing.assert_close(xt.grad, ref.grad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("aggr", AGGREGATORS)
def test_sage_layer_matches(graphs, aggr, normalize):
    gj, gt = graphs
    jl = JSAGELayer(8, aggr=aggr, normalize=normalize, activation="relu")
    variables = jl.init(jax.random.PRNGKey(1), gj, gj.x)
    tl = SAGELayer(16, 8, aggr=aggr, normalize=normalize, activation="relu")
    load_jax_params(tl, _host(variables["params"]))
    assert {n.split(".")[0] for n, _ in tl.named_parameters()} == (
        {"W"} if aggr == "gcn" else {"W_self", "W_nbr"})
    out_j = jl.apply(variables, gj, gj.x)
    with torch.no_grad():
        out_t = tl(gt, gt.x)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)


def test_sage_layer_rejects_unknown_aggregator():
    with pytest.raises(ValueError, match="aggregator"):
        SAGELayer(4, 4, aggr="lstm")


def test_sage_layer_dropout_follows_generator(graphs):
    _, gt = graphs
    tl = SAGELayer(16, 8, dropout=0.5)
    tl.W_self.reset_parameters(torch.Generator().manual_seed(0))
    tl.W_nbr.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = tl(gt, gt.x, True, torch.Generator().manual_seed(5))
        b = tl(gt, gt.x, True, torch.Generator().manual_seed(5))
        c = tl(gt, gt.x, False)
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.3 < float(kept.float().mean()) < 0.7
    torch.testing.assert_close(a[kept], (c * 2.0)[kept])


def _models(gj, seed=0, **cfg):
    kw = dict(in_features=16, out_features=4, hidden_size=12, dropout=0.0)
    kw.update(cfg)
    jm = JGraphSAGE(**kw)
    variables = jm.init({"params": jax.random.PRNGKey(seed),
                         "dropout": jax.random.PRNGKey(seed)},
                        gj, gj.x, training=False)
    tm = build_model("graphsage", **kw)
    load_jax_params(tm, _host(variables["params"]))
    return jm, variables, tm, kw


CONFIGS = {"mean": {}, "sum": {"aggr": "sum"}, "max": {"aggr": "max"},
           "gcn": {"aggr": "gcn"}, "mean_normalize": {"normalize": True},
           "three_layers": {"num_layers": 3}}


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_graphsage_logits_match(graphs, cfg):
    gj, gt = graphs
    jm, variables, tm, _ = _models(gj, **CONFIGS[cfg])
    out_j = jm.apply(variables, gj, gj.x, training=False)
    with torch.no_grad():
        out_t = tm(gt, training=False)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)


def test_graphsage_inference_matches(graphs):
    """``inference`` is the layer-wise forward over the whole graph without
    dropout. The JAX method itself cannot be applied (it builds submodules
    outside ``@nn.compact`` and flax refuses that), so the reference is the
    JAX forward with ``training=False``, which computes what it documents."""
    gj, gt = graphs
    jm, variables, tm, _ = _models(gj, normalize=True, dropout=0.5)
    out_j = jm.apply(variables, gj, gj.x, training=False)
    with torch.no_grad():
        out_t = tm.inference(gt)
        full = tm(gt, gt.x, training=False)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(out_t, full)


def test_graphsage_takes_a_list_of_blocks(graphs):
    """One block per layer: the same graph twice is the full-batch forward,
    in both packages."""
    gj, gt = graphs
    jm, variables, tm, _ = _models(gj, aggr="sum")
    out_j = jm.apply(variables, [gj, gj], gj.x, training=False)
    with torch.no_grad():
        out_t = tm([gt, gt], gt.x, training=False)
        one = tm(gt, training=False)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(out_t, one)


@pytest.mark.parametrize("cfg", ["mean", "sum", "max", "gcn",
                                 "mean_normalize"])
def test_graphsage_param_grads_match(graphs, cfg):
    gj, gt = graphs
    jm, variables, tm, kw = _models(gj, seed=3, **CONFIGS[cfg])
    mask_j = gj.train_mask & gj.node_mask()

    def loss_j(params):
        logits = jm.apply({"params": params}, gj, gj.x, training=False)
        return j_mce(logits, gj.y, mask_j)

    grads_j = _host(jax.grad(loss_j)(variables["params"]))
    # "sum" and "gcn" go through SpMMFunction's plain version and its
    # hand-written backward over the transposed structure
    loss_t = masked_cross_entropy(tm(prepare_spmm(gt), training=False), gt.y,
                                  gt.train_mask & gt.node_mask())
    loss_t.backward()
    ref = build_model("graphsage", **kw)
    load_jax_params(ref, grads_j)
    ref_params = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[name].detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_registry_and_config_entries():
    from cogdl_tpu.configs import BEST_CONFIGS as J_BEST
    from cogdl_tpu_torch.configs import BEST_CONFIGS
    from cogdl_tpu_torch.wrappers import default_wrapper_for

    assert BEST_CONFIGS["graphsage"] == J_BEST["graphsage"]
    a = build_model("graphsage", in_features=4, out_features=2)
    b = build_model("sage", in_features=4, out_features=2, nhead=3)
    assert type(a) is type(b)
    assert default_wrapper_for("graphsage") == "node_classification"
    assert default_wrapper_for("sage") == "node_classification"


def test_load_jax_params_rejects_a_foreign_sage_tree(graphs):
    gj, _ = graphs
    _, variables, _, _ = _models(gj)
    gcn_style = build_model("graphsage", in_features=16, out_features=4,
                            hidden_size=12, aggr="gcn")
    with pytest.raises(KeyError):
        load_jax_params(gcn_style, _host(variables["params"]))


def test_experiment_graphsage_on_sbm():
    res = experiment(dataset="sbm", model="graphsage", epochs=100,
                     seed=[0, 1], device="cpu")
    (runs,) = res.values()
    assert np.mean([r["test_acc"] for r in runs]) >= 0.95
