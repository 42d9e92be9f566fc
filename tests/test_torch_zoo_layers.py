"""cogdl_tpu_torch's layers of the full-batch node-classification zoo
against the JAX package on the CPU: ``MLP``, ``SGCLayer``, ``APPNPProp``,
``GCNIILayer``, ``MixHopLayer``, ``SELayer``, ``GENConv`` (all five
aggregators, message norm, residual, learned ``beta`` / ``p``) and
``ResGNNLayer`` (batch and layer norm).

Each layer gets the JAX layer's initial weights through
``load_jax_params`` and the same inputs, drawn from a numpy seed over all
``n_pad`` rows of a 200-node graph. The forward is held at 1e-5 and the
gradients of ``Σ out · probe`` (every parameter and the input) at 1e-4;
batch norm's statistics after two training-mode calls against flax's
updated ``batch_stats``. The layers that propagate are run with and without
``prepare_spmm``'s structure (K1's plain version or the plain tier)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu_torch.data.graph as tg
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.layers import (
    MLP as JMLP,
    APPNPProp as JAPPNPProp,
    GCNIILayer as JGCNIILayer,
    GENConv as JGENConv,
    MixHopLayer as JMixHopLayer,
    ResGNNLayer as JResGNNLayer,
    SELayer as JSELayer,
    SGCLayer as JSGCLayer,
)
from cogdl_tpu_torch.layers import (
    MLP,
    APPNPProp,
    GCNIILayer,
    GENConv,
    MixHopLayer,
    ResGNNLayer,
    SELayer,
    SGCLayer,
)
from cogdl_tpu_torch.models import load_jax_params
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 on both sides with the same weights, summed in other orders: forward
# 1e-5, grads 1e-4 (the tolerances of the port's other layer tests)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
F_IN = 12
EDGE_FIELDS = ("row_ptr", "row", "col", "edge_weight")


@pytest.fixture(scope="module")
def graphs():
    """The JAX package's 200-node sbm graph with self loops and sym norm
    (224 padded rows), and the port's Graph carrying the same arrays."""
    gj = jg.sym_norm(jg.add_self_loops(j_sbm(num_nodes=200, feat_dim=F_IN,
                                             seed=3)))
    fields = {f: torch.from_numpy(np.array(getattr(gj, f)))
              for f in EDGE_FIELDS + ("x",)}
    gt = tg.Graph(num_nodes=gj.num_nodes, num_edges=gj.num_edges,
                  meta=gj.meta, **fields)
    return gj, gt


def _host(tree):
    return jax.tree.map(np.asarray, tree)


class _Net(torch.nn.Module):
    """One port layer under the flax name ``layer``."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def check_layer(jl, build, args_j, call_t, n_pad, width, seed=0,
                training=False):
    """``jl`` (flax) and ``build()`` (the port layer) on the same inputs:
    ``args_j`` are the JAX call's arguments after the variables, numpy
    arrays for the inputs that take a gradient; ``call_t(layer, *inputs)``
    calls the port layer with those inputs as torch tensors. Returns the
    port net and the JAX variables after the call (batch stats updated
    under ``training``)."""
    arrays = [i for i, a in enumerate(args_j) if isinstance(a, np.ndarray)]
    variables = _host(jl.init(jax.random.PRNGKey(seed), *args_j))
    variables.setdefault("params", {})     # APPNPProp has none
    probe = _normal(seed + 100, n_pad, width)
    mutable = ["batch_stats"] if training and "batch_stats" in variables \
        else False

    def loss_j(params, *inputs):
        args = list(args_j)
        for i, v in zip(arrays, inputs):
            args[i] = v
        out = jl.apply({**variables, "params": params}, *args,
                       training=training, mutable=mutable)
        out, upd = out if mutable else (out, {})
        return jnp.sum(out * probe), (out, upd)

    (_, (out_j, upd)), grads = jax.value_and_grad(
        loss_j, argnums=tuple(range(len(arrays) + 1)), has_aux=True)(
        variables["params"], *(jnp.asarray(args_j[i]) for i in arrays))
    net = _Net(build())
    load_jax_params(net, {"layer": variables["params"]},
                    {"layer": variables["batch_stats"]}
                    if "batch_stats" in variables else None)
    inputs = [torch.from_numpy(args_j[i]).requires_grad_(True)
              for i in arrays]
    out_t = call_t(net.layer, *inputs)
    (out_t * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    ref = _Net(build())
    load_jax_params(ref, {"layer": _host(grads[0])})
    ref_params = dict(ref.named_parameters())
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[name].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    for t, g in zip(inputs, grads[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg="input")
    return net, {**variables, **_host(upd)}


def _with_structure(gt, structure):
    return prepare_spmm(gt) if structure else gt


# -- MLP -----------------------------------------------------------------------

@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("act_first", [False, True])
@pytest.mark.parametrize("norm", [None, "batchnorm", "layernorm"])
def test_mlp_matches_jax(graphs, norm, act_first, training):
    gj, _ = graphs
    cfg = dict(hidden_features=10, num_layers=3, norm=norm,
               act_first=act_first)
    x = _normal(1, gj.n_pad, F_IN)
    check_layer(JMLP(5, **cfg), lambda: MLP(F_IN, 5, **cfg), (x,),
                lambda m, x: m(x, training), gj.n_pad, 5, training=training)


def test_mlp_batch_statistics_match_flax_after_two_training_calls(graphs):
    """flax ``nn.BatchNorm`` over all rows (momentum 0.99, the biased
    variance): the running statistics after two training-mode calls, the
    second from the first's updated statistics."""
    gj, _ = graphs
    cfg = dict(hidden_features=10, num_layers=3, norm="batchnorm")
    jl = JMLP(5, **cfg)
    x1, x2 = _normal(2, gj.n_pad, F_IN), _normal(3, gj.n_pad, F_IN) + 0.5
    variables = _host(jl.init(jax.random.PRNGKey(0), x1))
    tm = _Net(MLP(F_IN, 5, **cfg))
    load_jax_params(tm, {"layer": variables["params"]},
                    {"layer": variables["batch_stats"]})
    for x in (x1, x2):
        out_j, upd = jl.apply(variables, x, training=True,
                              mutable=["batch_stats"])
        variables = {**variables, **_host(upd)}
        with torch.no_grad():
            out_t = tm.layer(torch.from_numpy(x), training=True)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    for i in (0, 1):
        stats = variables["batch_stats"][f"norm{i}"]
        norm = getattr(tm.layer, f"norm{i}")
        np.testing.assert_allclose(norm.mean.numpy(), stats["mean"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(norm.var.numpy(), stats["var"],
                                   rtol=1e-5, atol=1e-7)
    # the running statistics then drive an evaluation
    with torch.no_grad():
        out_t = tm.layer(torch.from_numpy(x1), training=False)
    np.testing.assert_allclose(
        out_t.numpy(), np.asarray(jl.apply(variables, x1, training=False)),
        rtol=FWD_RTOL, atol=FWD_ATOL)


# -- the propagating layers ----------------------------------------------------

@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_sgc_layer_matches_jax(graphs, order, structure):
    gj, gt = graphs
    g = _with_structure(gt, structure)
    x = _normal(4, gj.n_pad, F_IN)
    check_layer(JSGCLayer(6, order=order),
                lambda: SGCLayer(F_IN, 6, order=order), (gj, x),
                lambda m, x: m(g, x), gj.n_pad, 6)


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("k,alpha", [(1, 0.1), (4, 0.3)])
def test_appnp_prop_matches_jax(graphs, k, alpha, structure):
    gj, gt = graphs
    g = _with_structure(gt, structure)
    h = _normal(5, gj.n_pad, 7)
    check_layer(JAPPNPProp(k=k, alpha=alpha),
                lambda: APPNPProp(k=k, alpha=alpha), (gj, h),
                lambda m, h: m(g, h), gj.n_pad, 7)


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("beta", [0.3, 1.0])
def test_gcnii_layer_matches_jax(graphs, beta, residual, structure):
    gj, gt = graphs
    g = _with_structure(gt, structure)
    x, h0 = _normal(6, gj.n_pad, 8), _normal(7, gj.n_pad, 8)
    cfg = dict(alpha=0.2, beta=beta, residual=residual)
    check_layer(JGCNIILayer(8, **cfg), lambda: GCNIILayer(8, **cfg),
                (gj, x, h0), lambda m, x, h0: m(g, x, h0), gj.n_pad, 8)


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("powers", [(0, 1, 2), (1, 3)])
def test_mixhop_layer_matches_jax(graphs, powers, structure):
    gj, gt = graphs
    g = _with_structure(gt, structure)
    x = _normal(8, gj.n_pad, F_IN)
    check_layer(JMixHopLayer(5, powers=powers),
                lambda: MixHopLayer(F_IN, 5, powers=powers), (gj, x),
                lambda m, x: m(g, x), gj.n_pad, 5 * len(powers))


@pytest.mark.parametrize("channels", [4, 16])
def test_se_layer_matches_jax(graphs, channels):
    """The squeeze averages all ``n_pad`` rows, pad rows included."""
    gj, _ = graphs
    x = _normal(9, gj.n_pad, F_IN)
    check_layer(JSELayer(se_channels=channels),
                lambda: SELayer(F_IN, se_channels=channels), (x,),
                lambda m, x: m(x), gj.n_pad, F_IN)


def test_layers_that_propagate_say_so():
    assert SGCLayer(4, 2).calls_spmm and not SGCLayer(4, 2, order=0).calls_spmm
    assert APPNPProp().calls_spmm and not APPNPProp(k=0).calls_spmm
    assert GCNIILayer(4).calls_spmm
    assert MixHopLayer(4, 2).calls_spmm
    assert not MixHopLayer(4, 2, powers=(0,)).calls_spmm
    assert not hasattr(GENConv(4, 4), "calls_spmm")


# -- GENConv and ResGNNLayer ---------------------------------------------------

@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("msg_norm", [False, True])
@pytest.mark.parametrize("aggr", ["softmax", "softmax_sg", "powermean",
                                  "mean", "max"])
def test_genconv_matches_jax(graphs, aggr, msg_norm, residual):
    gj, _ = graphs
    _, gt = graphs
    x = _normal(10, gj.n_pad, 8)
    cfg = dict(aggr=aggr, use_msg_norm=msg_norm, residual=residual)
    net, variables = check_layer(JGENConv(6, **cfg),
                                 lambda: GENConv(8, 6, **cfg), (gj, x),
                                 lambda m, x: m(gt, x), gj.n_pad, 6)
    assert set(variables["params"]) == (
        {"mlp_out", "s"} if msg_norm else {"mlp_out"})
    assert net.layer.mlp_out.fc0.out_features == 16   # 2 · F_in


@pytest.mark.parametrize("aggr,cfg", [
    ("softmax", dict(learn_beta=True, beta=0.7)),
    ("softmax_sg", dict(learn_beta=True, beta=1.5)),
    ("powermean", dict(learn_p=True, p=2.0)),
    ("powermean", dict(p=3.0, activation="relu")),
])
def test_genconv_learned_scalars_match_jax(graphs, aggr, cfg):
    """``beta`` and ``p`` as shape-``()`` parameters, carried and
    differentiated like the rest; ``softmax_sg`` gives ``beta`` no
    gradient."""
    gj, gt = graphs
    x = _normal(11, gj.n_pad, 8)
    net, variables = check_layer(JGENConv(6, aggr=aggr, **cfg),
                                 lambda: GENConv(8, 6, aggr=aggr, **cfg),
                                 (gj, x), lambda m, x: m(gt, x), gj.n_pad, 6)
    for name in ("beta", "p"):
        if cfg.get(f"learn_{name}"):
            assert variables["params"][name].shape == ()
            assert getattr(net.layer, name).shape == ()
    if aggr == "softmax_sg":
        assert float(net.layer.beta.grad) == 0.0


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("norm", ["batchnorm", "layernorm"])
def test_resgnn_layer_matches_jax(graphs, norm, training):
    """Batch norm over the real nodes only (``MaskedBatchNorm`` with the
    node mask); in training mode its batch statistics, in evaluation its
    running ones."""
    gj, gt = graphs
    x = _normal(12, gj.n_pad, 8)
    check_layer(JResGNNLayer(8, norm=norm), lambda: ResGNNLayer(8, 8,
                                                                norm=norm),
                (gj, x), lambda m, x: m(gt, x, training), gj.n_pad, 8,
                training=training)


def test_resgnn_batch_statistics_match_flax_after_two_training_calls(graphs):
    gj, gt = graphs
    jl = JResGNNLayer(8, norm="batchnorm")
    x1, x2 = _normal(13, gj.n_pad, 8), _normal(14, gj.n_pad, 8) * 2.0 + 1.0
    variables = _host(jl.init(jax.random.PRNGKey(0), gj, x1))
    tm = _Net(ResGNNLayer(8, 8))
    load_jax_params(tm, {"layer": variables["params"]},
                    {"layer": variables["batch_stats"]})
    for x in (x1, x2):
        out_j, upd = jl.apply(variables, gj, x, training=True,
                              mutable=["batch_stats"])
        variables = {**variables, **_host(upd)}
        with torch.no_grad():
            out_t = tm.layer(gt, torch.from_numpy(x), training=True)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    stats = variables["batch_stats"]["norm"]
    np.testing.assert_allclose(tm.layer.norm.mean.numpy(), stats["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.layer.norm.var.numpy(), stats["var"],
                               rtol=1e-5, atol=1e-7)


def test_resgnn_layer_uses_a_mask_drawn_before_the_call(graphs):
    """``keep`` stands in for the block's own draw: the same output as the
    draw from a generator in the same state, and the generator left
    untouched."""
    from cogdl_tpu_torch.layers.utils import dropout_keep

    _, gt = graphs
    layer = ResGNNLayer(8, 8, dropout=0.5, norm="layernorm")
    x = torch.from_numpy(_normal(15, gt.n_pad, 8))
    gen = torch.Generator().manual_seed(7)
    drawn = layer(gt, x, True, gen)
    keep = dropout_keep(x.shape, 0.5, x.device,
                        torch.Generator().manual_seed(7))
    gen2 = torch.Generator().manual_seed(7)
    given = layer(gt, x, True, gen2, keep=keep)
    assert torch.equal(drawn, given)
    assert torch.equal(gen2.get_state(),
                       torch.Generator().manual_seed(7).get_state())


def test_genconv_rejects_an_unknown_aggregator():
    with pytest.raises(ValueError, match="softmax_sg"):
        GENConv(4, 4, aggr="sum")
