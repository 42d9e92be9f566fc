"""cogdl_tpu_torch GCN layer and model against the JAX package on the CPU,
with the JAX weights injected through ``load_jax_params``: logits (with and
without the cached propagation) and parameter gradients."""

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
from cogdl_tpu.layers import GCNLayer as JGCNLayer
from cogdl_tpu.models.nn.gcn import GCN as JGCN
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.layers import GCNLayer
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 forward through two dense layers and two SpMMs, summed in another
# order: 1e-5 relative on O(1) logits; gradients accumulate over ~60 train
# nodes: 1e-4
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6

CONFIGS = {
    "plain": {},
    "layernorm": {"norm": "layernorm"},
    "batchnorm": {"norm": "batchnorm"},
    "residual": {"residual": True, "hidden_size": 16},
    "three_layers": {"num_layers": 3},
}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def graphs():
    gj = jg.sym_norm(jg.add_self_loops(j_sbm(num_nodes=150, feat_dim=16, seed=2)))
    gt = tg.sym_norm(tg.add_self_loops(t_sbm(num_nodes=150, feat_dim=16, seed=2)))
    return gj, gt


def _models(gj, cfg, seed=0):
    kw = dict(in_features=16, out_features=4, hidden_size=12, dropout=0.5)
    kw.update(cfg)
    jm = JGCN(**kw)
    variables = jm.init({"params": jax.random.PRNGKey(seed),
                         "dropout": jax.random.PRNGKey(seed)},
                        gj, gj.x, training=False)
    tm = build_model("gcn", **kw)
    load_jax_params(tm, _host(variables["params"]),
                    _host(variables.get("batch_stats")))
    return jm, variables, tm


@pytest.mark.parametrize("prop", [False, True])
@pytest.mark.parametrize("kernel_structure", [False, True])
def test_gcn_layer_matches(graphs, prop, kernel_structure):
    gj, gt = graphs
    if kernel_structure:
        gt = prepare_spmm(gt)
    jl = JGCNLayer(8, activation="relu")
    variables = jl.init(jax.random.PRNGKey(1), gj, gj.x)
    tl = GCNLayer(16, 8, activation="relu")
    load_jax_params(tl, _host(variables["params"]))
    pj = pt = None
    if prop:
        cj, ct = jops.cache_propagation(gj), tops.cache_propagation(gt)
        pj = (cj.extras["prop_x"], cj.extras["prop_s"])
        pt = (ct.extras["prop_x"], ct.extras["prop_s"])
    out_j = jl.apply(variables, gj, gj.x, prop=pj)
    with torch.no_grad():
        out_t = tl(gt, gt.x, prop=pt)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_gcn_logits_match(graphs, cfg, cached):
    gj, gt = graphs
    if cached:
        gj, gt = jops.cache_propagation(gj), tops.cache_propagation(gt)
    jm, variables, tm = _models(gj, CONFIGS[cfg])
    out_j = jm.apply(variables, gj, gj.x, training=False)
    with torch.no_grad():
        out_t = tm(gt, training=False)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("cfg", ["plain", "layernorm", "residual"])
def test_gcn_param_grads_match(graphs, cfg):
    gj, gt = graphs
    jm, variables, tm = _models(gj, CONFIGS[cfg], seed=3)
    mask_j = gj.train_mask & gj.node_mask()

    def loss_j(params):
        logits = jm.apply({**variables, "params": params}, gj, gj.x,
                          training=False)
        return j_mce(logits, gj.y, mask_j)

    grads_j = _host(jax.grad(loss_j)(variables["params"]))
    loss_t = masked_cross_entropy(tm(prepare_spmm(gt), training=False), gt.y,
                                  gt.train_mask & gt.node_mask())
    loss_t.backward()
    # route the JAX grads through the same bridge, then compare per tensor
    ref = build_model("gcn", **{"in_features": 16, "out_features": 4,
                                "hidden_size": 12, **CONFIGS[cfg]})
    load_jax_params(ref, grads_j)
    ref_params = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_params[name].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


def test_load_jax_params_rejects_mismatch(graphs):
    gj, _ = graphs
    _, variables, tm = _models(gj, {})
    params = _host(variables["params"])
    params["layer9"] = {"linear": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError):
        load_jax_params(tm, params)
    with pytest.raises(KeyError):
        load_jax_params(tm, {"layer0": params["layer0"]})


def test_init_follows_flax_lecun_normal():
    """Fresh weights have the JAX package's scale (truncated normal with
    variance 1/fan_in) and zero bias, reproducibly from a generator."""
    m = build_model("gcn", in_features=400, out_features=300, hidden_size=500)
    m.reset_parameters(torch.Generator().manual_seed(0))
    w = m.layer0.linear.weight.detach()
    assert abs(float(w.std()) - (1 / 400) ** 0.5) < 0.002
    assert float(w.abs().max()) <= 2 * (1 / 400) ** 0.5 / 0.8796 + 1e-6
    assert float(m.layer0.linear.bias.abs().max()) == 0.0
    m2 = build_model("gcn", in_features=400, out_features=300, hidden_size=500)
    m2.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(m2.layer0.linear.weight, w)


def test_build_model_unported_names():
    # every name of the JAX registry is ported: a name of neither raises
    with pytest.raises(ValueError, match="not yet ported"):
        build_model("no_such_model", in_features=4, out_features=2)
