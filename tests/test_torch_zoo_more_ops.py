"""The small modules the rest of ROADMAP item 12's models import, in
cogdl_tpu_torch against the JAX package on the CPU: ``ops/actnn``,
``utils/transforms``, ``utils/grb.gnnguard_reweight``,
``models/emb/base.graph_to_scipy``, PPRGo's ``topk_ppr_graph``, GDC's
``gdc_diffuse`` (both on tiny graphs: a Python push loop and a dense N×N
inverse), MoE's flax fan rule, and the registry entries of the slice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu_torch.data.graph as tg
from cogdl_tpu.models import SUPPORTED_MODELS as JAX_MODELS
from cogdl_tpu_torch.models import SUPPORTED_MODELS, build_model
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.wrappers import DEFAULT_WRAPPER

# fp32 on both sides, the same inputs, sums in other orders
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
SLICE = ("sign", "dropedge_gcn", "revgcn", "revgat", "revgen", "grand",
         "pprgo", "moe_gcn", "robustgcn", "gnnguard_gcn", "gdc_gcn",
         "actgcn", "autognn")


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _graphs(n=40, e=160, seed=0, x_dim=6):
    """The same self-loop graph in both packages, unit weights."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e))
    x = _rand((n, x_dim), seed + 1)
    gj = jg.add_self_loops(jg.from_coo(ei, num_nodes=n, x=x))
    gt = tg.add_self_loops(tg.from_coo(ei, num_nodes=n, x=x))
    return gj, gt


# -- ops/actnn ------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_quantize_rowwise_matches_jax(scale):
    from cogdl_tpu.ops import actnn as ja
    from cogdl_tpu_torch.ops import actnn as ta

    x = _rand((33, 17), 1, scale)
    x[3] = 0.0                       # an all-zero row takes the 1e-12 floor
    qj, sj = ja.quantize_rowwise(jnp.asarray(x))
    qt, st = ta.quantize_rowwise(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7)
    np.testing.assert_allclose(ta.dequantize_rowwise(qt, st).numpy(),
                               np.asarray(ja.dequantize_rowwise(qj, sj)),
                               rtol=1e-7)


def test_quantize_rounds_half_to_even_as_jnp_round():
    from cogdl_tpu.ops import actnn as ja
    from cogdl_tpu_torch.ops import actnn as ta

    # a row of amax 127: the scale is 1, x / scale the values themselves
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    qj, _ = ja.quantize_rowwise(jnp.asarray(x))
    qt, _ = ta.quantize_rowwise(torch.from_numpy(x))
    assert qt.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_act_dense_and_act_relu_match_jax_with_the_quantised_dw():
    """``act_relu(act_dense(x, w, b))`` forward and its gradients in ``x``,
    ``w`` and ``b`` against the JAX custom VJPs: ``dw`` reads the int8
    residual in both, so it is the quantised one, not the exact one."""
    from cogdl_tpu.ops import actnn as ja
    from cogdl_tpu_torch.ops import actnn as ta

    x, w, b = _rand((50, 12), 2), _rand((12, 7), 3), _rand((7,), 4)
    r = _rand((50, 7), 5)

    def f_j(x, w, b):
        return jnp.sum(ja.act_relu(ja.act_dense(x, w, b)) * r)

    out_j = ja.act_relu(ja.act_dense(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b)))
    grads_j = jax.grad(f_j, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out_t = ta.act_relu(ta.act_dense(xt, wt, bt))
    (out_t * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    for name, t, j in (("dx", xt, grads_j[0]), ("dw", wt, grads_j[1]),
                       ("db", bt, grads_j[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    # the exact dw differs from the quantised one
    exact = torch.from_numpy(x).T @ (torch.from_numpy(r) * (out_t > 0))
    assert not torch.allclose(wt.grad, exact, rtol=0, atol=1e-7)


def test_act_relu_backward_reads_only_the_sign_mask():
    from cogdl_tpu_torch.ops import actnn as ta

    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    ta.act_relu(x).backward(torch.tensor([5.0, 6.0, 7.0]))
    assert x.grad.tolist() == [0.0, 0.0, 7.0]


# -- utils/transforms -----------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_drop_edge_node_feature_match_jax_where_the_draw_is_certain(rate):
    """At rate 0 every element is kept and at rate 1 none: the JAX draw is
    then certain, and the port's transforms give the JAX values."""
    from cogdl_tpu.utils import transforms as jt
    from cogdl_tpu_torch.utils import transforms as tt

    gj, gt = _graphs()
    gj, gt = jg.sym_norm(gj), tg.sym_norm(gt)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    dj, dt = jt.drop_edge(gj, rate, key), tt.drop_edge(gt, rate, gen)
    np.testing.assert_allclose(dt.edge_weight.numpy(),
                               np.asarray(dj.edge_weight), rtol=1e-6)
    assert dt.meta_get("norm") is None and dict(dj.meta).get("norm") is None
    x = _rand((40, 6), 3)
    for fn in ("drop_node", "drop_feature"):
        np.testing.assert_allclose(
            getattr(tt, fn)(torch.from_numpy(x), rate, gen).numpy(),
            np.asarray(getattr(jt, fn)(jnp.asarray(x), rate, key)),
            rtol=1e-6, err_msg=fn)
    np.testing.assert_array_equal(
        tt.add_gaussian_noise(torch.from_numpy(x), 0.0, gen).numpy(),
        np.asarray(jt.add_gaussian_noise(jnp.asarray(x), 0.0, key)))


def test_normalize_features_matches_jax():
    from cogdl_tpu.utils import transforms as jt
    from cogdl_tpu_torch.utils import transforms as tt

    x = _rand((30, 9), 6)
    x[4] = 0.0
    np.testing.assert_allclose(
        tt.normalize_features(torch.from_numpy(x)).numpy(),
        np.asarray(jt.normalize_features(jnp.asarray(x))), rtol=RTOL,
        atol=ATOL)


def test_transforms_draw_their_masks_from_the_generator():
    """Each draw is the JAX transform's shape of mask (edges, whole rows,
    whole columns), scaled as there, and the same generator seed gives the
    same draw."""
    from cogdl_tpu_torch.utils import transforms as tt

    x = torch.ones(400, 50)
    rate = 0.3

    def gen(seed=1):
        return torch.Generator().manual_seed(seed)

    dn = tt.drop_node(x, rate, gen())
    rows = dn[:, 0]
    assert torch.equal(dn, rows[:, None].expand_as(dn))
    kept = rows != 0
    torch.testing.assert_close(rows[kept], torch.full_like(rows[kept],
                                                           1 / 0.7))
    assert 0.15 < float((rows == 0).float().mean()) < 0.45
    assert torch.equal(dn, tt.drop_node(x, rate, gen()))
    assert not torch.equal(dn, tt.drop_node(x, rate, gen(2)))
    df = tt.drop_feature(x, rate, gen())
    assert torch.equal(df, df[:1].expand_as(df))
    assert set(df.unique().tolist()) <= {0.0, 1.0}        # not rescaled
    noise = tt.add_gaussian_noise(torch.zeros(400, 50), 2.0, gen()) / 2.0
    assert abs(float(noise.mean())) < 0.05
    assert abs(float(noise.std()) - 1.0) < 0.05
    _, g = _graphs()
    de = tt.drop_edge(g, rate, gen())
    kept = de.edge_weight[: g.num_edges] > 0
    torch.testing.assert_close(de.edge_weight[: g.num_edges][kept],
                               g.edge_weight[: g.num_edges][kept] / 0.7)
    assert 0.1 < float((~kept).float().mean()) < 0.5


def test_drop_edge_on_a_prepared_graph_hands_k1_the_dropped_weights():
    from cogdl_tpu_torch.utils import transforms as tt

    _, g = _graphs()
    p = prepare_spmm(tg.sym_norm(g))
    d = tt.drop_edge(p, 0.5, torch.Generator().manual_seed(0))
    E = g.num_edges
    assert torch.equal(d.extras["spmm_fw_w"], d.edge_weight[:E])
    assert not torch.equal(d.extras["spmm_fw_w"], p.extras["spmm_fw_w"])
    assert d.extras["spmm_fw_ptr"] is p.extras["spmm_fw_ptr"]


# -- utils/grb.gnnguard_reweight ------------------------------------------------

@pytest.mark.parametrize("threshold", [0.1, 0.4])
@pytest.mark.parametrize("structure", [False, True])
def test_gnnguard_reweight_matches_jax_with_its_gradient(threshold,
                                                         structure):
    """The weights, and their gradient in the features through a weighted
    sum, against ``cogdl_tpu.utils.grb.gnnguard_reweight``; over a prepared
    graph the structure's forward weights are the new ones."""
    from cogdl_tpu.utils.grb import gnnguard_reweight as j_rw
    from cogdl_tpu_torch.utils.grb import gnnguard_reweight as t_rw

    gj, gt = _graphs(seed=3)
    if structure:
        gt = prepare_spmm(gt)
    h = _rand((gt.n_pad, 5), 7)
    h[:, 0] = np.abs(h[:, 0]) + 1.0          # many similar pairs
    r = _rand((gt.e_pad,), 8)

    def f_j(h):
        w = j_rw(gj, h, threshold).edge_weight
        return jnp.sum(w * r), w

    (_, w_j), dh_j = jax.value_and_grad(f_j, has_aux=True)(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    out = t_rw(gt, ht, threshold)
    (out.edge_weight * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.edge_weight.detach().numpy(),
                               np.asarray(w_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(dh_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    w = out.edge_weight.detach()
    assert (w[: gt.num_edges] == 0).any() and not w[gt.num_edges:].any()
    if structure:
        torch.testing.assert_close(out.extras["spmm_fw_w"].detach(),
                                   w[: gt.num_edges], rtol=0, atol=0)


# -- models/emb/base, PPRGo's and GDC's preprocessing ---------------------------

@pytest.mark.parametrize("directed", [False, True])
def test_graph_to_scipy_matches_jax(directed):
    from cogdl_tpu.models.emb.base import graph_to_scipy as j_sp
    from cogdl_tpu_torch.models.emb.base import graph_to_scipy as t_sp

    rng = np.random.default_rng(4)
    ei = rng.integers(0, 25, size=(2, 90))
    w = rng.uniform(0.1, 2.0, 90).astype(np.float32)
    a = j_sp(jg.from_coo(ei, num_nodes=25, edge_weight=w), directed)
    b = t_sp(tg.from_coo(ei, num_nodes=25, edge_weight=w), directed)
    assert a.shape == b.shape == (25, 25)
    np.testing.assert_allclose(b.toarray(), a.toarray(), rtol=1e-7)


def _same_graph(gt, gj):
    assert (gt.num_nodes, gt.n_pad, gt.num_edges, gt.e_pad) == (
        gj.num_nodes, gj.n_pad, gj.num_edges, gj.e_pad)
    np.testing.assert_array_equal(gt.row.numpy(), np.asarray(gj.row))
    np.testing.assert_array_equal(gt.col.numpy(), np.asarray(gj.col))
    np.testing.assert_allclose(gt.edge_weight.numpy(),
                               np.asarray(gj.edge_weight), rtol=1e-6,
                               atol=1e-7)
    for f in ("x", "y", "train_mask"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)


def _sbm_pair(n=30):
    from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
    from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm

    return (j_sbm(num_nodes=n, feat_dim=5, seed=2),
            t_sbm(num_nodes=n, feat_dim=5, seed=2))


@pytest.mark.parametrize("topk", [4, 32])
def test_topk_ppr_graph_matches_jax(topk):
    from cogdl_tpu.models.nn.pprgo import topk_ppr_graph as j_ppr
    from cogdl_tpu_torch.models.nn.pprgo import topk_ppr_graph as t_ppr

    gj, gt = _sbm_pair()
    a, b = j_ppr(gj, topk=topk), t_ppr(gt, topk=topk)
    _same_graph(b, a)
    counts = np.bincount(b.row[: b.num_edges].numpy(), minlength=30)
    assert counts.max() <= topk


@pytest.mark.parametrize("method", ["ppr", "heat"])
def test_gdc_diffuse_matches_jax(method):
    from cogdl_tpu.models.nn.gdc_gcn import gdc_diffuse as j_gdc
    from cogdl_tpu_torch.models.nn.gdc_gcn import gdc_diffuse as t_gdc

    gj, gt = _sbm_pair()
    _same_graph(t_gdc(gt, method=method), j_gdc(gj, method=method))


def test_embedding_model_is_an_interface():
    from cogdl_tpu_torch.models.emb.base import EmbeddingModel

    m = EmbeddingModel(hidden_size=16, seed=3, unused=1)
    assert (m.hidden_size, m.seed) == (16, 3)
    with pytest.raises(NotImplementedError):
        m.train_embeddings(None)


# -- MoE's flax fan rule ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 6), (3, 8, 6), (4, 64, 64),
                                   (2, 3, 5, 7)])
def test_moe_fans_are_flaxs(shape):
    """flax's ``glorot_uniform`` counts an ``[E, D, H]`` kernel's fans as
    ``D·E`` and ``H·E``; torch's ``xavier_uniform_`` as ``D·H`` and
    ``E·H``, so the port writes flax's rule."""
    from jax._src.nn.initializers import _compute_fans

    from cogdl_tpu_torch.layers.utils import flax_fans

    assert flax_fans(shape) == tuple(
        int(f) for f in _compute_fans(shape, -2, -1, ()))
    if len(shape) == 3:
        E, D, H = shape
        torch_fans = torch.nn.init._calculate_fan_in_and_fan_out(
            torch.empty(shape))
        assert flax_fans(shape) == (D * E, H * E) != torch_fans


def test_moe_init_spans_flaxs_limit():
    from cogdl_tpu_torch.models.nn.moe_gcn import MoEMLP

    m = MoEMLP(64, num_experts=4, hidden_size=32)
    m.reset_own_parameters(torch.Generator().manual_seed(0))
    limit = (6.0 / (64 * 4 + 32 * 4)) ** 0.5
    for p in (m.w1.detach(), m.w2.detach()):
        assert float(p.abs().max()) <= limit
        assert float(p.abs().max()) > 0.99 * limit
    j = jax.nn.initializers.glorot_uniform()(jax.random.PRNGKey(0),
                                             (4, 64, 32))
    assert float(jnp.abs(j).max()) <= limit
    assert float(jnp.abs(j).max()) > 0.99 * limit
    assert not m.b1.any() and not m.b2.any()


# -- the registry ----------------------------------------------------------------

def test_registry_and_defaults_name_the_slice():
    for name in SLICE:
        assert SUPPORTED_MODELS[name].rsplit(".", 1)[1] == \
            JAX_MODELS[name].rsplit(".", 1)[1], name
        assert DEFAULT_WRAPPER[name] == "node_classification"
        build_model(name, in_features=5, out_features=3)


def test_autognn_search_space_is_the_jax_packages():
    from cogdl_tpu.models.nn.autognn import AUTOGNN_SEARCH_SPACE as J
    from cogdl_tpu_torch.models.nn.autognn import AUTOGNN_SEARCH_SPACE as T

    assert T == J


# -- RevGAT's training branch under one set of attention masks -----------------

def test_revgat_training_under_the_same_attention_masks_matches_jax(
        monkeypatch):
    """RevGAT at attention dropout 0.3 in training mode, checkpointed, with
    flax's Bernoulli draws and the port's keep masks patched to one list of
    ``[e_pad, H]`` masks in draw order: the JAX logits and grads. The two
    packages then differ only in where their draws come from."""
    import flax.linen.stochastic as flax_stochastic

    import cogdl_tpu_torch.layers.gat_layer as gat_layer
    from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
    from test_torch_zoo_more import F_IN, _j_graph, _run_both

    graphs = (_j_graph(), t_sbm(num_nodes=200, feat_dim=F_IN, seed=5))
    rng = np.random.default_rng(0)
    masks = [rng.uniform(size=(graphs[0].e_pad, 2)) >= 0.3
             for _ in range(4)]             # 2 blocks x (F, G)
    j_queue, t_queue = list(masks), list(masks)
    monkeypatch.setattr(flax_stochastic.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(j_queue.pop(0)))
    monkeypatch.setattr(gat_layer, "dropout_keep",
                        lambda shape, rate, device, generator=None:
                        torch.from_numpy(t_queue.pop(0)))
    _run_both("revgat", graphs, structure=False, training=True, dropout=0.3)
    assert j_queue == [] and t_queue == []
