"""cogdl_tpu_torch's heterogeneous family against the JAX package on the CPU.

``hetero_sbm_graph`` array for array; ``Graph.to`` over metapath graphs;
``HANLayer`` (both semantic attentions) and ``RGCNLayer``; HAN, GTN, RGCN,
CompGCN and Simple-HGN, each with the JAX model's initial weights through
``load_jax_params``, logits at 1e-5 and the gradients of the masked
cross-entropy at 1e-4, with and without the kernel structure on the
metapath graphs (on the CPU it takes the plain K1 and K3); HAN's K3 keep
masks at attention dropout 0.6 against the Pallas kernel's; the
``heterogeneous_gnn`` wrapper's preparation; the refusal of a CUDA tensor
without structure; and each model's ``experiment()`` loss curve against
the JAX trainer's at 1e-4."""

import types

import jax
import numpy as np
import pytest
import torch

from cogdl_tpu.datasets import build_dataset as j_build_dataset
from cogdl_tpu.datasets.synthetic import hetero_sbm_graph as j_hetero
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.layers import HANLayer as JHANLayer
from cogdl_tpu.layers import RGCNLayer as JRGCNLayer
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.models.nn.compgcn import CompGCNLayer as JCompGCNLayer
from cogdl_tpu.ops.pallas import prepare_spmm as j_prepare_spmm
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu_torch.datasets import build_dataset
from cogdl_tpu_torch.datasets.synthetic import hetero_sbm_graph as t_hetero
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.layers import HANLayer, RGCNLayer
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.models.nn.compgcn import CompGCNLayer
from cogdl_tpu_torch.ops.cuda import (
    GATFusedFunction,
    maybe_cuda_gat_fused,
    maybe_cuda_spmm,
    prepare_spmm,
)
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.trainer.trainer import Trainer
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from cogdl_tpu_torch.wrappers import DEFAULT_WRAPPER
from cogdl_tpu_torch.wrappers.heterogeneous import HeterogeneousGNNWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)
from test_torch_gat import ALPHA, _jax_gat_fused, _k3_inputs

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 on both sides with the same weights, summed in other orders: logits
# 1e-5, grads 1e-4; per-epoch losses after a few Adam steps 1e-4
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-4
# K3's plain version against the Pallas kernel (tests/test_torch_gat.py)
K3_FWD_RTOL, K3_FWD_ATOL = 1e-5, 1e-6
K3_GRAD_RTOL, K3_GRAD_ATOL = 1e-4, 1e-5
NODES, F_IN, CLASSES = 150, 12, 3
FIELDS = ("row_ptr", "row", "col", "edge_weight", "edge_type", "x", "y",
          "train_mask", "val_mask", "test_mask")
MODELS = ("han", "gtn", "rgcn", "compgcn", "simple_hgn")
# small widths, dropout off
MODEL_KW = {
    "han": dict(hidden_size=4, nhead=2, dropout=0.0),
    "gtn": dict(hidden_size=8, dropout=0.0),
    "rgcn": dict(hidden_size=8, num_relations=2),
    "compgcn": dict(hidden_size=8, num_relations=2, dropout=0.0),
    "simple_hgn": dict(hidden_size=4, nhead=2, edge_dim=3, dropout=0.0,
                       attn_drop=0.0),
}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_graph_equal(gj, gt, tag):
    for f in FIELDS:
        a, b = getattr(gj, f), getattr(gt, f)
        assert (a is None) == (b is None), (tag, f)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{tag} {f}")
    assert (gj.num_nodes, gj.num_edges) == (gt.num_nodes, gt.num_edges)
    assert dict(gj.meta) == dict(gt.meta), tag


@pytest.mark.parametrize("kw", [{}, dict(num_nodes=200, num_types=2,
                                         num_classes=4, num_metapaths=3,
                                         feat_dim=5, seed=3)])
def test_hetero_sbm_graph_is_the_jax_packages(kw):
    gj, gt = j_hetero(**kw), t_hetero(**kw)
    _assert_graph_equal(gj, gt, "union")
    mj, mt = gj.extras["metapath_graphs"], gt.extras["metapath_graphs"]
    assert len(mj) == len(mt) == kw.get("num_metapaths", 2)
    for i, (a, b) in enumerate(zip(mj, mt)):
        _assert_graph_equal(a, b, f"metapath {i}")
        assert b.n_pad == gt.n_pad
    np.testing.assert_array_equal(np.asarray(gj.extras["node_type"]),
                                  gt.extras["node_type"].numpy())
    assert gt.extras["relation_graphs"] is mt
    ds = build_dataset("hetero-sbm", **kw)
    assert ds.num_classes == kw.get("num_classes", 3)
    _assert_graph_equal(gt, ds.graph, "build_dataset")


def test_graph_to_moves_metapath_graphs_and_keeps_the_shared_tuple():
    g = t_hetero(num_nodes=60, feat_dim=4)
    extras = dict(g.extras, one=g.extras["metapath_graphs"][0],
                  copy=tuple(m for m in g.extras["relation_graphs"]))
    moved = g.replace(extras=extras).to("meta")
    ex = moved.extras
    assert moved.x.is_meta and ex["node_type"].is_meta
    assert ex["metapath_graphs"] is ex["relation_graphs"]
    assert ex["copy"] is not ex["metapath_graphs"]
    assert all(m.col.is_meta and m.device.type == "meta"
               for key in ("metapath_graphs", "copy") for m in ex[key])
    assert ex["one"].row_ptr.is_meta
    # a moved structure keeps its shape
    assert [m.n_pad for m in ex["copy"]] == [g.n_pad] * 2


@pytest.fixture(scope="module")
def graphs():
    """The same heterogeneous graph in both packages, and the port's with
    the kernel structure on each metapath graph."""
    gj = j_hetero(num_nodes=NODES, feat_dim=F_IN, seed=4)
    gt = t_hetero(num_nodes=NODES, feat_dim=F_IN, seed=4)
    metas = tuple(prepare_spmm(m) for m in gt.extras["metapath_graphs"])
    pt = gt.replace(extras=dict(gt.extras, metapath_graphs=metas,
                                relation_graphs=metas))
    return gj, gt, pt


def _check_grads(tm, grads_j, build, scaled=False):
    """Each parameter's gradient against the JAX one, elementwise at
    ``GRAD_RTOL`` / ``GRAD_ATOL``; with ``scaled``, at ``GRAD_ATOL`` times
    the tensor's largest entry. A parameter that the output does not reach
    has no torch gradient and a zero JAX one."""
    ref = load_jax_params(build(), _host(grads_j))
    ref_params = dict(ref.named_parameters())
    assert set(ref_params) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        want = ref_params[name].detach().numpy()
        got = (np.zeros_like(want) if p.grad is None else p.grad.numpy())
        if scaled:
            np.testing.assert_allclose(
                got, want, rtol=0, err_msg=name,
                atol=GRAD_ATOL * max(1.0, float(np.abs(want).max())))
        else:
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)


def _probe(n, width, seed=8):
    return np.random.default_rng(seed).normal(size=(n, width)).astype(
        np.float32)


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("sem_att", ["han", "linear"])
def test_han_layer_matches_jax(graphs, sem_att, structure):
    gj, gt, pt = graphs
    g = pt if structure else gt
    kw = dict(nhead=2, num_metapaths=2, dropout=0.0, sem_att=sem_att)
    jl = JHANLayer(3, **kw)
    jgs = list(gj.extras["metapath_graphs"])
    params = _host(jl.init(jax.random.PRNGKey(1), jgs, gj.x))["params"]
    probe = _probe(gj.n_pad, 6)

    def f(p):
        out = jl.apply({"params": p}, jgs, gj.x, training=True)
        return (out * probe).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(f, has_aux=True)(params)

    def build():
        return HANLayer(F_IN, 3, **kw)

    tl = load_jax_params(build(), params)
    out_t = tl(list(g.extras["metapath_graphs"]), g.x, training=True)
    (out_t * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    # the "linear" score is unbounded: its weight's gradient sums terms of
    # both signs up to 1e2 into entries near 1e-2, so the summation order
    # alone moves those by 1e-4 (the "han" flavour's softmax bounds them)
    _check_grads(tl, grads_j, build, scaled=sem_att == "linear")


@pytest.mark.parametrize("num_bases,self_loop", [(4, True), (1, False)])
def test_rgcn_layer_matches_jax(graphs, num_bases, self_loop):
    gj, gt, _ = graphs
    kw = dict(num_bases=num_bases, self_loop=self_loop)
    jl = JRGCNLayer(5, 2, **kw)
    params = _host(jl.init(jax.random.PRNGKey(2), gj, gj.x))["params"]
    probe = _probe(gj.n_pad, 5)

    def f(p):
        out = jl.apply({"params": p}, gj, gj.x)
        return (out * probe).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(f, has_aux=True)(params)

    def build():
        return RGCNLayer(F_IN, 5, 2, **kw)

    tl = load_jax_params(build(), params)
    assert tl.basis.shape == (min(num_bases, 2), F_IN, 5)
    out_t = tl(gt, gt.x)
    (out_t * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    _check_grads(tl, grads_j, build)


@pytest.mark.parametrize("comp", ["sub", "mult"])
def test_compgcn_layer_matches_jax(graphs, comp):
    gj, gt, _ = graphs
    rel = np.random.default_rng(3).normal(size=(2, F_IN)).astype(np.float32)
    jl = JCompGCNLayer(5, comp=comp)
    params = _host(jl.init(jax.random.PRNGKey(2), gj, gj.x, rel))["params"]
    probe = _probe(gj.n_pad, 5)

    def f(p, r):
        out, rel_out = jl.apply({"params": p}, gj, gj.x, r)
        return (out * probe).sum() + rel_out.sum(), (out, rel_out)

    (_, outs_j), (grads_j, drel_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, rel)

    def build():
        return CompGCNLayer(F_IN, 5, comp=comp)

    tl = load_jax_params(build(), params)
    rel_t = torch.from_numpy(rel).requires_grad_(True)
    out_t, rel_out_t = tl(gt, gt.x, rel_t)
    ((out_t * torch.from_numpy(probe)).sum() + rel_out_t.sum()).backward()
    for a, b in zip((out_t, rel_out_t), outs_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(rel_t.grad.numpy(), np.asarray(drel_j),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _check_grads(tl, grads_j, build)


def _run_both(graphs, model, structure, **extra):
    """Logits and loss gradients of the JAX model and of the port model
    with its initial weights, on the same graph (the port's with the kernel
    structure on its metapath graphs when ``structure``)."""
    gj, gt, pt = graphs
    g = pt if structure else gt
    kw = dict(in_features=F_IN, out_features=CLASSES, **MODEL_KW[model],
              **extra)
    jm = j_build_model(model, **kw)
    variables = _host(jm.init({"params": jax.random.PRNGKey(3),
                               "dropout": jax.random.PRNGKey(3)},
                              gj, gj.x, training=False))
    mask_j = gj.train_mask & gj.node_mask()

    def loss_j(params):
        logits = jm.apply({"params": params}, gj, gj.x, training=True)
        if isinstance(logits, tuple):
            logits = logits[0]
        return j_mce(logits, gj.y, mask_j), logits

    (_, logits_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])

    def build():
        return build_model(model, **kw)

    tm = load_jax_params(build(), variables["params"])
    logits_t = tm(g, g.x, training=True)
    if isinstance(logits_t, tuple):
        logits_t = logits_t[0]
    masked_cross_entropy(logits_t, g.y, g.train_mask & g.node_mask()
                         ).backward()
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    _check_grads(tm, grads_j, build)
    return tm


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_model_matches_jax(graphs, model, structure):
    """With the structure, HAN runs the plain K3 and GTN the plain K1 over
    each metapath graph; the other three read only the union graph."""
    sk.reset_launch_counts()
    tm = _run_both(graphs, model, structure)
    assert DEFAULT_WRAPPER[model] == "heterogeneous_gnn"
    # the plain versions count no launch
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)
    if model == "simple_hgn":
        assert tm.layer0.edge_emb.shape == (5, 3)   # max(5, 2 relations)


@pytest.mark.parametrize("extra", [dict(num_layers=2), dict(num_layers=3)])
def test_deeper_han_and_compgcn_match_jax(graphs, extra):
    _run_both(graphs, "han", True, **extra)
    _run_both(graphs, "compgcn", False, **extra)


def test_compgcn_entity_embeddings_and_relations_match_jax(graphs):
    """``num_entities`` and no ``x`` (link prediction's call): the input is
    flax ``nn.Embed``'s ``ent`` over ``arange(n_pad) % num_entities``,
    which ``load_jax_params`` fills; ``return_rel`` gives the last layer's
    relation embeddings too. Logits, relations and every gradient (the
    embedding's included) against the JAX model's."""
    gj, gt, _ = graphs
    kw = dict(in_features=F_IN, out_features=CLASSES, num_entities=40,
              return_rel=True, **MODEL_KW["compgcn"])
    jm = j_build_model("compgcn", **kw)
    params = _host(jm.init(jax.random.PRNGKey(4), gj, None))["params"]
    probe = _probe(gj.n_pad, CLASSES)

    def f(p):
        z, rel = jm.apply({"params": p}, gj, None, training=True)
        return (z * probe).sum() + rel.sum(), (z, rel)

    (_, outs_j), grads_j = jax.value_and_grad(f, has_aux=True)(params)

    def build():
        return build_model("compgcn", **kw)

    tm = load_jax_params(build(), params)
    assert tm.ent.weight.shape == (40, 8) and tm.rel.shape == (2, 8)
    z, rel = tm(gt, training=True)
    ((z * torch.from_numpy(probe)).sum() + rel.sum()).backward()
    assert z.shape == (gt.n_pad, CLASSES) and rel.shape == (2, CLASSES)
    for a, b in zip((z, rel), outs_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    _check_grads(tm, grads_j, build)


def test_models_fit_the_graphs_counts():
    """HAN's metapaths, GTN's relations and Simple-HGN's edge types come
    from the graph at the wrapper's ``init``, as flax sizes them at the
    first call; the logits then match the JAX model's."""
    kw = dict(num_nodes=90, feat_dim=6, num_metapaths=6, seed=2)
    gj, gt = j_hetero(**kw), t_hetero(**kw)
    for model in ("han", "gtn", "simple_hgn"):
        mkw = dict(in_features=6, out_features=3, **MODEL_KW[model])
        jm = j_build_model(model, **mkw)
        params = _host(jm.init(jax.random.PRNGKey(0), gj, gj.x))["params"]
        tm = build_model(model, **mkw)
        with pytest.raises((KeyError, RuntimeError)):
            load_jax_params(tm, params)
        HeterogeneousGNNWrapper(tm).init(torch.Generator().manual_seed(0),
                                         gt)
        load_jax_params(tm, params)
        np.testing.assert_allclose(
            tm(gt).detach().numpy(),
            np.asarray(jm.apply({"params": params}, gj, gj.x)),
            rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=model)
    assert tm.layer0.edge_emb.shape[0] == 6


def test_reset_parameters_is_seeded_and_follows_the_flax_initialisers():
    for name in MODELS:
        kw = dict(in_features=F_IN, out_features=CLASSES, **MODEL_KW[name],
                  **({"num_entities": 7} if name == "compgcn" else {}))
        a, b = build_model(name, **kw), build_model(name, **kw)
        with torch.no_grad():
            for p in b.parameters():
                p.fill_(7.0)
        a.reset_parameters(torch.Generator().manual_seed(3))
        b.reset_parameters(torch.Generator().manual_seed(3))
        for (n, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), (name, n)
            assert not torch.all(q == 7.0), (name, n)
    gtn = build_model("gtn", in_features=4, out_features=2)
    gtn.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(gtn.alpha_c1_l1, torch.full((2,), 0.5))
    comp = build_model("compgcn", in_features=4, out_features=2,
                       num_entities=500, hidden_size=400)
    comp.reset_parameters(torch.Generator().manual_seed(0))
    assert float(comp.ent.weight.detach().std()) == pytest.approx(400 ** -0.5,
                                                         rel=0.02)


def test_unknown_options_raise():
    with pytest.raises(ValueError, match="sem_att"):
        HANLayer(4, 2, sem_att="x")
    with pytest.raises(ValueError, match="comp"):
        CompGCNLayer(4, 2, comp="x")
    g = t_hetero(num_nodes=30, feat_dim=4)
    with pytest.raises(ValueError, match="edge_type"):
        build_model("rgcn", in_features=4, out_features=2)(
            g.replace(edge_type=None))
    han = build_model("han", in_features=4, out_features=2, num_metapaths=3)
    with pytest.raises(ValueError, match="3 metapaths got 2"):
        han(g)


# -- K3 masks, the wrapper, no fallback ---------------------------------------

@pytest.mark.parametrize("attn_drop", [0.0, 0.6])
def test_han_k3_masks_match_the_pallas_kernel_on_each_metapath_graph(
        attn_drop):
    """K3 at HAN's (8, 8) over each metapath graph: the plain K3 through
    GATFusedFunction against gat_fused in interpret mode with the same
    seed, so the keep masks at attention dropout 0.6 are the JAX
    package's."""
    gj = j_hetero(num_nodes=80, feat_dim=4, seed=1)
    gt = t_hetero(num_nodes=80, feat_dim=4, seed=1)
    H, D = 8, 8
    for i, (mj, mt) in enumerate(zip(gj.extras["metapath_graphs"],
                                     gt.extras["metapath_graphs"])):
        pj, pt = j_prepare_spmm(mj), prepare_spmm(mt)
        seed = 13579 + i
        sd, ss, h, a_src, probe = _k3_inputs(mt, pj.n_pad, H, D, seed=i)
        ref = _jax_gat_fused(pj, H, D, attn_drop, seed, sd, ss, h, a_src,
                             probe)
        n, m = pt.n_pad, pt.num_nodes
        ins = [torch.from_numpy(a[:n]).requires_grad_(True)
               for a in (sd, ss, h.reshape(-1, H * D))]
        ex = pt.extras
        out = GATFusedFunction.apply(
            *ins, *(ex[k] for k in ("spmm_fw_ptr", "spmm_fw_col",
                                    "spmm_fw_orig", "spmm_bw_ptr",
                                    "spmm_bw_col", "spmm_bw_orig")),
            torch.tensor([seed]) if attn_drop else None, ALPHA, attn_drop)
        (out * torch.from_numpy(probe[:n])).sum().backward()
        np.testing.assert_allclose(out.detach().numpy()[:m], ref[0][:m],
                                   rtol=K3_FWD_RTOL, atol=K3_FWD_ATOL,
                                   err_msg=f"metapath {i}")
        for name, t, r in zip(("dsd", "dss", "dh"), ins, ref[1:]):
            np.testing.assert_allclose(t.grad.numpy()[:m], r[:m],
                                       rtol=K3_GRAD_RTOL, atol=K3_GRAD_ATOL,
                                       err_msg=f"metapath {i} {name}")


def test_han_under_attention_dropout_drops_the_k3_hash_masks(graphs,
                                                             monkeypatch):
    """HAN in training at attention dropout 0.6 over the structure (the
    plain K3, its seeds fixed) equals HAN over the bare graphs (the
    unfused route) given the keep masks of K3's hash at those seeds, edge
    for edge and head for head."""
    _, gt, pt = graphs
    kw = dict(in_features=F_IN, out_features=CLASSES, hidden_size=4, nhead=2,
              dropout=0.6)
    net = build_model("han", **kw)
    net.reset_parameters(torch.Generator().manual_seed(5))
    seeds = iter([torch.tensor([101]), torch.tensor([202])])
    monkeypatch.setattr("cogdl_tpu_torch.ops.cuda.draw_gat_seed",
                        lambda gen, dev: next(seeds))
    fused = net(pt, training=True)
    layer = net.han0
    outs = []
    for i, (g, s) in enumerate(zip(gt.extras["metapath_graphs"], (101, 202))):
        E = g.num_edges
        keep = sk.dropout_keep_reference(torch.arange(E, dtype=torch.int32),
                                         torch.tensor([s]), 2, 0.6) > 0
        keep = torch.cat([keep, keep.new_zeros(g.e_pad - E, 2)])
        outs.append(getattr(layer, f"gat{i}")(g, gt.x, True,
                                              attn_rand=keep))
    z = torch.stack(outs, 1)
    beta = torch.softmax((torch.tanh(layer.sem_fc(z)) @ layer.sem_q)
                         .mean(0).squeeze(-1), 0)
    ref = net.out(torch.einsum("m,nmf->nf", beta, z))
    np.testing.assert_allclose(fused.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-4, atol=1e-5)


def test_wrapper_prepares_the_metapath_graphs_for_han_and_gtn_only(
        graphs, monkeypatch):
    """The card's preparation, rehearsed with ``prepare_spmm`` as the
    wrapper's ``with_structure``: HAN and GTN get the structure on every
    metapath graph, one tuple under both keys; RGCN, CompGCN and
    Simple-HGN get the graph back as it is. The union graph never changes:
    no self loops, no normalisation, no structure."""
    _, gt, _ = graphs
    monkeypatch.setattr(HeterogeneousGNNWrapper, "with_structure",
                        staticmethod(prepare_spmm))
    for name in MODELS:
        net = build_model(name, in_features=F_IN, out_features=CLASSES)
        out = HeterogeneousGNNWrapper(net).prepare_graph(gt)
        for f in FIELDS:
            a, b = getattr(gt, f), getattr(out, f)
            assert a is b, (name, f)
        assert out.meta == gt.meta
        assert not any(k.startswith("spmm_") for k in out.extras)
        ex = out.extras
        assert ex["metapath_graphs"] is ex["relation_graphs"]
        assert ex["node_type"] is gt.extras["node_type"]
        if name in ("han", "gtn"):
            assert all("spmm_fw_w" in m.extras and "spmm_bw_orig" in m.extras
                       for m in ex["metapath_graphs"])
        else:
            assert out is gt
    # on the CPU the wrapper's own with_structure leaves them bare
    monkeypatch.undo()
    net = build_model("han", in_features=F_IN, out_features=CLASSES)
    out = HeterogeneousGNNWrapper(net).prepare_graph(gt)
    assert all(m is n for m, n in zip(out.extras["metapath_graphs"],
                                      gt.extras["metapath_graphs"]))


def test_a_cuda_tensor_without_structure_raises_on_a_metapath_graph(graphs):
    """No fallback on the card: K1 and K3 over a metapath graph that the
    wrapper did not prepare raise for a CUDA tensor (a stand-in with what
    the dispatchers read of one), where a CPU tensor takes the plain
    route."""
    _, gt, pt = graphs
    bare = gt.extras["metapath_graphs"][0]
    on_card = types.SimpleNamespace(is_cuda=True, ndim=2)
    with pytest.raises(RuntimeError, match="prepare_spmm"):
        maybe_cuda_spmm(bare, on_card)
    with pytest.raises(RuntimeError, match="prepare_spmm"):
        maybe_cuda_gat_fused(bare, None, None, on_card)
    h = torch.zeros(gt.n_pad, 8, 8)
    s = torch.zeros(gt.n_pad, 8)
    assert maybe_cuda_spmm(bare, h[:, 0]) is None
    assert maybe_cuda_gat_fused(bare, s, s, h) is None
    prepared = pt.extras["metapath_graphs"][0]
    assert maybe_cuda_spmm(prepared, h[:, 0]).shape == (gt.n_pad, 8)
    assert maybe_cuda_gat_fused(prepared, s, s, h).shape == h.shape


# -- loss curves through experiment() -----------------------------------------

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
    "han": dict(hidden_size=4, nhead=4, dropout=0.0),
    "gtn": dict(hidden_size=16, dropout=0.0),
    "rgcn": dict(hidden_size=16, num_relations=2),
    "compgcn": dict(hidden_size=16, num_relations=2, dropout=0.0),
    "simple_hgn": dict(hidden_size=8, nhead=2, edge_dim=8, dropout=0.0,
                       attn_drop=0.0),
}


@pytest.mark.parametrize("model", MODELS)
def test_loss_curve_matches_the_jax_trainer(monkeypatch, model):
    """``experiment(dataset="hetero-sbm", model=...)`` on the
    ``heterogeneous_gnn`` wrapper against ``cogdl_tpu.experiments.train``
    from the JAX initial weights, dropout 0: the same train loss at every
    epoch, the same best epoch and test accuracy; no kernel launched."""
    kw = dict(epochs=4, eval_step=1, patience=100, seed=0, **CURVES[model])
    rec = _Recorder()
    jd = j_build_dataset("hetero-sbm")
    res_j = j_train(jd, model, logger=rec, **kw)
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    gj = jd.graph
    variables = _host(j_build_model(
        model, in_features=gj.x.shape[1], out_features=3,
        **CURVES[model]).init({"params": init_rng, "dropout": init_rng}, gj,
                              gj.x, training=False))
    monkeypatch.setattr(
        HeterogeneousGNNWrapper, "init", lambda self, gen, graph:
        load_jax_params(self.model, variables["params"]))
    steps = []
    real_step = Trainer.train_step

    def step(self, *a):
        loss = real_step(self, *a)
        steps.append(float(loss))
        return loss

    monkeypatch.setattr(Trainer, "train_step", step)
    sk.reset_launch_counts()
    (res_t,) = experiment(dataset=build_dataset("hetero-sbm"), model=model,
                          device="cpu", **kw)[("hetero-sbm", model)]
    assert len(steps) == 4
    np.testing.assert_allclose(steps, rec.losses, rtol=LOSS_RTOL)
    assert res_t["best_epoch"] == res_j["best_epoch"]
    assert res_t["test_acc"] == pytest.approx(res_j["test_acc"], abs=1e-6)
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)
