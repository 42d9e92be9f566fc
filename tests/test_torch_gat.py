"""cogdl_tpu_torch's GAT slice against the JAX package on the CPU: the plain
attention ops, K3's plain version (through ``GATFusedFunction``) against
the Pallas ``gat_fused`` in interpret mode with and without attention
dropout, the GAT layer and model on both port routes with the JAX weights
injected through ``load_jax_params``, and GAT through ``experiment()``."""

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
from cogdl_tpu.layers import GATLayer as JGATLayer
from cogdl_tpu.models.nn.gat import GAT as JGAT
from cogdl_tpu.ops.spmm import gather_src as j_gather_src
from cogdl_tpu.ops.pallas import prepare_spmm as j_prepare_spmm
from cogdl_tpu.ops.pallas.segment_kernels import build_ar, gat_fused
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.layers import GATLayer
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import (
    GAT_MAX_HEADS,
    GATFusedFunction,
    build_spmm_schedule,
    gat_pass,
    gat_pass_chunked_reference,
    gat_pass_reference,
    maybe_cuda_gat_fused,
    prepare_spmm,
)
from cogdl_tpu_torch.ops.cuda.segment_kernels import dropout_keep_reference
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# plain ops: the same fp32 arithmetic, summed in another order
OPS_RTOL, OPS_ATOL = 1e-5, 1e-6
# K3's plain version against the Pallas kernel: the masks agree bit for bit,
# only the summation order differs (the backward sums terms that cancel)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# layer / model: fp32 dense layers and attention on both sides, the fused
# route shifting the softmax by another (exact) bound than the segment max
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
ALPHA = 0.2


def _np(t):
    return t.detach().numpy()


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def graphs():
    """The same 200-node sbm graph with self loops in both packages (the
    TestGatFused set-up of tests/test_pallas_kernels.py), the JAX one with
    the Pallas layouts and the port's with the CUDA structure."""
    gj = jg.add_self_loops(j_sbm(num_nodes=200, seed=5))
    gt = tg.add_self_loops(t_sbm(num_nodes=200, seed=5))
    E = gt.num_edges
    np.testing.assert_array_equal(np.asarray(gj.row)[:E], _np(gt.row)[:E])
    np.testing.assert_array_equal(np.asarray(gj.col)[:E], _np(gt.col)[:E])
    return gj, j_prepare_spmm(gj), gt, prepare_spmm(gt)


# -- the plain ops -----------------------------------------------------------

@pytest.mark.parametrize("op", ["gather_src", "sddmm", "edge_softmax",
                                "mh_spmm", "mh_sddmm"])
def test_plain_attention_ops_match(graphs, op):
    gj, _, gt, _ = graphs
    rng = np.random.default_rng(11)
    n, E = gt.n_pad, gt.e_pad
    a = rng.normal(size=(n, 3, 4)).astype(np.float32)
    b = rng.normal(size=(n, 3, 4)).astype(np.float32)
    att = rng.uniform(size=(E, 3)).astype(np.float32)
    scores = rng.normal(size=(E, 3)).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    if op == "gather_src":
        cases = [(tops.gather_src(gt, t(a[:, 0])), j_gather_src(gj, j(a[:, 0])))]
    elif op == "sddmm":
        cases = [(tops.sddmm(gt, t(a[:, 0]), t(b[:, 0])),
                  jops.sddmm(gj, j(a[:, 0]), j(b[:, 0]))),
                 (tops.sddmm(gt, t(a), t(b)), jops.sddmm(gj, j(a), j(b)))]
    elif op == "edge_softmax":
        cases = [(tops.edge_softmax(gt, t(scores)),
                  jops.edge_softmax(gj, j(scores))),
                 (tops.edge_softmax(gt, t(scores[:, 0])),
                  jops.edge_softmax(gj, j(scores[:, 0])))]
    elif op == "mh_spmm":
        cases = [(tops.mh_spmm(gt, t(att), t(a)), jops.mh_spmm(gj, j(att), j(a)))]
    else:
        cases = [(tops.mh_sddmm(gt, t(a), t(b)), jops.mh_sddmm(gj, j(a), j(b)))]
    for out_t, out_j in cases:
        np.testing.assert_allclose(_np(out_t), np.asarray(out_j),
                                   rtol=OPS_RTOL, atol=OPS_ATOL)


# -- K3's plain version against the Pallas kernel ------------------------------

def _hash_numpy(orig, seed, H, attn_drop):
    """The TPU kernel's dropout hash in numpy uint32 arithmetic (wrapping),
    an implementation independent of the port's int64 one."""
    with np.errstate(over="ignore"):
        ek = orig.astype(np.uint32) ^ np.uint32(seed)
        hx = ek[:, None] * np.uint32(H) + np.arange(H, dtype=np.uint32)
        hx = hx * np.uint32(747796405) + np.uint32(2891336453)
        hx ^= hx >> np.uint32(16)
        hx = hx * np.uint32(0x85EBCA6B)
        hx ^= hx >> np.uint32(13)
        hx = hx * np.uint32(0xC2B2AE35)
        hx ^= hx >> np.uint32(16)
    thresh = np.uint32(int((1.0 - attn_drop) * float(2 ** 32 - 1)))
    return np.where(hx < thresh, np.float32(1.0 / (1.0 - attn_drop)),
                    np.float32(0.0))


@pytest.mark.parametrize("attn_drop", [0.1, 0.5, 0.6])
def test_dropout_hash_matches_uint32_arithmetic(attn_drop):
    rng = np.random.default_rng(3)
    orig = rng.integers(0, 2 ** 31 - 1, size=4000).astype(np.int32)
    for seed, H in ((0, 1), (12345, 8), (2 ** 31 - 2, 32)):
        keep = dropout_keep_reference(torch.from_numpy(orig),
                                      torch.tensor([seed]), H, attn_drop)
        np.testing.assert_array_equal(_np(keep),
                                      _hash_numpy(orig, seed, H, attn_drop))
        assert abs(float((keep > 0).float().mean()) - (1 - attn_drop)) < 0.03


def _k3_inputs(gt, n_j, H, D, seed=7):
    """sd, ss = Σ_d a_src·h and h over the JAX package's padded rows; rows
    past the real nodes are zero in h, so both packages' ``max ss`` agree
    though they pad to different row counts."""
    rng = np.random.default_rng(seed)
    sd = rng.normal(size=(n_j, H)).astype(np.float32)
    h = rng.normal(size=(n_j, H, D)).astype(np.float32)
    h[gt.num_nodes:] = 0.0
    a_src = (rng.normal(size=(H, D)) / np.sqrt(D)).astype(np.float32)
    ss = np.einsum("nhd,hd->nh", h, a_src).astype(np.float32)
    probe = rng.normal(size=(n_j, H * D)).astype(np.float32)
    return sd, ss, h, a_src, probe


def _jax_gat_fused(pj, H, D, attn_drop, seed, sd, ss, h, a_src, probe):
    ex = pj.extras
    ar = build_ar(jnp.asarray(a_src), H, D)

    def f(sd, ss, h2):
        return gat_fused(H, D, ALPHA, attn_drop, sd, ss, h2, ar,
                         jnp.uint32(seed),
                         ex["spmm_fw_col"], ex["spmm_fw_row"],
                         ex["spmm_fw_ones"], ex["spmm_fw_ct"],
                         ex["spmm_fw_orig"], ex["spmm_bw_col"],
                         ex["spmm_bw_row"], ex["spmm_bw_ones"],
                         ex["spmm_bw_ct"], ex["spmm_bw_orig"])

    out, vjp = jax.vjp(f, jnp.asarray(sd), jnp.asarray(ss),
                       jnp.asarray(h.reshape(len(h), H * D)))
    return (np.asarray(out),) + tuple(np.asarray(x) for x in vjp(jnp.asarray(probe)))


@pytest.mark.parametrize("attn_drop", [0.0, 0.5])
@pytest.mark.parametrize("H,D", [(4, 8), (1, 5)])
def test_plain_k3_matches_pallas_gat_fused(graphs, H, D, attn_drop):
    """Forward and the grads of sd, ss and h through GATFusedFunction on CPU
    tensors (the plain K3) against gat_fused in interpret mode."""
    _, pj, gt, pt = graphs
    seed = 987654321
    sd, ss, h, a_src, probe = _k3_inputs(gt, pj.n_pad, H, D)
    ref = _jax_gat_fused(pj, H, D, attn_drop, seed, sd, ss, h, a_src, probe)
    n = gt.n_pad
    ins = [torch.from_numpy(a[:n]).requires_grad_(True)
           for a in (sd, ss, h.reshape(-1, H * D))]
    ex = pt.extras
    out = GATFusedFunction.apply(
        *ins, *(ex[k] for k in ("spmm_fw_ptr", "spmm_fw_col", "spmm_fw_orig",
                                "spmm_bw_ptr", "spmm_bw_col", "spmm_bw_orig")),
        torch.tensor([seed]) if attn_drop else None, ALPHA, attn_drop)
    (out * torch.from_numpy(probe[:n])).sum().backward()
    m = gt.num_nodes
    np.testing.assert_allclose(_np(out)[:m], ref[0][:m], rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    for name, t, r in zip(("dsd", "dss", "dh"), ins, ref[1:]):
        np.testing.assert_allclose(_np(t.grad)[:m], r[:m], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.fixture(scope="module")
def hub_graphs():
    """A 200-node graph with a star hub, in both packages with their kernel
    structures: node 0 is the destination of 40 edges and the source of 40
    more, besides 600 random edges and the self loops, so that its row of
    the CSR and its column (the CSC's row) hold more than 2T + 1 = 17 edges
    at T = 8 and are cut into three chunks or more."""
    n = 200
    rng = np.random.default_rng(9)
    hub = np.arange(1, 41)
    row = np.concatenate([rng.integers(0, n, 600), np.zeros(40, np.int64),
                          hub, np.arange(n)])
    col = np.concatenate([rng.integers(0, n, 600), hub,
                          np.zeros(40, np.int64), np.arange(n)])
    ei = np.stack([row, col])
    gj = jg.from_coo(ei, num_nodes=n, coalesce=True)
    gt = tg.from_coo(ei, num_nodes=n, coalesce=True)
    E = gt.num_edges
    np.testing.assert_array_equal(np.asarray(gj.row)[:E], _np(gt.row)[:E])
    np.testing.assert_array_equal(np.asarray(gj.col)[:E], _np(gt.col)[:E])
    return gj, j_prepare_spmm(gj), gt, prepare_spmm(gt)


HUB_CHUNK = 8


@pytest.mark.parametrize("attn_drop", [0.0, 0.5])
@pytest.mark.parametrize("H,D", [(4, 8), (1, 5)])
def test_chunked_k3_matches_pallas_gat_fused_on_a_hub(hub_graphs, H, D,
                                                      attn_drop):
    """Forward and the grads of sd, ss and h2 through GATFusedFunction on
    CPU tensors (the plain K3) and through the plain version cut the way
    the chunk kernel cuts it at T = 8 (the hub row and column in pieces,
    each piece's dots taken before it is stored), against gat_fused in
    interpret mode, with the same weights and the same keep masks."""
    _, pj, gt, pt = hub_graphs
    seed = 24680
    sd, ss, h, a_src, probe = _k3_inputs(gt, pj.n_pad, H, D)
    ref = _jax_gat_fused(pj, H, D, attn_drop, seed, sd, ss, h, a_src, probe)
    n, m = gt.n_pad, gt.num_nodes
    ex = pt.extras
    keys = [ex[f"spmm_{d}_{k}"] for d in ("fw", "bw")
            for k in ("ptr", "col", "orig")]
    scheds = [build_spmm_schedule(ex[f"spmm_{d}_ptr"], HUB_CHUNK,
                                  ex[f"spmm_{d}_erow"]) for d in ("fw", "bw")]
    # the hub is cut in both directions
    assert all(int(sc.cross[0, 0]) == 0 and int(sc.cross[0, 2])
               - int(sc.cross[0, 1]) >= 2 for sc in scheds)
    ins = [torch.from_numpy(a[:n]).requires_grad_(True)
           for a in (sd, ss, h.reshape(-1, H * D))]
    drop_seed = torch.tensor([seed]) if attn_drop else None
    out = GATFusedFunction.apply(*ins, *keys, drop_seed, ALPHA, attn_drop,
                                 *scheds)
    g = torch.from_numpy(probe[:n])
    (out * g).sum().backward()
    fused = [out.detach()] + [t.grad for t in ins]
    # the same VJP through the chunked plain version
    sd_t, ss_t, h2_t = (t.detach() for t in ins)
    smax = ss_t.amax(0)
    kw = dict(alpha=ALPHA, attn_drop=attn_drop, seed=drop_seed)
    num, den = gat_pass_chunked_reference(
        "fwd", *keys[:3], sd_t, ss_t, smax, h2_t, schedule=scheds[0], **kw)
    den = den.clamp_min(1e-16)
    o = (num.view(n, H, D) / den[:, :, None]).view(n, -1)
    dagg = (g.view(n, H, D) / den[:, :, None]).reshape(n, -1)
    dden = -(g.view(n, H, D) * o.view(n, H, D)).sum(2) / den
    (dsd,) = gat_pass_chunked_reference("dsd", *keys[:3], sd_t, ss_t, smax,
                                        h2_t, dagg, dden, schedule=scheds[0],
                                        **kw)
    dh2, dss = gat_pass_chunked_reference("dsrc", *keys[3:], sd_t, ss_t,
                                          smax, h2_t, dagg, dden,
                                          schedule=scheds[1], **kw)
    for route, got in (("fused", fused), ("chunked", [o, dsd, dss, dh2])):
        np.testing.assert_allclose(_np(got[0])[:m], ref[0][:m],
                                   rtol=FWD_RTOL, atol=FWD_ATOL,
                                   err_msg=route)
        for name, t, r in zip(("dsd", "dss", "dh"), got[1:], ref[1:]):
            np.testing.assert_allclose(_np(t)[:m], r[:m], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       err_msg=f"{route} {name}")


def test_keep_masks_agree_across_directions(graphs):
    """The CSR and CSC passes key the hash on the edge's position in the
    edge list, so both directions see the same mask per edge."""
    *_, pt = graphs
    ex = pt.extras
    H, n = 4, pt.n_pad
    rng = np.random.default_rng(2)
    sd, ss, dden = (torch.from_numpy(rng.normal(size=(n, H)).astype(np.float32))
                    for _ in range(3))
    h2, dagg = (torch.from_numpy(rng.normal(size=(n, H * 3)).astype(np.float32))
                for _ in range(2))
    kw = dict(alpha=ALPHA, attn_drop=0.5, seed=torch.tensor([42]),
              with_keep=True)
    smax = ss.amax(0)
    *_, keep_fw = gat_pass("fwd", ex["spmm_fw_ptr"], ex["spmm_fw_col"],
                           ex["spmm_fw_orig"], sd, ss, smax, h2, **kw)
    *_, keep_bw = gat_pass("dsrc", ex["spmm_bw_ptr"], ex["spmm_bw_col"],
                           ex["spmm_bw_orig"], sd, ss, smax, h2, dagg, dden,
                           **kw)
    by_edge = torch.empty_like(keep_fw)
    by_edge[ex["spmm_bw_orig"].long()] = keep_bw
    assert torch.equal(by_edge, keep_fw)
    assert torch.equal(keep_fw, dropout_keep_reference(ex["spmm_fw_orig"],
                                                       torch.tensor([42]), H, 0.5))
    # the plain version with the keep scales is the pass without them
    (dsd,) = gat_pass("dsd", ex["spmm_fw_ptr"], ex["spmm_fw_col"],
                      ex["spmm_fw_orig"], sd, ss, smax, h2, dagg, dden,
                      alpha=ALPHA, attn_drop=0.5, seed=torch.tensor([42]))
    (dsd_ref, _) = gat_pass_reference(
        "dsd", ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_orig"], sd,
        ss, smax, h2, dagg, dden, alpha=ALPHA, attn_drop=0.5,
        seed=torch.tensor([42]), with_keep=True)
    assert torch.equal(dsd, dsd_ref)


def test_gat_fused_dispatch_on_cpu(graphs):
    _, _, gt, pt = graphs
    h = torch.zeros(gt.n_pad, 2, 3)
    s = torch.zeros(gt.n_pad, 2)
    assert maybe_cuda_gat_fused(gt, s, s, h) is None
    assert maybe_cuda_gat_fused(pt, s, s, h).shape == (gt.n_pad, 2, 3)
    H = GAT_MAX_HEADS + 1
    with pytest.raises(ValueError, match=f"at most {GAT_MAX_HEADS} heads"):
        maybe_cuda_gat_fused(pt, torch.zeros(gt.n_pad, H),
                             torch.zeros(gt.n_pad, H), torch.zeros(gt.n_pad, H, 1))
    with pytest.raises(ValueError, match="mode"):
        gat_pass("bwd", *(pt.extras[k] for k in ("spmm_fw_ptr", "spmm_fw_col",
                                                  "spmm_fw_orig")),
                 s, s, s[0], h.view(gt.n_pad, 6), alpha=ALPHA)


# -- layer and model -------------------------------------------------------------

LAYER_CONFIGS = {
    "concat_elu": dict(out_features=8, nhead=4, activation="elu"),
    "mean_heads": dict(out_features=5, nhead=2, concat=False),
    "residual_layernorm": dict(out_features=4, nhead=4, residual=True,
                               norm="layernorm"),
}


def _route(graphs, route):
    gj, _, gt, pt = graphs
    return gj, (pt if route == "fused" else gt)


@pytest.mark.parametrize("route", ["fused", "unfused"])
@pytest.mark.parametrize("cfg", sorted(LAYER_CONFIGS))
def test_gat_layer_matches(graphs, cfg, route):
    """Eval outputs and parameter grads of one GAT layer."""
    gj, gt = _route(graphs, route)
    kw = LAYER_CONFIGS[cfg]
    jl = JGATLayer(attn_drop=0.0, **kw)
    variables = jl.init(jax.random.PRNGKey(1), gj, gj.x)
    tl = GATLayer(gt.num_features, attn_drop=0.0, **kw)
    load_jax_params(tl, _host(variables["params"]))
    probe = np.random.default_rng(4).normal(
        size=(gj.n_pad, tl(gt, gt.x).shape[1])).astype(np.float32)
    mask = np.asarray(gj.node_mask())[:, None]

    def loss_j(params):
        out = jl.apply({"params": params}, gj, gj.x)
        return jnp.sum(jnp.where(mask, out * probe, 0.0)), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    out_t = tl(gt, gt.x)
    n = gt.num_nodes
    (out_t[:n] * torch.from_numpy(probe[:n])).sum().backward()
    np.testing.assert_allclose(_np(out_t)[:n], np.asarray(out_j)[:n],
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)
    ref = GATLayer(gt.num_features, attn_drop=0.0, **kw)
    load_jax_params(ref, _host(grads_j))
    ref_params = dict(ref.named_parameters())
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(ref_params[name]),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL,
                                   err_msg=name)


def _models(gj, seed=0, **cfg):
    kw = dict(in_features=gj.num_features, out_features=4, hidden_size=6,
              nhead=3, dropout=0.0, attn_drop=0.0)
    kw.update(cfg)
    jm = JGAT(**kw)
    variables = jm.init({"params": jax.random.PRNGKey(seed),
                         "dropout": jax.random.PRNGKey(seed)},
                        gj, gj.x, training=False)
    tm = build_model("gat", **kw)
    load_jax_params(tm, _host(variables["params"]))
    return jm, variables, tm, kw


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_gat_logits_match(graphs, route):
    gj, gt = _route(graphs, route)
    for cfg in ({}, {"num_layers": 3, "nhead_last": 2}):
        jm, variables, tm, _ = _models(gj, **cfg)
        out_j = jm.apply(variables, gj, gj.x, training=False)
        with torch.no_grad():
            out_t = tm(gt, training=False)
        n = gt.num_nodes
        np.testing.assert_allclose(_np(out_t)[:n], np.asarray(out_j)[:n],
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_gat_param_grads_match(graphs, route):
    gj, gt = _route(graphs, route)
    jm, variables, tm, kw = _models(gj, seed=3)
    mask_j = gj.train_mask & gj.node_mask()

    def loss_j(params):
        logits = jm.apply({"params": params}, gj, gj.x, training=False)
        return j_mce(logits, gj.y, mask_j)

    grads_j = _host(jax.grad(loss_j)(variables["params"]))
    n = gt.n_pad
    loss_t = masked_cross_entropy(tm(gt, training=False), gt.y,
                                  gt.train_mask & gt.node_mask())
    loss_t.backward()
    ref = build_model("gat", **kw)
    load_jax_params(ref, grads_j)
    ref_params = dict(ref.named_parameters())
    assert n == gt.x.shape[0]
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(ref_params[name]),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL,
                                   err_msg=name)


def test_load_jax_params_fills_gat_parameters(graphs):
    gj, *_ = graphs
    _, variables, tm, _ = _models(gj)
    params = _host(variables["params"])
    for i in range(2):
        layer = getattr(tm, f"layer{i}")
        np.testing.assert_array_equal(_np(layer.W.weight),
                                      params[f"layer{i}"]["W"]["kernel"].T)
        for a in ("a_src", "a_dst"):
            assert tuple(getattr(layer, a).shape) == params[f"layer{i}"][a].shape
            np.testing.assert_array_equal(_np(getattr(layer, a)),
                                          params[f"layer{i}"][a])
    assert {n for n, _ in tm.named_parameters()} == {
        f"layer{i}.{p}" for i in range(2) for p in ("W.weight", "a_src", "a_dst")}
    del params["layer1"]["a_src"]
    with pytest.raises(KeyError):
        load_jax_params(tm, params)


def test_gat_init_follows_flax_initialisers():
    m = build_model("gat", in_features=400, out_features=7, hidden_size=64,
                    nhead=8)
    m.reset_parameters(torch.Generator().manual_seed(0))
    w = m.layer0.W.weight.detach()
    assert abs(float(w.std()) - (1 / 400) ** 0.5) < 0.002
    limit = (6.0 / (8 + 64)) ** 0.5            # glorot over (H, D)
    a = m.layer0.a_src.detach()
    assert float(a.abs().max()) <= limit
    assert abs(float(a.std()) - limit / 3 ** 0.5) < 0.02
    m2 = build_model("gat", in_features=400, out_features=7, hidden_size=64,
                     nhead=8)
    m2.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(m.parameters(),
                                                 m2.parameters()))


def test_unported_gat_inputs_raise(graphs):
    """A halo-partitioned graph (the multi-device slice) is the GAT input
    still unported, alone or in a list of blocks; lists of blocks and
    regular-fanout blocks run (tests/test_torch_device_sampling.py)."""
    _, _, gt, _ = graphs
    m = build_model("gat", in_features=gt.num_features, out_features=4)
    halo = gt.replace(extras={"halo_send_ring": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        m(halo)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        m([halo, halo])
    with torch.no_grad():
        assert torch.equal(m([gt, gt]), m(gt))


def test_fanout_route_is_taken_before_the_fused_route(graphs, monkeypatch):
    """A regular-fanout block never reaches maybe_cuda_gat_fused (which
    raises for a CUDA tensor without the kernel structure)."""
    gj, _, gt, _ = graphs
    import cogdl_tpu_torch.layers.gat_layer as gl

    def refuse(*a, **kw):
        raise AssertionError("fused route taken for a fanout block")

    monkeypatch.setattr(gl, "maybe_cuda_gat_fused", refuse)
    from cogdl_tpu_torch.data.device_sampling import (
        frame_features, sample_blocks_device)

    blocks, _ = sample_blocks_device(gt, torch.arange(8, dtype=torch.int32),
                                     torch.Generator().manual_seed(0), (3, 2))
    m = build_model("gat", in_features=gt.num_features, out_features=4)
    out = m(list(blocks), frame_features(blocks))
    assert out.shape == (blocks[0].n_pad, 4) and bool(out.isfinite().all())


def test_fused_route_with_attention_dropout_trains_deterministically(graphs):
    """Training mode on a prepared graph: the dropout seed comes from the
    generator, so the same generator state gives the same output, another
    state another mask."""
    *_, pt = graphs
    m = build_model("gat", in_features=pt.num_features, out_features=4,
                    dropout=0.0, attn_drop=0.5)
    m.reset_parameters(torch.Generator().manual_seed(0))
    outs = [m(pt, training=True, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_experiment_trains_gat_on_cpu():
    """A smoke run through experiment(): the loss is finite and falls from
    the first epochs to the sixth on one seed (the quality run over 100
    epochs is chip_smoke.py's, rehearsed in test_torch_chip_smoke.py)."""
    losses = []
    for epochs in (2, 6):
        (runs,) = experiment(dataset="sbm", model="gat", epochs=epochs,
                             seed=0, device="cpu").values()
        losses.append(runs[0]["train_loss"])
    assert np.isfinite(losses).all() and losses[1] < losses[0]
