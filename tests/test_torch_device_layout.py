"""The products-scale slice of cogdl_tpu_torch against the JAX package on
the CPU: K2's plain version against the Pallas accumulating kernel itself,
the panel ``spmm`` against ``spmm_pallas_p`` over source panels, the panel
GAT route (K3's plain version, accumulating, coordinate-keyed dropout)
against ``gat_fused_p`` over its blocked layouts, and the port's own
``prepare_spmm_device`` / ``default_panel_rows`` / ``powerlaw_graph_device``.
The JAX side runs its kernels in Pallas interpret mode with tiny mega-blocks
(``block_chunks=2``), as its own tests do."""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu_torch.data.graph as tg
import cogdl_tpu_torch.ops as tops
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.ops.pallas.device_layout import (
    build_spmm_layout_jax,
    count_layout_chunks,
)
from cogdl_tpu.ops.pallas.device_layout import (
    prepare_spmm_device as j_prepare_spmm_device,
)
from cogdl_tpu.ops.pallas.segment_kernels import (
    build_ar,
    build_spmm_layout,
    gat_fused_p,
    sorted_segment_matmul_accum,
    spmm_pallas_p,
)
from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph_device
from cogdl_tpu_torch.ops.cuda import (
    build_spmm_structure,
    default_panel_rows,
    maybe_cuda_gat_fused,
    maybe_cuda_spmm,
    prepare_spmm,
    prepare_spmm_device,
)
from cogdl_tpu_torch.ops.cuda.segment_kernels import (
    GATFusedFunction,
    SpMMPanelFunction,
    gat_output_widths,
    gat_pass,
    panel_edges,
    spmm_csr_accum,
    spmm_csr_accum_reference,
    spmm_csr_reference,
)

# the JAX package's own tolerances for its blocked routes
# (tests/test_pallas_kernels.py): fp32, one-hot MXU matmuls against
# index_add in another order
RTOL, ATOL = 1e-4, 1e-5
GRAD_TOL = 2e-3
PANEL_ROWS, BLOCK = 128, 2


def _np(t):
    return t.detach().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _round_up(x, m):
    return -(-x // m) * m


def _port_graph(gj):
    """The JAX package's graph as a graph of the port: the same arrays,
    passed over as numpy."""
    return tg.Graph(
        row_ptr=_t(gj.row_ptr), row=_t(gj.row), col=_t(gj.col),
        edge_weight=_t(gj.edge_weight), num_nodes=gj.num_nodes,
        num_edges=gj.num_edges, meta=gj.meta)


@pytest.fixture(scope="module")
def prepped():
    """The ``prepped`` graph of the JAX package's kernel tests (sbm, self
    loops, sym norm, n_pad a multiple of 128) in both packages, and
    features from a numpy seed."""
    gj = jg.sym_norm(jg.add_self_loops(j_sbm(num_nodes=300, seed=3)))
    gj = jg.pad_to(gj, _round_up(gj.n_pad, 128), gj.e_pad)
    gt = _port_graph(gj)
    x = np.random.default_rng(0).normal(size=(gj.n_pad, 32)).astype(np.float32)
    return gj, gt, x


def _edges(gj):
    E = gj.num_edges
    return (np.asarray(gj.row)[:E], np.asarray(gj.col)[:E],
            np.asarray(gj.edge_weight)[:E])


# -- (1) K2's plain version against the Pallas kernel itself ----------------

@pytest.mark.parametrize("width", [128, 47])
def test_accum_reference_matches_pallas_accum_kernel(prepped, width):
    gj, _, _ = prepped
    row, col, w = _edges(gj)
    rng = np.random.default_rng(5)
    x = np.zeros((gj.n_pad, 128), np.float32)       # the kernel's lane width
    x[:, :width] = rng.normal(size=(gj.n_pad, width))
    acc0 = rng.normal(size=(gj.n_pad, 128)).astype(np.float32)
    lay = build_spmm_layout(row, col, w, gj.n_pad)
    out_j = sorted_segment_matmul_accum(
        jnp.asarray(acc0), jnp.take(jnp.asarray(x), lay["col_k"], axis=0),
        jnp.asarray(lay["row_k"]), jnp.asarray(lay["w_k"]),
        jnp.asarray(lay["chunk_tile"]))
    st = build_spmm_structure(_t(row), _t(col), _t(w), gj.n_pad)
    out_t = spmm_csr_accum(_t(acc0[:, :width]).clone(), st["ptr"], st["col"],
                           st["w"], _t(x[:, :width]))
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j)[:, :width],
                               rtol=RTOL, atol=ATOL)


# -- (2) the panel spmm against spmm_pallas_p over source panels -------------

def _j_panel_spmm(x, fw, bw, probe):
    def f(v):
        return spmm_pallas_p(
            PANEL_ROWS, False, 128, v,
            fw["col_k"], fw["w_k"], fw["row_k"], fw["chunk_tile"],
            fw["block_panel"], bw["col_k"], bw["w_k"], bw["row_k"],
            bw["chunk_tile"], bw["block_panel"])

    out = f(jnp.asarray(x))
    dx = jax.grad(lambda v: jnp.sum(f(v) * probe))(jnp.asarray(x))
    return np.asarray(out), np.asarray(dx)


def _j_layout(row, col, w, n_pad):
    nc = count_layout_chunks(jnp.asarray(row), jnp.asarray(col), n_pad,
                             PANEL_ROWS, block_chunks=BLOCK)
    return build_spmm_layout_jax(
        jnp.asarray(row), jnp.asarray(col), jnp.asarray(w), n_pad=n_pad,
        panel_rows=PANEL_ROWS, exact_chunks=nc, block_chunks=BLOCK)


def test_panel_spmm_matches_pallas_panels_on_sbm(prepped):
    """Forward and dX through ``ops.spmm`` on the port's panel structure
    against ``spmm_pallas_p`` with ``panel_rows=128``."""
    gj, gt, x = prepped
    probe = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    gd = j_prepare_spmm_device(gj, symmetric=True, panel_rows=PANEL_ROWS,
                               block_chunks=BLOCK)
    lay = {k: gd.extras[f"spmm_fw_{s}"] for k, s in (
        ("col_k", "col"), ("w_k", "w"), ("row_k", "row"),
        ("chunk_tile", "ct"), ("block_panel", "bp"))}
    out_j, dx_j = _j_panel_spmm(x, lay, lay, probe)

    gp = prepare_spmm_device(gt, symmetric=True, panel_rows=PANEL_ROWS)
    assert gp.extras["spmm_fw_ptr"].shape == (3, gt.n_pad + 1)
    xt = _t(x).requires_grad_(True)
    out_t = tops.spmm(gp, xt)
    (out_t * _t(probe)).sum().backward()
    np.testing.assert_allclose(_np(out_t), out_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(xt.grad), dx_j, rtol=RTOL, atol=ATOL)


def test_panel_spmm_matches_pallas_panels_with_empty_groups():
    """The empty-group graph of the JAX package's tests: edges land in two
    destination tiles only, sources over all four panels; directed, so the
    backward runs over the transposed structure."""
    n_pad = 1024
    rng = np.random.default_rng(11)
    dst = np.concatenate([rng.integers(0, 128, 600),
                          rng.integers(768, 896, 600)]).astype(np.int32)
    src = rng.integers(0, n_pad, 1200).astype(np.int32)
    w = rng.uniform(0.5, 1.5, 1200).astype(np.float32)
    x = rng.normal(size=(n_pad, 128)).astype(np.float32)
    probe = rng.normal(size=(n_pad, 128)).astype(np.float32)
    out_j, dx_j = _j_panel_spmm(x, _j_layout(dst, src, w, n_pad),
                                _j_layout(src, dst, w, n_pad), probe)

    fw = build_spmm_structure(_t(dst), _t(src), _t(w), n_pad, PANEL_ROWS)
    bw = build_spmm_structure(_t(src), _t(dst), _t(w), n_pad, PANEL_ROWS)
    assert fw["ptr"].shape == (8, n_pad + 1)
    xt = _t(x).requires_grad_(True)
    out_t = SpMMPanelFunction.apply(xt, fw["ptr"], fw["col"], fw["w"],
                                    bw["ptr"], bw["col"], bw["w"])
    (out_t * _t(probe)).sum().backward()
    np.testing.assert_allclose(_np(out_t), out_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(xt.grad), dx_j, rtol=RTOL, atol=ATOL)


def test_panel_function_weight_grad_is_the_sddmm(prepped):
    _, gt, x = prepped
    ex = prepare_spmm_device(gt, panel_rows=PANEL_ROWS).extras
    keys = [ex[f"spmm_{d}_{k}"] for d in ("fw", "bw")
            for k in ("ptr", "col", "w")]
    probe = _t(np.random.default_rng(2).normal(size=x.shape).astype(np.float32))
    w = keys[2].clone().requires_grad_(True)
    out = SpMMPanelFunction.apply(_t(x), keys[0], keys[1], w, *keys[3:])
    (out * probe).sum().backward()
    row = torch.cat([panel_edges(p)[1] for p in keys[0]])
    ref = (probe[row] * _t(x)[keys[1].long()]).sum(-1)
    np.testing.assert_allclose(_np(w.grad), _np(ref), rtol=1e-5, atol=1e-5)


# -- (3) K2's contract ------------------------------------------------------

def test_two_halves_of_an_edge_set_equal_one_k1_call(prepped):
    gj, _, x = prepped
    row, col, w = _edges(gj)
    half = np.random.default_rng(7).uniform(size=row.size) < 0.5
    parts = [build_spmm_structure(_t(row[m]), _t(col[m]), _t(w[m]), gj.n_pad)
             for m in (half, ~half)]
    n_first = parts[0]["col"].numel()
    flat_col = torch.cat([p["col"] for p in parts])
    flat_w = torch.cat([p["w"] for p in parts])
    acc = torch.zeros(gj.n_pad, x.shape[1])
    spmm_csr_accum(acc, parts[0]["ptr"], flat_col, flat_w, _t(x))
    spmm_csr_accum(acc, parts[1]["ptr"] + n_first, flat_col, flat_w, _t(x))
    one = build_spmm_structure(_t(row), _t(col), _t(w), gj.n_pad)
    ref = spmm_csr_reference(one["ptr"], one["col"], one["w"], _t(x))
    np.testing.assert_allclose(_np(acc), _np(ref), rtol=1e-5, atol=1e-6)


def test_rows_outside_a_panel_keep_their_values(prepped):
    _, gt, x = prepped
    ex = prepare_spmm_device(gt, panel_rows=PANEL_ROWS).extras
    acc0 = _t(np.random.default_rng(8).normal(size=x.shape).astype(np.float32))
    for ptr in ex["spmm_fw_ptr"]:
        acc = spmm_csr_accum(acc0.clone(), ptr, ex["spmm_fw_col"],
                             ex["spmm_fw_w"], _t(x))
        untouched = ptr[1:] == ptr[:-1]
        assert untouched.any() and not untouched.all()
        assert torch.equal(acc[untouched], acc0[untouched])
        assert not torch.equal(acc[~untouched], acc0[~untouched])


def test_accum_returns_and_updates_the_buffer_it_was_given(prepped):
    _, gt, x = prepped
    ex = prepare_spmm_device(gt, panel_rows=PANEL_ROWS).extras
    acc = torch.zeros(gt.n_pad, x.shape[1])
    out = spmm_csr_accum_reference(acc, ex["spmm_fw_ptr"][0],
                                   ex["spmm_fw_col"], ex["spmm_fw_w"], _t(x))
    assert out is acc and acc.abs().sum() > 0


# -- (4) prepare_spmm_device ------------------------------------------------

def test_symmetric_aliases_and_directed_builds_the_transpose(prepped):
    _, gt, x = prepped
    sym = prepare_spmm_device(gt, symmetric=True, panel_rows=PANEL_ROWS)
    for k in ("ptr", "col", "w"):
        assert sym.extras[f"spmm_bw_{k}"] is sym.extras[f"spmm_fw_{k}"]
    assert sym.meta_get("spmm_panel_rows") == PANEL_ROWS

    g = powerlaw_graph_device(300, avg_degree=6, feat_dim=4, undirected=False,
                              device="cpu")
    both = prepare_spmm_device(g, symmetric=False, panel_rows=PANEL_ROWS)
    assert both.extras["spmm_bw_col"] is not both.extras["spmm_fw_col"]
    v = torch.randn(g.n_pad, 5, generator=torch.Generator().manual_seed(0))
    a = torch.zeros(g.n_pad, g.n_pad).index_put_(
        (g.row.long(), g.col.long()), g.edge_weight, accumulate=True)
    bw = torch.zeros_like(v)
    for ptr in both.extras["spmm_bw_ptr"]:
        spmm_csr_accum(bw, ptr, both.extras["spmm_bw_col"],
                       both.extras["spmm_bw_w"], v)
    np.testing.assert_allclose(_np(bw), _np(a.T @ v), rtol=1e-5, atol=1e-5)


def test_transposed_build_of_a_symmetric_edge_set_is_identical(prepped):
    gj, _, _ = prepped
    row, col, w = _edges(gj)
    fw = build_spmm_structure(_t(row), _t(col), _t(w), gj.n_pad, PANEL_ROWS)
    bw = build_spmm_structure(_t(col), _t(row), _t(w), gj.n_pad, PANEL_ROWS)
    for k in ("ptr", "col", "w"):
        assert torch.equal(fw[k], bw[k])


def test_unsorted_edges_give_the_same_structure(prepped):
    gj, _, _ = prepped
    row, col, w = _edges(gj)
    perm = np.random.default_rng(9).permutation(row.size)
    a = build_spmm_structure(_t(row), _t(col), _t(w), gj.n_pad, PANEL_ROWS,
                             with_orig=True)
    b = build_spmm_structure(_t(row[perm]), _t(col[perm]), _t(w[perm]),
                             gj.n_pad, PANEL_ROWS, with_orig=True)
    for k in ("ptr", "col", "w"):
        assert torch.equal(a[k], b[k])
    assert a["ptr"].dtype == a["col"].dtype == a["orig"].dtype == torch.int32
    # orig maps every entry back to its edge in the list it was built from
    np.testing.assert_array_equal(col[perm][_np(b["orig"])], _np(b["col"]))


@pytest.mark.parametrize("device_first", [True, False])
def test_reprepare_leaves_no_stale_structure(prepped, device_first):
    _, gt, x = prepped
    ref = tops.spmm_coo(_t(x), gt.row, gt.col, gt.edge_weight, gt.n_pad)
    if device_first:
        g = prepare_spmm(prepare_spmm_device(gt, panel_rows=PANEL_ROWS))
        assert g.meta_get("spmm_panel_rows") == 0
        assert g.extras["spmm_fw_ptr"].ndim == 1
    else:
        g = prepare_spmm_device(prepare_spmm(gt), with_orig=True,
                                panel_rows=PANEL_ROWS, store_w=True)
        assert g.meta_get("spmm_panel_rows") == PANEL_ROWS
        assert not any(k.endswith("_orig") for k in g.extras)
        assert g.extras["spmm_fw_ptr"].ndim == 2
    np.testing.assert_allclose(_np(maybe_cuda_spmm(g, _t(x))), _np(ref),
                               rtol=1e-5, atol=1e-6)


def test_gat_structure_stores_no_orig_with_panels_and_orig_without(prepped):
    _, gt, _ = prepped
    panels = prepare_spmm_device(gt, symmetric=True, with_orig=True,
                                 panel_rows=PANEL_ROWS)
    # the structure and its schedule, no weights and no orig
    assert sorted(panels.extras) == sorted(
        f"spmm_{d}_{k}" for d in ("fw", "bw")
        for k in ("ptr", "col") + SCHEDULE_KEYS)
    single = prepare_spmm_device(gt, symmetric=True, with_orig=True,
                                 panel_rows=0)
    ex = single.extras
    assert ex["spmm_bw_col"] is ex["spmm_fw_col"]
    assert ex["spmm_bw_orig"] is not ex["spmm_fw_orig"]
    # entry s of the shared arrays is edge fw_orig[s] read forwards and edge
    # bw_orig[s] read transposed
    row = torch.repeat_interleave(
        torch.arange(gt.n_pad), (ex["spmm_fw_ptr"][1:]
                                 - ex["spmm_fw_ptr"][:-1]).long())
    assert torch.equal(gt.row[ex["spmm_fw_orig"].long()].long(), row)
    assert torch.equal(gt.col[ex["spmm_bw_orig"].long()].long(), row)
    assert torch.equal(gt.row[ex["spmm_bw_orig"].long()], ex["spmm_fw_col"])


def test_plain_spmm_without_weights_raises_on_the_card(prepped):
    """``store_w=False`` (the GAT default): a CPU tensor falls to the plain
    tier, a CUDA tensor raises, since the port has no fallback on the card.
    The stand-in has what the dispatcher reads of a CUDA tensor."""
    _, gt, x = prepped
    g = prepare_spmm_device(gt, with_orig=True, panel_rows=PANEL_ROWS)
    assert "spmm_fw_w" not in g.extras
    assert maybe_cuda_spmm(g, _t(x)) is None
    on_card = types.SimpleNamespace(is_cuda=True, ndim=2)
    with pytest.raises(RuntimeError, match="store_w=True"):
        maybe_cuda_spmm(g, on_card)


def test_dispatch_refuses_a_structure_that_contradicts_its_meta(prepped):
    _, gt, x = prepped
    g = prepare_spmm_device(gt, panel_rows=PANEL_ROWS).with_meta(
        spmm_panel_rows=0)
    with pytest.raises(ValueError, match="spmm_panel_rows"):
        maybe_cuda_spmm(g, _t(x))


def test_too_many_panels_are_refused():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="taller panels"):
        build_spmm_structure(z, z, None, n_pad=2 ** 20, panel_rows=256)


# -- (5) default_panel_rows -------------------------------------------------

@pytest.mark.parametrize("n_pad,feat_bytes,budget_mb", [
    (2_450_048, 512, 40), (2_450_048, 512, 160), (2_450_048, 188, 40),
    (100_096, 512, 40), (1_000_000, 512, 512), (131, 4, 1)])
def test_default_panel_rows_covers_the_table(n_pad, feat_bytes, budget_mb):
    pr = default_panel_rows(n_pad, feat_bytes, budget_mb)
    if n_pad * feat_bytes <= budget_mb * 1_000_000:
        assert pr == 0
        return
    n_panels = -(-n_pad // pr)
    assert n_panels >= 2 and n_panels * pr >= n_pad
    assert pr * feat_bytes <= budget_mb * 1_000_000
    # the fewest panels that fit: one fewer would not
    assert -(-n_pad // (n_panels - 1)) * feat_bytes > budget_mb * 1_000_000


# -- (6) powerlaw_graph_device ----------------------------------------------

def test_powerlaw_device_graph_structure():
    g = powerlaw_graph_device(1000, avg_degree=8, feat_dim=16, num_classes=5,
                              device="cpu")
    assert g.meta_get("symmetric") and g.meta_get("norm") == "sym"
    assert g.meta_get("self_loops") and g.meta_get("num_classes") == 5
    assert g.n_pad == 1024 and g.num_edges == g.e_pad == 1000 * 8 + 1000
    assert g.row.dtype == g.col.dtype == g.row_ptr.dtype == torch.int32
    row, col = _np(g.row).astype(np.int64), _np(g.col).astype(np.int64)
    assert np.all(np.diff(row) >= 0)
    rp = _np(g.row_ptr)
    assert rp[0] == 0 and rp[-1] == g.num_edges
    np.testing.assert_array_equal(np.diff(rp),
                                  np.bincount(row, minlength=g.n_pad))
    deg = np.diff(rp)
    assert deg[: g.num_nodes].min() >= 1 and deg[g.num_nodes:].max() == 0
    assert max(row.max(), col.max()) < g.num_nodes
    # the edge multiset equals its transpose
    np.testing.assert_array_equal(np.sort(row * g.n_pad + col),
                                  np.sort(col * g.n_pad + row))
    # weights are the symmetric normalisation of the degrees
    np.testing.assert_allclose(
        _np(g.edge_weight), 1.0 / np.sqrt(deg[row] * deg[col]), rtol=1e-6)
    assert g.x.shape == (g.n_pad, 16)
    assert not g.train_mask[g.num_nodes:].any()
    assert not (g.train_mask & g.val_mask).any()
    out = tops.spmm_coo(g.x, g.row, g.col, g.edge_weight, g.n_pad)
    assert torch.isfinite(out).all()


def test_powerlaw_device_graph_follows_its_seed_and_options():
    kw = dict(avg_degree=6, feat_dim=4, device="cpu")
    a, b = (powerlaw_graph_device(500, seed=3, **kw) for _ in range(2))
    c = powerlaw_graph_device(500, seed=4, **kw)
    for name in ("row", "col", "edge_weight", "x", "y", "train_mask"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert not torch.equal(a.col, c.col)
    d = powerlaw_graph_device(500, undirected=False, pad_multiple=512, **kw)
    assert not d.meta_get("symmetric") and d.n_pad == 512
    assert d.num_edges == 500 * 6 + 500
    # Zipf-drawn destinations: the first ranks are the hubs
    deg = _np(d.row_ptr[1:] - d.row_ptr[:-1])
    assert deg[:10].mean() > 5 * deg[250:500].mean()


# -- (7) the panel GAT route against gat_fused_p ------------------------------

H, D = 4, 8


@pytest.fixture(scope="module")
def gat_setup():
    """TestGatFusedBlocked's set-up in both packages."""
    gj = jg.add_self_loops(j_sbm(num_nodes=250, seed=11))
    gj = jg.pad_to(gj, _round_up(gj.n_pad, 128), gj.e_pad)
    gjp = j_prepare_spmm_device(gj, symmetric=True, with_orig=True,
                                with_dropout=True, panel_rows=PANEL_ROWS,
                                block_chunks=BLOCK)
    gtp = prepare_spmm_device(_port_graph(gj), symmetric=True,
                              with_orig=True, panel_rows=PANEL_ROWS)
    rng = np.random.default_rng(13)
    h = rng.normal(size=(gj.n_pad, H, D)).astype(np.float32)
    a_src = rng.normal(size=(H, D)).astype(np.float32)
    a_dst = rng.normal(size=(H, D)).astype(np.float32)
    probe = np.random.default_rng(3).normal(
        size=(gj.n_pad, H, D)).astype(np.float32)
    return gjp, gtp, a_dst, a_src, h, probe


def _j_fused(g, a_dst, a_src, h, attn_drop, seed):
    ex = g.extras
    zb, zf = jnp.zeros(0, jnp.int32), jnp.zeros(0, jnp.float32)
    sd = jnp.einsum("nhd,hd->nh", h, a_dst)
    ss = jnp.einsum("nhd,hd->nh", h, a_src)
    pr = int(g.meta_get("spmm_panel_rows"))
    out = gat_fused_p(
        H, D, 0.2, attn_drop, pr, int(g.meta_get("spmm_panel_rows_bw", pr)),
        int(g.meta_get("spmm_r_tile")), False,
        sd, ss, h.reshape(-1, H * D), build_ar(a_src, H, D),
        build_ar(a_dst, H, D), jnp.uint32(seed),
        ex["spmm_fw_pack"], zb, zf, ex["spmm_fw_ct"], zb, ex["spmm_fw_bp"],
        ex["spmm_bw_pack"], zb, zf, ex["spmm_bw_ct"], zb, ex["spmm_bw_bp"])
    return out.reshape(-1, H, D)


@pytest.mark.parametrize("attn_drop", [0.0, 0.5])
def test_panel_gat_matches_gat_fused_p(gat_setup, attn_drop):
    """Forward and the grads of a_dst, a_src and h; with attention dropout
    both sides hash the mask from the same (dst, src) coordinates and seed."""
    gjp, gtp, a_dst, a_src, h, probe = gat_setup
    seed = 99
    mask = np.asarray(gjp.node_mask())[:, None, None]

    def loss_j(a_dst, a_src, h):
        out = _j_fused(gjp, a_dst, a_src, h, attn_drop, seed)
        return jnp.sum(jnp.where(mask, out * probe, 0.0)), out

    (_, out_j), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(h))

    ins = [_t(a).requires_grad_(True) for a in (a_dst, a_src, h)]
    ex = gtp.extras
    sd = (ins[2] * ins[0]).sum(-1)
    ss = (ins[2] * ins[1]).sum(-1)
    out_t = GATFusedFunction.apply(
        sd, ss, ins[2].reshape(-1, H * D), ex["spmm_fw_ptr"],
        ex["spmm_fw_col"], None, ex["spmm_bw_ptr"], ex["spmm_bw_col"], None,
        torch.tensor([seed]), 0.2, attn_drop).view(-1, H, D)
    (torch.where(_t(mask), out_t * _t(probe), 0.0)).sum().backward()
    n = gjp.num_nodes
    np.testing.assert_allclose(_np(out_t)[:n], np.asarray(out_j)[:n],
                               rtol=RTOL, atol=ATOL)
    for t, j, name in zip(ins, grads_j, ("da_dst", "da_src", "dh")):
        np.testing.assert_allclose(_np(t.grad), np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_panel_gat_dispatch_takes_the_panel_route(gat_setup):
    """``maybe_cuda_gat_fused`` on a panel structure equals the Function
    called by hand, and a single-shot structure of the same graph gives the
    same result without dropout."""
    _, gtp, a_dst, a_src, h, _ = gat_setup
    ht = _t(h)
    sd, ss = (ht * _t(a_dst)).sum(-1), (ht * _t(a_src)).sum(-1)
    out = maybe_cuda_gat_fused(gtp, sd, ss, ht)
    single = prepare_spmm_device(gtp, symmetric=True, with_orig=True,
                                 panel_rows=0)
    # the raw edges are still on gtp, so it can be prepared again
    ref = maybe_cuda_gat_fused(single, sd, ss, ht)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-6)


def _np_coord_keep(dst, src, seed, heads, p):
    """Numpy transcription of the JAX kernel's coordinate-keyed hash
    (cogdl_tpu/ops/pallas/segment_kernels.py:815-828), uint32 throughout."""
    du, su = dst.astype(np.uint32), src.astype(np.uint32)
    ek = ((du * np.uint32(0x9E3779B1)) ^ (su * np.uint32(0x85EBCA77))
          ^ np.uint32(seed))
    hx = ek[:, None] * np.uint32(heads) + np.arange(heads, dtype=np.uint32)
    hx = hx * np.uint32(747796405) + np.uint32(2891336453)
    hx = hx ^ (hx >> np.uint32(16))
    hx = hx * np.uint32(0x85EBCA6B)
    hx = hx ^ (hx >> np.uint32(13))
    hx = hx * np.uint32(0xC2B2AE35)
    hx = hx ^ (hx >> np.uint32(16))
    thresh = int((1.0 - p) * float(2 ** 32 - 1))
    return np.where(hx < np.uint32(thresh), np.float32(1.0 / (1.0 - p)),
                    np.float32(0.0)).astype(np.float32)


@pytest.mark.parametrize("mode", ["fwd", "dsd", "dsrc"])
def test_coordinate_keyed_keep_mask_bit_for_bit(gat_setup, mode):
    _, gtp, a_dst, a_src, h, _ = gat_setup
    ex = gtp.extras
    d = "bw" if mode == "dsrc" else "fw"
    ptrs, idx = ex[f"spmm_{d}_ptr"], ex[f"spmm_{d}_col"]
    n = gtp.n_pad
    ht = _t(h)
    sd, ss = (ht * _t(a_dst)).sum(-1), (ht * _t(a_src)).sum(-1)
    rng = np.random.default_rng(21)
    back = () if mode == "fwd" else (
        _t(rng.normal(size=(n, H * D)).astype(np.float32)),
        _t(rng.normal(size=(n, H)).astype(np.float32)))
    seed, p = 2 ** 31 - 2, 0.5
    acc = tuple(torch.zeros(n, w) for w in gat_output_widths(mode, H, H * D))
    keep = torch.zeros(idx.numel(), H)
    for ptr in ptrs:
        *_, k = gat_pass(mode, ptr, idx, None, sd, ss, ss.amax(0),
                         ht.reshape(n, -1), *back, alpha=0.2, attn_drop=p,
                         seed=torch.tensor([seed]), with_keep=True, acc=acc,
                         coord_key=True)
        keep += k
    grp = _np(torch.cat([panel_edges(ptr)[1] for ptr in ptrs]))
    nbr = _np(idx)
    dst, src = (nbr, grp) if mode == "dsrc" else (grp, nbr)
    ref = _np_coord_keep(dst, src, seed, H, p)
    np.testing.assert_array_equal(_np(keep), ref)
    assert 0.4 < (ref > 0).mean() < 0.6


def test_forward_and_backward_passes_draw_the_same_mask(gat_setup):
    """dsrc reads the shared structure with the roles of row and col
    swapped; the key swaps with them, so edge (r, c) gets one decision in
    all three passes."""
    _, gtp, a_dst, a_src, h, _ = gat_setup
    ex = gtp.extras
    n, ht = gtp.n_pad, _t(h)
    sd, ss = (ht * _t(a_dst)).sum(-1), (ht * _t(a_src)).sum(-1)
    z = torch.zeros
    kw = dict(alpha=0.2, attn_drop=0.5, seed=torch.tensor([7]),
              with_keep=True, coord_key=True)
    keeps = {}
    for mode, acc in (("fwd", (z(n, H * D), z(n, H))),
                      ("dsrc", (z(n, H * D), z(n, H)))):
        back = () if mode == "fwd" else (z(n, H * D), z(n, H))
        total = z(ex["spmm_fw_col"].numel(), H)
        for ptr in ex["spmm_fw_ptr"]:
            total += gat_pass(mode, ptr, ex["spmm_fw_col"], None, sd, ss,
                              ss.amax(0), ht.reshape(n, -1), *back, acc=acc,
                              **kw)[-1]
        keeps[mode] = _np(total)
    grp = _np(torch.cat([panel_edges(p)[1] for p in ex["spmm_fw_ptr"]]))
    nbr = _np(ex["spmm_fw_col"])
    # entry s is edge (grp, nbr) in fwd and edge (nbr, grp) in dsrc: look the
    # transposed edge's fwd decision up by its coordinates
    fwd = {(int(r), int(c)): tuple(k) for r, c, k in zip(grp, nbr,
                                                         keeps["fwd"])}
    for r, c, k in zip(grp, nbr, keeps["dsrc"]):
        assert fwd[(int(c), int(r))] == tuple(k)


# -- (6) the chunk schedule of K1/K2 and the plain version cut the same way ---

import chip_smoke  # noqa: E402  (the adversarial structures of the card run)
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph  # noqa: E402
from cogdl_tpu_torch.ops.cuda import (  # noqa: E402
    SCHEDULE_KEYS,
    SpmmSchedule,
    build_spmm_schedule,
    spmm_csr_chunked_reference,
    stored_schedule,
)
from cogdl_tpu_torch.ops.cuda.device_layout import SPMM_PANELS  # noqa: E402
from cogdl_tpu_torch.ops.cuda.segment_kernels import (  # noqa: E402
    K1_KERNELS,
    SpMMFunction,
    _check_launch_args,
    _schedule_args,
    spmm_csr,
)

def _assert_within_terms(out, ref, scale):
    """fp32, summation order only (the chunked plain version adds a cut
    row's pieces, the plain version its edges): each element within
    ``1e-6 + 1e-5·Σ|terms|``, the tolerance of the card run, since a star
    row sums thousands of terms that cancel."""
    assert chip_smoke.scaled_err(out, ref, scale) <= 1.0


CPU = torch.device("cpu")
ADVERSARIAL = ("star", "mixed_rows", "no_edge", "middle_third_unnamed",
               "powerlaw", "host_block")
CHUNKS = (4, 32, 128)


def _adversarial(name, chunk):
    found = {n: rest for n, *rest in
             chip_smoke.adversarial_structures(CPU, chunk)}
    assert tuple(found) == ADVERSARIAL
    return found[name]


def _structure_and_schedule(row, col, n, chunk, panel_rows=0, seed=0):
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        size=row.numel()).astype(np.float32))
    st_ = build_spmm_structure(row, col, w, n, panel_rows, chunk_edges=chunk)
    return st_, SpmmSchedule(*(st_[k] for k in SCHEDULE_KEYS))


def _assert_is_a_partition(ptr, sched, chunk):
    """Every edge of ``ptr`` lies in exactly one chunk of fewer than 2T
    edges, rows of at most T edges lie in one chunk, and ``cross`` lists
    exactly the other rows with the chunks that hold them."""
    lo, hi = int(ptr[0]), int(ptr[-1])
    starts = sched.chunk_start.tolist()
    assert starts[0] == lo and starts[-1] == hi
    sizes = np.diff(starts)
    assert (sizes >= 0).all() and (sizes < 2 * chunk).all()
    assert sizes.sum() == hi - lo
    lens = (ptr[1:] - ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(lens.numel()), lens)
    assert torch.equal(sched.erow[lo:hi].long(), rows)
    # chunk of every edge, then the chunks a row touches
    real = [c for c in range(len(sizes)) if sizes[c] > 0]
    edge_chunk = np.repeat(real, sizes[real])
    cut = {}
    for r in torch.nonzero(lens).flatten().tolist():
        a, b = int(ptr[r]) - lo, int(ptr[r + 1]) - lo
        first, last = int(edge_chunk[a]), int(edge_chunk[b - 1])
        if first != last:
            cut[r] = (first, last)
            assert b - a > chunk
        else:
            assert b - a <= chunk
    listed = {r: (f, la) for r, f, la in sched.cross.tolist() if r >= 0}
    assert listed == cut
    # the scratch: one slot a piece of a cut row, in the order of the edges
    slots = sched.piece_start.tolist()
    assert len(slots) == len(starts) and slots[0] == 0
    want_rows = [r for r, (f, la) in sorted(cut.items(), key=lambda kv: kv[1])
                 for _ in range(f, la + 1)]
    assert slots[-1] == len(want_rows)
    piece_row = sched.piece_row.tolist()
    assert piece_row[:len(want_rows)] == want_rows
    assert all(r == -1 for r in piece_row[len(want_rows):])
    for r, (f, la) in cut.items():
        # its first piece is the last one of chunk f, the others follow
        first_slot = slots[f + 1] - 1
        assert piece_row[first_slot:first_slot + la - f + 1] == [r] * (
            la - f + 1)
        assert all(slots[c] == first_slot + c - f for c in range(f + 1, la + 1))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_schedule_puts_every_edge_in_exactly_one_chunk(name, chunk):
    row, col, n = _adversarial(name, chunk)
    for r, c in ((row, col), (col, row)):
        st_, sched = _structure_and_schedule(r, c, n, chunk)
        _assert_is_a_partition(st_["ptr"], sched, chunk)
        pan, psched = _structure_and_schedule(r, c, n, chunk,
                                              panel_rows=n // 3)
        assert pan["ptr"].shape[0] == 3
        for p, ptr in enumerate(pan["ptr"]):
            _assert_is_a_partition(ptr, psched.panel(p), chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_chunked_plain_version_matches_plain_version(name, chunk):
    row, col, n = _adversarial(name, chunk)
    rng = np.random.default_rng(3)
    for r, c in ((row, col), (col, row)):
        st_, sched = _structure_and_schedule(r, c, n, chunk)
        pan, psched = _structure_and_schedule(r, c, n, chunk,
                                              panel_rows=n // 3)
        for feat in (8, 47):
            x = _t(rng.normal(size=(n, feat)).astype(np.float32))
            args = (st_["ptr"], st_["col"], st_["w"], x)
            scale = spmm_csr_reference(st_["ptr"], st_["col"], st_["w"].abs(),
                                       x.abs())
            _assert_within_terms(spmm_csr_chunked_reference(*args, sched),
                                 spmm_csr_reference(*args), scale)
            acc0 = _t(rng.normal(size=(n, feat)).astype(np.float32))
            acc, ref = acc0.clone(), acc0.clone()
            for p, ptr in enumerate(pan["ptr"]):
                untouched = ptr[1:] == ptr[:-1]
                before = acc[untouched].clone()
                spmm_csr_chunked_reference(ptr, pan["col"], pan["w"], x,
                                           psched.panel(p), acc)
                assert torch.equal(acc[untouched], before)
                spmm_csr_accum_reference(ref, ptr, pan["col"], pan["w"], x)
            _assert_within_terms(acc, ref, acc0.abs() + scale)


@settings(max_examples=10, deadline=None)
@given(nodes=st.integers(20, 120), degree=st.integers(1, 12),
       chunk=st.sampled_from([3, 8, 32, 128]), seed=st.integers(0, 10_000),
       panels=st.integers(1, 4))
def test_chunked_plain_version_on_random_powerlaw_graphs(nodes, degree, chunk,
                                                         seed, panels):
    g = powerlaw_graph(nodes, avg_degree=degree, feat_dim=4, num_classes=3,
                       seed=seed)
    E = g.num_edges
    # over the transpose: its rows are the power-law ones
    row, col = g.col[:E].long(), g.row[:E].long()
    pr = 0 if panels == 1 else -(-g.n_pad // panels)
    st_, sched = _structure_and_schedule(row, col, g.n_pad, chunk, pr, seed)
    x = _t(np.random.default_rng(seed).normal(
        size=(g.n_pad, 5)).astype(np.float32))
    ptrs = st_["ptr"] if pr else st_["ptr"][None]
    acc = torch.zeros_like(x)
    for p, ptr in enumerate(ptrs):
        ps = sched.panel(p) if pr else sched
        _assert_is_a_partition(ptr, ps, chunk)
        spmm_csr_chunked_reference(ptr, st_["col"], st_["w"], x, ps, acc)
    w = _t(np.random.default_rng(seed).normal(
        size=row.numel()).astype(np.float32))    # as the structure drew them
    _assert_within_terms(acc, tops.spmm_coo(x, row, col, w, g.n_pad),
                         tops.spmm_coo(x.abs(), row, col, w.abs(), g.n_pad))


def test_panel_schedule_is_each_panels_own_schedule(prepped):
    gj, _, _ = prepped
    row, col, _ = _edges(gj)
    pan, sched = _structure_and_schedule(_t(row), _t(col), gj.n_pad, 16,
                                         PANEL_ROWS)
    assert sched.chunk_start.shape[0] == pan["ptr"].shape[0] > 1
    for p, ptr in enumerate(pan["ptr"]):
        own = build_spmm_schedule(ptr, 16)
        lo, hi = int(ptr[0]), int(ptr[-1])
        mine = sched.panel(p)
        assert torch.equal(own.erow[lo:hi], mine.erow[lo:hi])
        k = own.chunk_start.numel()
        assert torch.equal(own.chunk_start, mine.chunk_start[:k])
        assert (mine.chunk_start[k:] == hi).all()      # padding: empty chunks
        k = own.cross.shape[0]
        assert torch.equal(own.cross, mine.cross[:k])
        assert (mine.cross[k:] == -1).all()
        k = own.piece_start.numel()
        assert torch.equal(own.piece_start, mine.piece_start[:k])
        assert (mine.piece_start[k:] == own.piece_start[-1]).all()
        k = own.piece_row.numel()
        assert torch.equal(own.piece_row, mine.piece_row[:k])
        assert (mine.piece_row[k:] == -1).all()
    assert sched.piece_row.shape[1] == int(sched.piece_start[:, -1].max())


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_scratch_holds_one_row_a_piece_of_a_cut_row(name, chunk):
    """The wrappers size the scratch from the schedule's shapes alone: as
    many rows as the cut rows have pieces, none where no row is cut."""
    row, col, n = _adversarial(name, chunk)
    for r, c in ((row, col), (col, row)):
        st_, sched = _structure_and_schedule(r, c, n, chunk)
        args, partial = _schedule_args(sched, 5, CPU)
        n_chunks = sched.chunk_start.numel() - 1
        assert args[3] == n_chunks and args[5] == sched.cross.shape[0]
        cut = sched.cross[sched.cross[:, 0] >= 0]
        pieces = int((cut[:, 2] - cut[:, 1] + 1).sum())
        if not pieces:
            assert partial is None and args[6] is None
            continue
        assert partial.shape == (pieces, 5) and args[6] == partial.data_ptr()
        assert pieces <= n_chunks + cut.shape[0] < 2 * n_chunks


def test_default_panels_of_a_device_prepared_graph(prepped):
    """No height named: the structure K1/K2 read and the structure of fused
    GAT get ``SPMM_PANELS`` panels alike, whatever the graph's size (no
    table size of the port's default goes by ``default_panel_rows``)."""
    _, gt, _ = prepped
    for kw in ({}, {"with_orig": True}):
        g = prepare_spmm_device(gt, symmetric=True, **kw)
        assert g.extras["spmm_fw_ptr"].shape == (SPMM_PANELS, gt.n_pad + 1)
        assert g.meta_get("spmm_panel_rows") == -(-gt.n_pad // SPMM_PANELS)
    assert default_panel_rows(gt.n_pad) == 0
    assert not any(k.endswith("_orig") for k in g.extras)


def test_symmetric_structure_shares_its_schedule(prepped):
    _, gt, _ = prepped
    for pr in (0, PANEL_ROWS):
        ex = prepare_spmm_device(gt, symmetric=True, panel_rows=pr).extras
        for k in SCHEDULE_KEYS:
            assert ex[f"spmm_bw_{k}"] is ex[f"spmm_fw_{k}"]
        one = prepare_spmm_device(gt, symmetric=True, with_orig=True,
                                  store_w=True, panel_rows=pr).extras
        assert one["spmm_bw_erow"] is one["spmm_fw_erow"]
    two = prepare_spmm_device(gt, panel_rows=PANEL_ROWS)
    assert two.extras["spmm_bw_erow"] is not two.extras["spmm_fw_erow"]


def test_prepare_spmm_and_prepare_spmm_device_give_equal_schedules():
    # a power-law graph: columns of hundreds of edges, cut at 128 a chunk
    g = tg.sym_norm(tg.add_self_loops(powerlaw_graph(
        1500, avg_degree=20, feat_dim=4, num_classes=3, seed=2)))
    a = prepare_spmm(g)
    b = prepare_spmm_device(g, panel_rows=0)
    for d in ("fw", "bw"):
        for k in ("ptr", "col", "w") + SCHEDULE_KEYS:
            assert torch.equal(a.extras[f"spmm_{d}_{k}"],
                               b.extras[f"spmm_{d}_{k}"]), (d, k)
        assert stored_schedule(a.extras, d) is not None
    assert (a.extras["spmm_bw_cross"][:, 0] >= 0).any()
    assert a.extras["spmm_fw_cross"].shape == (0, 3)


def test_functions_take_the_prepared_schedules(prepped):
    """The dispatcher hands the stored schedules to the Functions; on CPU
    tensors they change nothing."""
    _, gt, x = prepped
    for g in (prepare_spmm(gt), prepare_spmm_device(gt,
                                                    panel_rows=PANEL_ROWS)):
        ex = g.extras
        keys = [ex[f"spmm_{d}_{k}"] for d in ("fw", "bw")
                for k in ("ptr", "col", "w")]
        scheds = [SpmmSchedule(*(ex[f"spmm_{d}_{k}"] for k in SCHEDULE_KEYS))
                  for d in ("fw", "bw")]
        fn = SpMMPanelFunction if keys[0].ndim == 2 else SpMMFunction
        xt = _t(x).requires_grad_(True)
        y = fn.apply(xt, *keys, *scheds)
        (dx,) = torch.autograd.grad(y.sum(), xt)
        x2 = _t(x).requires_grad_(True)
        y2 = fn.apply(x2, *keys)
        (dx2,) = torch.autograd.grad(y2.sum(), x2)
        assert torch.equal(y, y2) and torch.equal(dx, dx2)
        assert torch.equal(y, maybe_cuda_spmm(g, _t(x)))


@pytest.mark.parametrize("fault,match", [
    ("erow_dtype", "schedule.erow must be torch.int32"),
    ("erow_length", "schedule.erow has"),
    ("cross_shape", "triples"),
    ("chunk_start_rank", "schedule.chunk_start must be 1-D"),
    ("piece_start_shape", "schedule.piece_start must be shaped"),
    ("scratch_overflow", "scratch"),
])
def test_launch_check_refuses_a_schedule_that_does_not_fit(prepped, fault,
                                                           match):
    _, gt, x = prepped
    ex = prepare_spmm(gt).extras
    ptr, col, w = (ex[f"spmm_fw_{k}"] for k in ("ptr", "col", "w"))
    s = SpmmSchedule(*(ex[f"spmm_fw_{k}"] for k in SCHEDULE_KEYS))
    xt = _t(x)
    _check_launch_args(ptr, col, w, xt, schedule=s)     # the real one passes
    bad = {
        "erow_dtype": s._replace(erow=s.erow.long()),
        "erow_length": s._replace(erow=s.erow[:-1]),
        "cross_shape": s._replace(cross=s.cross.new_zeros((2, 2))),
        "chunk_start_rank": s._replace(chunk_start=s.chunk_start[None]),
        "piece_start_shape": s._replace(piece_start=s.piece_start[:-1]),
        # pieces · F reaches 2³¹; the entries are never read or written
        "scratch_overflow": s._replace(piece_row=torch.empty(
            2 ** 31 // xt.shape[1] + 1, dtype=torch.int32)),
    }[fault]
    err = TypeError if fault == "erow_dtype" else ValueError
    with pytest.raises(err, match=match):
        _check_launch_args(ptr, col, w, xt, schedule=bad)


def test_k1_wrapper_refuses_an_unknown_kernel_name(prepped):
    _, gt, x = prepped
    ex = prepare_spmm(gt).extras
    with pytest.raises(ValueError, match="kernel must be one of"):
        spmm_csr(ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_w"],
                 _t(x), kernel="columns")
    with pytest.raises(ValueError, match="chunk_edges must be positive"):
        build_spmm_schedule(ex["spmm_fw_ptr"], 0)
    # on the CPU every name runs the plain version
    args = (ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_w"], _t(x))
    for kernel in K1_KERNELS:
        assert torch.equal(spmm_csr(*args, kernel=kernel),
                           spmm_csr_reference(*args))


# -- K3 on the chunk schedule ---------------------------------------------------

from cogdl_tpu_torch.ops.cuda import gat_pass_chunked_reference  # noqa: E402
from cogdl_tpu_torch.ops.cuda.segment_kernels import (  # noqa: E402
    GAT_MODES,
    gat_pass_reference,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _gat_tables(n, H, D, rng):
    f = lambda *shape: _t(rng.normal(size=shape).astype(np.float32))  # noqa
    ss = f(n, H)
    return dict(sd=f(n, H), ss=ss, smax=ss.amax(0), h2=f(n, H * D),
                dagg=f(n, H * D), dden=f(n, H))


def _gat_scale(mode, ptr, idx, orig, t, back, **kw):
    """Σ|terms| of each output element: every term is a product with
    ex·slope·keep >= 0, so the plain pass over |tables| sums them."""
    return gat_pass_reference(mode, ptr, idx, orig, t["sd"], t["ss"],
                              t["smax"], t["h2"].abs(),
                              *(b.abs() for b in back), **kw)


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_chunked_gat_plain_version_matches_plain_version(name, chunk):
    """K3 cut the way the chunk kernel cuts it (rows inside a chunk summed
    at once, cut rows in pieces whose dots are taken before they are
    stored, the pieces added in order) against the plain version, on the
    adversarial structures at 4 and 8 edges a chunk, both directions,
    every mode, attention dropout 0 and 0.6: single-shot, and over three
    panels from a non-zero accumulator. Each element within the card
    run's tolerance, keep masks and the rows without an edge bit for
    bit."""
    row, col, n = _adversarial(name, chunk)
    rng = np.random.default_rng(4)
    seed = torch.tensor([777], dtype=torch.int64)
    for r, c in ((row, col), (col, row)):
        one = build_spmm_structure(r, c, None, n, 0, with_orig=True,
                                   chunk_edges=chunk)
        pan = build_spmm_structure(r, c, None, n, -(-n // 3),
                                   chunk_edges=chunk)
        s_one, s_pan = (SpmmSchedule(*(st[k] for k in SCHEDULE_KEYS))
                        for st in (one, pan))
        for mode, drop, (H, D) in itertools.product(
                GAT_MODES, (0.0, 0.6), ((2, 4), (1, 5))):
            t = _gat_tables(n, H, D, rng)
            back = () if mode == "fwd" else (t["dagg"], t["dden"])
            args = (mode, one["ptr"], one["col"], one["orig"], t["sd"],
                    t["ss"], t["smax"], t["h2"], *back)
            kw = dict(alpha=0.2, attn_drop=drop, seed=seed, with_keep=True)
            *got, keep = gat_pass_chunked_reference(*args, schedule=s_one,
                                                    **kw)
            *want, keep_ref = gat_pass_reference(*args, **kw)
            *scale, _ = _gat_scale(*args[:4], t, back, **kw)
            assert torch.equal(keep, keep_ref)
            for o, w, sc in zip(got, want, scale):
                _assert_within_terms(o, w, sc)
            kwa = dict(alpha=0.2, attn_drop=drop, seed=seed, coord_key=True,
                       with_keep=True)
            acc0 = tuple(_t(rng.normal(size=(n, w)).astype(np.float32))
                         for w in gat_output_widths(mode, H, H * D))
            acc, ref = (tuple(a.clone() for a in acc0) for _ in range(2))
            scale = tuple(a.abs() for a in acc0)
            for p, ptr in enumerate(pan["ptr"]):
                untouched = ptr[1:] == ptr[:-1]
                before = [a[untouched].clone() for a in acc]
                pargs = (mode, ptr, pan["col"], None, t["sd"], t["ss"],
                         t["smax"], t["h2"], *back)
                *_, keep = gat_pass_chunked_reference(
                    *pargs, schedule=s_pan.panel(p), acc=acc, **kwa)
                *_, keep_ref = gat_pass_reference(*pargs, acc=ref, **kwa)
                _gat_scale(*pargs[:4], t, back, acc=scale, **kwa)
                assert torch.equal(keep, keep_ref)
                assert all(torch.equal(a[untouched], b)
                           for a, b in zip(acc, before))
            for o, w, sc in zip(acc, ref, scale):
                _assert_within_terms(o, w, sc)


def test_chunked_gat_plain_version_refuses_a_schedule_of_another_structure():
    row, col, n = _adversarial("mixed_rows", 8)
    st_ = build_spmm_structure(row, col, None, n, 0, with_orig=True,
                               chunk_edges=8)
    other = build_spmm_structure(col, row, None, n, 0, chunk_edges=8)
    t = _gat_tables(n, 1, 3, np.random.default_rng(0))
    with pytest.raises(AssertionError, match="schedule"):
        gat_pass_chunked_reference(
            "fwd", st_["ptr"], st_["col"], None, t["sd"], t["ss"], t["smax"],
            t["h2"], alpha=0.2,
            schedule=SpmmSchedule(*(other[k] for k in SCHEDULE_KEYS)))


@pytest.mark.parametrize("panel_rows", [0, PANEL_ROWS])
def test_gat_structure_carries_the_weighted_builds_schedule(prepped,
                                                            panel_rows):
    """A ``with_orig`` structure (fused GAT, no weights) carries the
    schedule that the weighted build of the same edges carries, in both
    directions; under ``symmetric`` the directions share it as they share
    ``ptr``."""
    _, gt, _ = prepped
    gat = prepare_spmm_device(gt, with_orig=True, panel_rows=panel_rows)
    gcn = prepare_spmm_device(gt, panel_rows=panel_rows)
    for d in ("fw", "bw"):
        assert f"spmm_{d}_w" not in gat.extras
        for k in SCHEDULE_KEYS:
            assert torch.equal(gat.extras[f"spmm_{d}_{k}"],
                               gcn.extras[f"spmm_{d}_{k}"]), (d, k)
    sym = prepare_spmm_device(gt, symmetric=True, with_orig=True,
                              panel_rows=panel_rows).extras
    for k in ("ptr",) + SCHEDULE_KEYS:
        assert sym[f"spmm_bw_{k}"] is sym[f"spmm_fw_{k}"]
