"""cogdl_tpu_torch graph container and synthetic datasets against the JAX
package: the same COO and the same seeds give identical arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu.datasets.synthetic as jsyn
import cogdl_tpu_torch.data.graph as tg
import cogdl_tpu_torch.datasets.synthetic as tsyn
from cogdl_tpu_torch.datasets import build_dataset

# weight transforms sum degrees in another order: fp32, a few ulps
W_RTOL, W_ATOL = 1e-6, 1e-7
FIELDS = ("row_ptr", "row", "col", "edge_weight", "x", "y", "train_mask",
          "val_mask", "test_mask")


def _coo(seed=0, n=60, e=300):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e))
    w = rng.uniform(0.5, 2.0, size=e).astype(np.float32)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = rng.integers(0, 3, size=n).astype(np.int32)
    mask = rng.uniform(size=n) < 0.5
    return ei, w, x, y, mask


def _both(seed=0, **kw):
    ei, w, x, y, mask = _coo(seed)
    args = dict(num_nodes=60, edge_weight=w, x=x, y=y, train_mask=mask,
                val_mask=~mask, test_mask=mask, **kw)
    return jg.from_coo(ei, **args), tg.from_coo(ei, **args)


def assert_same_graph(gj, gt, exact_weights=True):
    assert (gj.num_nodes, gj.num_edges, gj.n_pad, gj.e_pad) == (
        gt.num_nodes, gt.num_edges, gt.n_pad, gt.e_pad)
    for name in FIELDS:
        a, b = getattr(gj, name), getattr(gt, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if name == "edge_weight" and not exact_weights:
            np.testing.assert_allclose(b, a, rtol=W_RTOL, atol=W_ATOL)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    assert dict(gj.meta).get("norm") == dict(gt.meta).get("norm")


@pytest.mark.parametrize("kw", [{}, {"coalesce": True}, {"bucket": False},
                                {"n_pad": 100, "e_pad": 400}])
def test_from_coo_matches(kw):
    gj, gt = _both(**kw)
    assert_same_graph(gj, gt)


@pytest.mark.parametrize("transform", ["add_self_loops", "remove_self_loops",
                                       "to_undirected"])
def test_structural_transforms_match(transform):
    gj, gt = _both(seed=1)
    assert_same_graph(getattr(jg, transform)(gj), getattr(tg, transform)(gt))


@pytest.mark.parametrize("norm", ["sym_norm", "row_norm", "col_norm"])
def test_norms_match_and_are_idempotent(norm):
    gj, gt = _both(seed=2)
    gj, gt = jg.add_self_loops(gj), tg.add_self_loops(gt)
    nj, nt = getattr(jg, norm)(gj), getattr(tg, norm)(gt)
    assert_same_graph(nj, nt, exact_weights=False)
    assert getattr(tg, norm)(nt) is nt


@pytest.mark.parametrize("norm", ["sym_norm", "row_norm", "col_norm"])
def test_a_norm_that_changes_the_weights_drops_the_kernel_structure(norm):
    """A normalisation that changes the weights hands them to the structure:
    its ``spmm_*_w`` become the new weights (the forward's with their
    gradient, the transpose's in CSC order), its topology stays, the
    node-level extras stay, and K1's route reads the new weights; on a
    graph already tagged with it, it is a no-op and the structure stays."""
    from cogdl_tpu_torch.ops import spmm_coo
    from cogdl_tpu_torch.ops.cuda import maybe_cuda_spmm, prepare_spmm

    _, gt = _both()
    keep = torch.ones(gt.n_pad)
    g = prepare_spmm(gt)
    g = g.replace(extras={**g.extras, "node_scale": keep})
    normed = getattr(tg, norm)(g)
    E = normed.num_edges
    assert not torch.equal(normed.edge_weight, g.edge_weight)
    torch.testing.assert_close(normed.extras["spmm_fw_w"],
                               normed.edge_weight[:E], rtol=0, atol=0)
    torch.testing.assert_close(
        normed.extras["spmm_bw_w"],
        normed.edge_weight[:E][g.extras["spmm_bw_orig"].long()],
        rtol=0, atol=0)
    for k in ("spmm_fw_ptr", "spmm_fw_col", "spmm_bw_ptr", "spmm_bw_col"):
        assert normed.extras[k] is g.extras[k]
    assert normed.extras["node_scale"] is keep
    x = torch.randn(gt.n_pad, 2)
    torch.testing.assert_close(
        maybe_cuda_spmm(normed, x),
        spmm_coo(x, normed.row, normed.col, normed.edge_weight, gt.n_pad),
        rtol=1e-5, atol=1e-6)
    tagged = prepare_spmm(normed)
    again = getattr(tg, norm)(tagged)
    assert again is tagged and "spmm_fw_w" in again.extras
    torch.testing.assert_close(again.extras["spmm_fw_w"],
                               again.edge_weight[: again.num_edges],
                               rtol=0, atol=0)


def test_pad_to_matches():
    gj, gt = _both(seed=3)
    pj = jg.pad_to(gj, gj.n_pad + 37, gj.e_pad + 100)
    pt = tg.pad_to(gt, gt.n_pad + 37, gt.e_pad + 100)
    assert_same_graph(pj, pt)
    # pad edges sit in the sink row with weight 0
    E = pt.num_edges
    assert (pt.row[E:] == pt.n_pad - 1).all() and (pt.edge_weight[E:] == 0).all()
    with pytest.raises(ValueError):
        tg.pad_to(gt, gt.n_pad - 1, gt.e_pad)


def test_masks_and_degrees_match():
    gj, gt = _both(seed=4)
    np.testing.assert_array_equal(gt.node_mask().numpy(),
                                  np.asarray(gj.node_mask()))
    np.testing.assert_array_equal(gt.edge_mask().numpy(),
                                  np.asarray(gj.edge_mask()))
    for weighted in (False, True):
        np.testing.assert_allclose(gt.in_degrees(weighted).numpy(),
                                   np.asarray(gj.in_degrees(weighted)),
                                   rtol=1e-6)
        np.testing.assert_allclose(gt.out_degrees(weighted).numpy(),
                                   np.asarray(gj.out_degrees(weighted)),
                                   rtol=1e-6)


def test_graph_to_moves_every_tensor():
    _, gt = _both(seed=5)
    g = gt.replace(extras={"prop_x": torch.ones(gt.n_pad, 2)})
    moved = g.to("meta")
    assert moved.row_ptr.device.type == "meta"
    assert moved.x.device.type == "meta"
    assert moved.extras["prop_x"].device.type == "meta"
    assert moved.meta == g.meta


@pytest.mark.parametrize("seed", [0, 7])
def test_sbm_graph_matches(seed):
    kw = dict(num_nodes=150, num_classes=3, seed=seed)
    assert_same_graph(jsyn.sbm_graph(**kw), tsyn.sbm_graph(**kw))


def test_powerlaw_graph_matches():
    kw = dict(avg_degree=6, feat_dim=8, num_classes=5, seed=3)
    assert_same_graph(jsyn.powerlaw_graph(200, **kw),
                      tsyn.powerlaw_graph(200, **kw))


def test_build_dataset_names():
    ds = build_dataset("powerlaw-1k", avg_degree=3, feat_dim=4)
    assert ds.graph.num_nodes == 1000 and ds.num_features == 4
    assert build_dataset("sbm").num_classes == 4
    with pytest.raises(ValueError, match="not yet ported"):
        build_dataset("cora")
