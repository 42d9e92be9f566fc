"""The kernel structure follows the graph's weights: every way the port
changes a prepared graph's ``edge_weight`` (``Graph.with_edge_weight``,
``Graph.replace`` without new extras, the three norms,
``transforms.drop_edge``)
hands K1 the new weights, so that ``spmm`` over the structure equals the
plain ``spmm_coo`` with the new weights in its forward, ``dx`` and ``dw``,
and the JAX package's ``spmm`` over the same weights. The topology and the
schedules stay as ``prepare_spmm`` built them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu_torch.data.graph as tg
from cogdl_tpu.ops import spmm as j_spmm
from cogdl_tpu_torch.ops import spmm, spmm_coo
from cogdl_tpu_torch.ops.cuda import (
    SCHEDULE_KEYS,
    maybe_cuda_spmm,
    prepare_spmm,
    prepare_spmm_device,
)

# fp32 sums of a few terms in another order (tests/test_torch_ops.py)
RTOL, ATOL = 1e-5, 1e-6
N, E, F = 70, 400, 6
TOPOLOGY = ("ptr", "col", "orig") + tuple(SCHEDULE_KEYS)


def _coo(seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, N, size=(2, E))
    w = rng.uniform(0.5, 2.0, size=E).astype(np.float32)
    x = rng.normal(size=(N, F)).astype(np.float32)
    return ei, w, x


def _graphs(seed=0):
    """The same self-loop graph in both packages; the port's prepared."""
    ei, w, x = _coo(seed)
    gj = jg.add_self_loops(jg.from_coo(ei, num_nodes=N, edge_weight=w, x=x))
    gt = tg.add_self_loops(tg.from_coo(ei, num_nodes=N, edge_weight=w, x=x))
    return gj, prepare_spmm(gt)


def _new_weights(g, seed):
    rng = np.random.default_rng(seed)
    w = torch.zeros(g.e_pad)
    w[: g.num_edges] = torch.from_numpy(
        rng.uniform(-1.0, 2.0, g.num_edges).astype(np.float32))
    return w


def _reweight(how, g, w):
    if how == "replace":
        return g.replace(edge_weight=w)
    if how == "with_edge_weight":
        return g.with_edge_weight(w)
    if how == "replace_with_other_fields":
        return g.replace(edge_weight=w, x=g.x * 2.0)
    return getattr(tg, how)(g.replace(edge_weight=w))


def _oracle(g, w):
    """``spmm_coo`` over the new weights: the plain tier, no structure."""
    return lambda x: spmm_coo(x, g.row, g.col, w, g.n_pad)


def _check_against_coo(g, w, seed=1):
    """Forward, dx and dw of ``spmm`` over ``g`` (structure attached, weights
    ``w`` with a gradient) against ``spmm_coo`` over the same weights."""
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.normal(size=(g.n_pad, F)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(g.n_pad, F)).astype(np.float32))
    outs, grads = [], []
    for kernel in (True, False):
        x = x0.clone().requires_grad_(True)
        ww = w.detach().clone().requires_grad_(True)
        gg = g.replace(edge_weight=ww)
        out = spmm(gg, x) if kernel else _oracle(gg, ww)(x)
        (out * r).sum().backward()
        outs.append(out.detach())
        grads.append((x.grad, ww.grad))
    torch.testing.assert_close(outs[0], outs[1], rtol=RTOL, atol=ATOL)
    (dx_k, dw_k), (dx_p, dw_p) = grads
    torch.testing.assert_close(dx_k, dx_p, rtol=RTOL, atol=ATOL)
    # dw over the real edges; K1's structure holds no pad edge, whose
    # weight then takes no gradient (the plain tier's sink-row product)
    E = g.num_edges
    torch.testing.assert_close(dw_k[:E], dw_p[:E], rtol=RTOL, atol=ATOL)
    assert not dw_k[E:].any()


@pytest.mark.parametrize("how", ["replace", "replace_with_other_fields",
                                 "with_edge_weight"])
def test_spmm_after_a_reweight_reads_the_new_weights(how):
    """``replace(edge_weight=w2)`` on a prepared graph, then ``spmm``: the
    new weights, not the structure's snapshot of the old ones, forward and
    both gradients. Twice in a row, to hold a reweight of a reweight."""
    _, g = _graphs()
    for seed in (3, 4):
        w = _new_weights(g, seed)
        g = _reweight(how, g, w)
        assert maybe_cuda_spmm(g, g.x) is not None      # K1's route
        _check_against_coo(g, w)
        torch.testing.assert_close(spmm(g, g.x), _oracle(g, w)(g.x),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("how", ["sym_norm", "row_norm", "col_norm"])
def test_a_norm_of_a_prepared_graph_reweights_its_structure(how):
    _, g = _graphs(seed=2)
    normed = _reweight(how, g, _new_weights(g, 5).abs())
    assert "spmm_fw_w" in normed.extras
    _check_against_coo(normed, normed.edge_weight)


def test_spmm_after_a_reweight_matches_the_jax_package():
    gj, g = _graphs(seed=6)
    w = _new_weights(g, 7)
    out = spmm(g.replace(edge_weight=w), g.x)
    ref = j_spmm(gj.replace(edge_weight=jnp.asarray(w.numpy())), gj.x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_a_reweight_keeps_the_topology_and_rebuilds_only_the_weights():
    """``spmm_*_ptr``, ``_col``, ``_orig`` and the schedules are the very
    tensors ``prepare_spmm`` built; ``spmm_fw_w`` carries the new weights'
    gradient and ``spmm_bw_w`` is their constant copy in CSC order."""
    _, g = _graphs()
    w = _new_weights(g, 8).requires_grad_(True)
    g2 = g.replace(edge_weight=w)
    E = g.num_edges
    for d in ("fw", "bw"):
        for k in TOPOLOGY:
            assert g2.extras[f"spmm_{d}_{k}"] is g.extras[f"spmm_{d}_{k}"]
    fw, bw = g2.extras["spmm_fw_w"], g2.extras["spmm_bw_w"]
    assert fw.requires_grad and not bw.requires_grad
    assert torch.equal(fw.detach(), w.detach()[:E])
    assert torch.equal(bw, w.detach()[:E][g.extras["spmm_bw_orig"].long()])
    # the other extras and the meta stay
    assert g2.meta == g.meta


def test_a_replace_that_leaves_the_weights_keeps_the_structure():
    _, g = _graphs()
    g2 = g.replace(x=g.x * 2)
    assert g2.extras is g.extras


def test_drop_edge_goes_through_the_structure():
    """``drop_edge`` then ``sym_norm`` on a prepared graph (DropEdge-GCN's
    training step): the structure carries the dropped, renormalised
    weights."""
    from cogdl_tpu_torch.utils import transforms

    _, g = _graphs()
    gen = torch.Generator().manual_seed(0)
    d = tg.sym_norm(transforms.drop_edge(g, 0.3, gen))
    assert "spmm_fw_w" in d.extras and d.meta_get("norm") == "sym"
    assert (d.edge_weight[: d.num_edges] == 0).any()
    _check_against_coo(d, d.edge_weight)


def test_a_panel_structure_refuses_new_weights():
    """A panel-major structure has no map back to the edge list: a reweight
    raises rather than keep the old weights."""
    _, g = _graphs()
    plain = tg.add_self_loops(tg.from_coo(_coo()[0], num_nodes=N))
    panels = prepare_spmm_device(plain, panel_rows=16)
    with pytest.raises(ValueError, match="reweight"):
        panels.replace(edge_weight=_new_weights(g, 1))
    with pytest.raises(ValueError, match="reweight"):
        tg.sym_norm(panels)


def test_a_structure_without_weights_is_kept_as_it_is():
    """The fused GAT structure stores no weights (``store_w=False``):
    nothing is stale, so a reweight keeps it."""
    plain = tg.add_self_loops(tg.from_coo(_coo()[0], num_nodes=N))
    gat = prepare_spmm_device(plain, with_orig=True, panel_rows=0)
    assert "spmm_fw_w" not in gat.extras
    assert tg.sym_norm(gat).extras is gat.extras


def test_to_keeps_the_structures_weights():
    _, g = _graphs()
    moved = g.to("cpu")
    assert moved.extras["spmm_fw_w"] is g.extras["spmm_fw_w"]


def _refuse_reweights(monkeypatch):
    import cogdl_tpu_torch.ops.cuda as oc

    def refuse(graph):
        raise AssertionError("a copy of the graph reweighted its structure")

    monkeypatch.setattr(oc, "reweighted_structure", refuse)


def test_a_replace_that_passes_the_extras_keeps_them_as_they_are(
        monkeypatch):
    """New weights passed with extras (a copy to another device, the
    bench's freed edge arrays): the caller's structure, no reweight."""
    _refuse_reweights(monkeypatch)
    _, g = _graphs()
    g2 = g.replace(edge_weight=_new_weights(g, 2), extras=g.extras)
    assert g2.extras is g.extras


def test_the_prefetchers_copy_runs_no_reweight(monkeypatch):
    """``_to_device`` moves a batch's weights and structure together: the
    structure's weights stay the tensors it copied (on the card those are
    the ones marked for the consumer's stream), and no gather runs."""
    from cogdl_tpu_torch.data.sampling import _to_device

    _refuse_reweights(monkeypatch)
    _, g = _graphs()
    copied = []
    (moved,) = _to_device((g,), torch.device("cpu"), copied, {})
    for d in ("fw", "bw"):
        assert moved.extras[f"spmm_{d}_w"] is g.extras[f"spmm_{d}_w"]
    assert moved.edge_weight is g.edge_weight
