"""cogdl_tpu_torch ops against the JAX package on the CPU: segment ops,
spmm_coo/spmm (forward, d/dx, d/dw), K1's plain version over the CSR/CSC
structure against the Pallas K1 route (interpret mode), cache_propagation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu.ops as jops
import cogdl_tpu.ops.segment as jseg
import cogdl_tpu_torch.data.graph as tg
import cogdl_tpu_torch.ops as tops
import cogdl_tpu_torch.ops.segment as tseg
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.ops.pallas import prepare_spmm as j_prepare_spmm
from cogdl_tpu.ops.pallas.segment_kernels import spmm_pallas
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.ops.cuda import maybe_cuda_spmm, prepare_spmm
from cogdl_tpu_torch.ops.cuda.segment_kernels import (
    SpMMFunction,
    _check_launch_args,
    spmm_csr,
    spmm_csr_reference,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 sums in another order (XLA segment ops / Pallas one-hot matmuls vs
# torch index_add): relative 1e-5 of O(1) values
RTOL, ATOL = 1e-5, 1e-5


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def graphs():
    gj = jg.sym_norm(jg.add_self_loops(j_sbm(num_nodes=200, seed=3)))
    gt = tg.sym_norm(tg.add_self_loops(t_sbm(num_nodes=200, seed=3)))
    return gj, gt


def _feats(n, f, seed=0):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max"])
@pytest.mark.parametrize("width", [(), (3,)])
def test_segment_reductions_match(op, width):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(50,) + width).astype(np.float32)
    ids = np.sort(rng.integers(0, 12, size=50)).astype(np.int32)  # 12+ empty
    out_j = getattr(jseg, op)(jnp.asarray(data), jnp.asarray(ids), 15)
    out_t = getattr(tseg, op)(torch.from_numpy(data), torch.from_numpy(ids), 15)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_and_gather_match(masked):
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(40, 2)).astype(np.float32)
    ids = np.sort(rng.integers(0, 9, size=40)).astype(np.int32)
    mask = rng.uniform(size=40) < 0.7 if masked else None
    out_j = jseg.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), 10,
                                 mask=None if mask is None else jnp.asarray(mask))
    out_t = tseg.segment_softmax(torch.from_numpy(scores), torch.from_numpy(ids),
                                 10, mask=None if mask is None
                                 else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(
        _np(tseg.gather(torch.from_numpy(scores), torch.from_numpy(ids))),
        np.asarray(jseg.gather(jnp.asarray(scores), jnp.asarray(ids))))


@pytest.mark.parametrize("prepared", [False, True])
def test_spmm_forward_and_grads_match(graphs, prepared):
    """d/dx and d/dw of sum(spmm(x) * probe) on both packages' XLA/plain
    routes; ``prepared`` sends the port through the kernel tier's
    autograd Function (its plain version on CPU tensors)."""
    gj, gt = graphs
    x = _feats(gj.n_pad, 7)
    probe = _feats(gj.n_pad, 7, seed=1)

    def loss_j(x, w):
        out = jops.spmm_coo(x, gj.row, gj.col, w, gj.n_pad)
        return jnp.sum(out * probe), out

    (_, out_j), (dx_j, dw_j) = jax.value_and_grad(loss_j, argnums=(0, 1),
                                                  has_aux=True)(
        jnp.asarray(x), gj.edge_weight)

    xt = torch.from_numpy(x).requires_grad_(True)
    if prepared:
        g = prepare_spmm(gt)
        w = g.extras["spmm_fw_w"].clone().requires_grad_(True)
        ex = g.extras
        out_t = SpMMFunction.apply(xt, ex["spmm_fw_ptr"], ex["spmm_fw_col"], w,
                                   ex["spmm_bw_ptr"], ex["spmm_bw_col"],
                                   ex["spmm_bw_w"])
        E = gt.num_edges
        dw_ref = np.asarray(dw_j)[:E]
    else:
        w = gt.edge_weight.clone().requires_grad_(True)
        out_t = tops.spmm_coo(xt, gt.row, gt.col, w, gt.n_pad)
        dw_ref = np.asarray(dw_j)
    (out_t * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(dx_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(w.grad), dw_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weight_grad", [False, True])
def test_spmm_function_keeps_x_only_for_weight_grad(graphs, weight_grad):
    """x is read only by the d/dw SDDMM: the Function saves it only when the
    edge weights need a gradient, and d/dx is the same either way."""
    _, gt = graphs
    ex = prepare_spmm(gt).extras
    w = ex["spmm_fw_w"].clone().requires_grad_(weight_grad)
    xt = torch.from_numpy(_feats(gt.n_pad, 6)).requires_grad_(True)
    out = SpMMFunction.apply(xt, ex["spmm_fw_ptr"], ex["spmm_fw_col"], w,
                             ex["spmm_bw_ptr"], ex["spmm_bw_col"], ex["spmm_bw_w"])
    saved_x = out.grad_fn.saved_tensors[0]
    assert (saved_x is not None) == weight_grad
    out.sum().backward()
    ones = torch.ones_like(out)
    np.testing.assert_allclose(
        _np(xt.grad), _np(spmm_csr_reference(ex["spmm_bw_ptr"], ex["spmm_bw_col"],
                                             ex["spmm_bw_w"], ones)),
        rtol=RTOL, atol=ATOL)
    assert (w.grad is not None) == weight_grad


def test_spmm_dispatch_on_cpu(graphs):
    gj, gt = graphs
    x = _feats(gt.n_pad, 5)
    assert maybe_cuda_spmm(gt, torch.from_numpy(x)) is None
    ref = np.asarray(jops.spmm(gj, jnp.asarray(x)))
    for g in (gt, prepare_spmm(gt)):
        np.testing.assert_allclose(_np(tops.spmm(g, torch.from_numpy(x))), ref,
                                   rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def pallas_case():
    """The JAX Pallas K1 route (interpret mode on the CPU) and the port's
    prepared structure over the same graph."""
    gj = jg.sym_norm(jg.add_self_loops(j_sbm(num_nodes=200, seed=5)))
    gt = tg.sym_norm(tg.add_self_loops(t_sbm(num_nodes=200, seed=5)))
    pj = j_prepare_spmm(gj)
    ex = pj.extras
    args = (ex["spmm_fw_col"], ex["spmm_fw_w"], ex["spmm_fw_row"],
            ex["spmm_fw_ct"], ex["spmm_bw_col"], ex["spmm_bw_w"],
            ex["spmm_bw_row"], ex["spmm_bw_ct"])
    return pj, args, prepare_spmm(gt)


@pytest.mark.parametrize("feat", [32, 47])
def test_csr_reference_matches_pallas_k1(pallas_case, feat):
    """Forward A·X over the CSR and the backward Aᵀ·G over the CSC against
    spmm_pallas (forward) and its custom VJP (backward)."""
    pj, args, gt = pallas_case
    n = gt.num_nodes
    x = _feats(pj.n_pad, feat, seed=feat)
    probe = _feats(pj.n_pad, feat, seed=feat + 1)
    out_j, vjp = jax.vjp(lambda a: spmm_pallas(a, *args), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(probe))
    ex = gt.extras
    out_t = spmm_csr_reference(ex["spmm_fw_ptr"], ex["spmm_fw_col"],
                               ex["spmm_fw_w"], torch.from_numpy(x[: gt.n_pad]))
    dx_t = spmm_csr_reference(ex["spmm_bw_ptr"], ex["spmm_bw_col"],
                              ex["spmm_bw_w"], torch.from_numpy(probe[: gt.n_pad]))
    np.testing.assert_allclose(_np(out_t)[:n], np.asarray(out_j)[:n],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(dx_t)[:n], np.asarray(dx_j)[:n],
                               rtol=RTOL, atol=ATOL)
    # spmm_csr on CPU tensors is the plain version
    np.testing.assert_array_equal(
        _np(spmm_csr(ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_w"],
                     torch.from_numpy(x[: gt.n_pad]))), _np(out_t))


def test_prepare_spmm_structure(graphs):
    _, gt = graphs
    g = prepare_spmm(gt)
    ex, E = g.extras, gt.num_edges
    for d in ("fw", "bw"):
        assert ex[f"spmm_{d}_ptr"].dtype == torch.int32
        assert ex[f"spmm_{d}_col"].dtype == torch.int32
        assert int(ex[f"spmm_{d}_ptr"][-1]) == E == ex[f"spmm_{d}_col"].numel()
    # the backward structure is the CSR of Aᵀ: (col, row) pairs, same weights
    fw = sorted(zip(gt.row[:E].tolist(), gt.col[:E].tolist(),
                    gt.edge_weight[:E].tolist()))
    bw_rows = torch.repeat_interleave(
        torch.arange(g.n_pad), (ex["spmm_bw_ptr"][1:] - ex["spmm_bw_ptr"][:-1]).long())
    bw = sorted(zip(ex["spmm_bw_col"].tolist(), bw_rows.tolist(),
                    ex["spmm_bw_w"].tolist()))
    assert fw == bw
    # a structural rebuild drops the stale structure
    assert not any(k.startswith("spmm_") for k in (tg.add_self_loops(g).extras or {}))


def test_launch_argument_checks():
    ptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    col = torch.tensor([1, 0], dtype=torch.int32)
    w = torch.ones(2)
    x = torch.ones(2, 3)
    _check_launch_args(ptr, col, w, x)
    with pytest.raises(TypeError):
        _check_launch_args(ptr.long(), col, w, x)
    with pytest.raises(ValueError):
        _check_launch_args(ptr, col, w, torch.ones(3, 3))
    with pytest.raises(ValueError):
        _check_launch_args(ptr, col, w, torch.ones(3, 2).T)
    with pytest.raises(ValueError):
        _check_launch_args(ptr, col, torch.ones(3), x)


def test_cache_propagation_matches(graphs):
    gj, gt = graphs
    cj = jops.cache_propagation(gj)
    ct = tops.cache_propagation(gt)
    for k in ("prop_x", "prop_s"):
        np.testing.assert_allclose(_np(ct.extras[k]), np.asarray(cj.extras[k]),
                                   rtol=RTOL, atol=ATOL)
