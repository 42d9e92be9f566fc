"""cogdl_tpu_torch on the card: K1 and K3 against their plain versions, the
autograd Functions, the dispatch rules and the main paths. Every test here needs an
NVIDIA card and skips without one. This file imports nothing of jax, so on a
machine without it run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.data.graph import add_self_loops, sym_norm
from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph, sbm_graph
from cogdl_tpu_torch.ops import spmm
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.ops.cuda import maybe_cuda_gat_fused
from cogdl_tpu_torch.ops.cuda.segment_kernels import (
    GATFusedFunction,
    SpMMFunction,
    gat_pass,
    gat_pass_reference,
    reset_launch_counts,
    spmm_csr,
    spmm_csr_reference,
)

# fp32, summation order only (rows of at most a few hundred edges here)
RTOL, ATOL = 1e-5, 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees no CUDA device")
    return torch.device("cuda", 0)


def _graph(dev, directed=True):
    g = (powerlaw_graph(500, avg_degree=8, feat_dim=16, num_classes=5, seed=1)
         if directed else sbm_graph(num_nodes=300, seed=1))
    return prepare_spmm(sym_norm(add_self_loops(g)).to(dev))


@pytest.mark.parametrize("feat", [1, 4, 47, 128, 130])
@pytest.mark.parametrize("direction", ["fw", "bw"])
def test_kernel_matches_plain_version(dev, feat, direction):
    ex = _graph(dev).extras
    ptr, col, w = (ex[f"spmm_{direction}_{k}"] for k in ("ptr", "col", "w"))
    x = torch.randn(ptr.numel() - 1, feat, device=dev)
    structure = "csr" if direction == "fw" else "csc"
    reset_launch_counts()
    out = spmm_csr(ptr, col, w, x, structure)
    torch.cuda.synchronize()
    assert spmm_csr.launches == 1
    assert dict(spmm_csr.launches_by) == {(structure, feat): 1}
    torch.testing.assert_close(out, spmm_csr_reference(ptr, col, w, x),
                               rtol=RTOL, atol=ATOL)


def test_kernel_scalar_path_on_unaligned_table(dev):
    ex = _graph(dev).extras
    n = ex["spmm_fw_ptr"].numel() - 1
    x = torch.randn(n * 8 + 1, device=dev)[1:].view(n, 8)  # 4-byte offset
    args = (ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_w"])
    torch.testing.assert_close(spmm_csr(*args, x),
                               spmm_csr_reference(*args, x), rtol=RTOL, atol=ATOL)


def test_kernel_is_deterministic(dev):
    ex = _graph(dev).extras
    args = (ex["spmm_bw_ptr"], ex["spmm_bw_col"], ex["spmm_bw_w"])
    x = torch.randn(args[0].numel() - 1, 47, device=dev)
    assert torch.equal(spmm_csr(*args, x), spmm_csr(*args, x))


def test_autograd_function_matches_plain_autograd(dev):
    ex = _graph(dev).extras
    keys = [ex[f"spmm_{d}_{k}"] for d in ("fw", "bw") for k in ("ptr", "col", "w")]
    n = keys[0].numel() - 1
    x = torch.randn(n, 47, device=dev, requires_grad=True)
    w = keys[2].clone().requires_grad_(True)
    probe = torch.randn(n, 47, device=dev)
    y = SpMMFunction.apply(x, keys[0], keys[1], w, *keys[3:])
    dx, dw = torch.autograd.grad((y * probe).sum(), (x, w))
    xr = x.detach().clone().requires_grad_(True)
    wr = keys[2].clone().requires_grad_(True)
    yr = spmm_csr_reference(keys[0], keys[1], wr, xr)
    dxr, dwr = torch.autograd.grad((yr * probe).sum(), (xr, wr))
    for a, b in ((y, yr), (dx, dxr), (dw, dwr)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_cuda_spmm_needs_the_kernel_structure(dev):
    g = sym_norm(add_self_loops(sbm_graph(num_nodes=100, seed=0))).to(dev)
    with pytest.raises(RuntimeError, match="prepare_spmm"):
        spmm(g, g.x)
    with pytest.raises(TypeError):
        ex = prepare_spmm(g).extras
        spmm_csr(ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_w"],
                 g.x.double())


def test_experiment_on_card_goes_through_kernel(dev):
    reset_launch_counts()
    res = experiment(dataset="sbm", model="gcn", epochs=100, seed=[0, 1],
                     patience=1000)
    (runs,) = res.values()
    assert min(r["test_acc"] for r in runs) >= 0.95
    # per seed: 4 launches per train step, 2 per evaluation (+ the final one)
    assert spmm_csr.launches == 2 * (4 * 100 + 2 * 101)
    # each layer: its forward over the CSR in every step and evaluation, its
    # backward over the CSC in every step (sbm: hidden 64, 4 classes)
    hidden, classes = 64, 4
    assert dict(spmm_csr.launches_by) == {
        ("csr", hidden): 2 * 201, ("csc", hidden): 2 * 100,
        ("csr", classes): 2 * 201, ("csc", classes): 2 * 100}


# K3: (H, D) at H·D = 1, 4, 47 and 128, the float4 route (D % 4 == 0) and
# the scalar one, more columns than one pass over the edges takes (H·D=150,
# a head across the pass boundary) and the most heads (32)
GAT_SHAPES = [(1, 1), (4, 1), (1, 4), (1, 47), (8, 16), (3, 50), (32, 2)]


def _gat_case(dev, H, D, seed=0):
    g = _graph(dev)
    n = g.n_pad
    gen = torch.Generator(device=dev).manual_seed(seed)
    h2 = torch.randn(n, H * D, generator=gen, device=dev)
    a_src = torch.randn(H, D, generator=gen, device=dev) / D ** 0.5
    ss = (h2.view(n, H, D) * a_src).sum(-1).contiguous()
    t = dict(sd=torch.randn(n, H, generator=gen, device=dev), ss=ss,
             smax=ss.amax(0).contiguous(), h2=h2,
             dagg=torch.randn(n, H * D, generator=gen, device=dev),
             dden=torch.randn(n, H, generator=gen, device=dev))
    return g, t


def _gat_args(g, t, mode):
    d = "bw" if mode == "dsrc" else "fw"
    ex = g.extras
    args = (mode, ex[f"spmm_{d}_ptr"], ex[f"spmm_{d}_col"], ex[f"spmm_{d}_orig"],
            t["sd"], t["ss"], t["smax"], t["h2"])
    return args + (() if mode == "fwd" else (t["dagg"], t["dden"]))


@pytest.mark.parametrize("attn_drop", [0.0, 0.6])
@pytest.mark.parametrize("H,D", GAT_SHAPES)
@pytest.mark.parametrize("mode", ["fwd", "dsd", "dsrc"])
def test_gat_kernel_matches_plain_version(dev, mode, H, D, attn_drop):
    g, t = _gat_case(dev, H, D)
    args = _gat_args(g, t, mode)
    kw = dict(alpha=0.2, attn_drop=attn_drop,
              seed=torch.tensor([77], device=dev), with_keep=True)
    reset_launch_counts()
    *outs, keep = gat_pass(*args, **kw)
    torch.cuda.synchronize()
    assert gat_pass.launches == 1
    assert dict(gat_pass.launches_by) == {(mode, H, D): 1}
    *refs, keep_ref = gat_pass_reference(*args, **kw)
    assert torch.equal(keep, keep_ref)
    for out, ref in zip(outs, refs):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_gat_kernel_is_deterministic(dev):
    g, t = _gat_case(dev, 8, 16)
    kw = dict(alpha=0.2, attn_drop=0.6, seed=torch.tensor([5], device=dev))
    for mode in ("fwd", "dsd", "dsrc"):
        a, b = gat_pass(*_gat_args(g, t, mode), **kw), gat_pass(
            *_gat_args(g, t, mode), **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_gat_autograd_function_matches_plain_version(dev):
    g, t = _gat_case(dev, 4, 8)
    ex = g.extras
    keys = [ex[f"spmm_{d}_{k}"] for d in ("fw", "bw") for k in ("ptr", "col", "orig")]
    seed = torch.tensor([3], device=dev)
    probe = torch.randn_like(t["h2"])
    grads = []
    for on_card in (True, False):
        ins = [t[k].clone().requires_grad_(True) for k in ("sd", "ss", "h2")]
        if on_card:
            out = GATFusedFunction.apply(*ins, *keys, seed, 0.2, 0.5)
        else:
            ins = [x.cpu().detach().requires_grad_(True) for x in ins]
            out = GATFusedFunction.apply(*ins, *(k.cpu() for k in keys),
                                         seed.cpu(), 0.2, 0.5)
        (out * probe.to(out.device)).sum().backward()
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in ins])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_cuda_gat_needs_the_kernel_structure(dev):
    g = add_self_loops(sbm_graph(num_nodes=100, seed=0)).to(dev)
    h = torch.zeros(g.n_pad, 2, 3, device=dev)
    s = torch.zeros(g.n_pad, 2, device=dev)
    with pytest.raises(RuntimeError, match="prepare_spmm"):
        maybe_cuda_gat_fused(g, s, s, h)
    _, t = _gat_case(dev, 2, 3)
    with pytest.raises(TypeError):
        gat_pass(*_gat_args(_graph(dev), {**t, "sd": t["sd"].double()}, "fwd"),
                 alpha=0.2)


def test_gat_experiment_on_card_goes_through_kernel(dev):
    reset_launch_counts()
    res = experiment(dataset="sbm", model="gat", epochs=100, seed=[0, 1],
                     patience=1000)
    (runs,) = res.values()
    assert min(r["test_acc"] for r in runs) >= 0.95
    # per seed and layer: fwd in every step and evaluation (+ the final
    # one), dsd and dsrc in every step (sbm: 8 heads of 8, then 1 of 4)
    by = dict(gat_pass.launches_by)
    assert by == {(m, h, d): 2 * (201 if m == "fwd" else 100)
                  for m in ("fwd", "dsd", "dsrc") for h, d in ((8, 8), (1, 4))}
    assert spmm_csr.launches == 0
