"""cogdl_tpu_torch on the card: K1-K6 against their plain versions, the
autograd Functions, the dispatch rules and the main paths. Every test
here needs an NVIDIA card and skips without one. This file imports nothing of jax, so on a
machine without it run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import copy
import math

import pytest
import torch

from cogdl_tpu_torch import bench, experiment
from cogdl_tpu_torch.data.graph import add_self_loops, sym_norm
from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph, sbm_graph
from cogdl_tpu_torch.ops import spmm
from cogdl_tpu_torch.ops.cuda import prepare_spmm, prepare_spmm_device
from cogdl_tpu_torch.ops.cuda import maybe_cuda_gat_fused
from cogdl_tpu_torch.ops.cuda import gather_kernels as gk
from cogdl_tpu_torch.ops.cuda.gather_kernels import (
    gather_block_sum,
    gather_block_sum_reference,
    gather_rows_sum,
    gather_rows_sum_reference,
    gather_window_sum,
    gather_window_sum_reference,
    window_plan,
    window_rows,
)
from cogdl_tpu_torch.ops.cuda.segment_kernels import (
    GATFusedFunction,
    SpMMFunction,
    SpMMPanelFunction,
    gat_output_widths,
    gat_pass,
    gat_pass_reference,
    reset_launch_counts,
    spmm_csr,
    spmm_csr_accum,
    spmm_csr_accum_reference,
    spmm_csr_reference,
)
from cogdl_tpu_torch.scripts import microbench_gather

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


# F=64 and 192: GCNII's and DrGCN's hidden width, MixHop's 3 powers x 64
@pytest.mark.parametrize("feat", [1, 4, 47, 128, 130, 64, 192])
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
# the scalar one, more columns than one pass of the chunk kernel takes
# (H·D=150, a head across the pass boundary), the most heads of the
# row-a-warp kernel (32), heads in two passes of 32 (64) and the most
# (128); DrGAT's 8 heads of 8
GAT_SHAPES = [(1, 1), (4, 1), (1, 4), (1, 47), (8, 16), (3, 50), (32, 2),
              (64, 4), (128, 1), (8, 8)]


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


# -- the products-scale slice: K2 and K3's accumulating form over panels ----

PANELS = 4


def _panel_graph(dev, with_orig=False, directed=True):
    g = _graph(dev, directed)
    return prepare_spmm_device(g, symmetric=not directed, with_orig=with_orig,
                               panel_rows=-(-g.n_pad // PANELS), store_w=True)


@pytest.mark.parametrize("feat", [1, 4, 47, 128, 130])
@pytest.mark.parametrize("direction", ["fw", "bw"])
def test_accum_kernel_matches_plain_version(dev, feat, direction):
    ex = _panel_graph(dev).extras
    ptrs, col, w = (ex[f"spmm_{direction}_{k}"] for k in ("ptr", "col", "w"))
    assert ptrs.shape[0] == PANELS
    n = ptrs.shape[1] - 1
    x = torch.randn(n, feat, device=dev)
    acc = torch.randn(n, feat, device=dev)
    ref = acc.clone()
    structure = "csr" if direction == "fw" else "csc"
    reset_launch_counts()
    for ptr in ptrs:
        before = acc.clone()
        assert spmm_csr_accum(acc, ptr, col, w, x, structure) is acc
        untouched = ptr[1:] == ptr[:-1]
        assert torch.equal(acc[untouched], before[untouched])
        spmm_csr_accum_reference(ref, ptr, col, w, x)
    torch.cuda.synchronize()
    assert spmm_csr_accum.launches == PANELS and spmm_csr.launches == 0
    assert dict(spmm_csr_accum.launches_by) == {(structure, feat): PANELS}
    torch.testing.assert_close(acc, ref, rtol=RTOL, atol=ATOL)


def test_accum_kernel_scalar_path_and_determinism(dev):
    ex = _panel_graph(dev).extras
    ptrs, col, w = (ex[f"spmm_bw_{k}"] for k in ("ptr", "col", "w"))
    n = ptrs.shape[1] - 1
    x = torch.randn(n * 8 + 1, device=dev)[1:].view(n, 8)   # 4-byte offset
    outs = []
    for _ in range(2):
        acc = torch.zeros(n, 8, device=dev)
        for ptr in ptrs:
            spmm_csr_accum(acc, ptr, col, w, x)
        outs.append(acc)
    assert torch.equal(*outs)
    one = prepare_spmm(_graph(dev)).extras
    torch.testing.assert_close(
        outs[0], spmm_csr_reference(one["spmm_bw_ptr"], one["spmm_bw_col"],
                                    one["spmm_bw_w"], x), rtol=RTOL, atol=ATOL)


def test_accum_kernel_refuses_what_it_does_not_take(dev):
    ex = _panel_graph(dev).extras
    args = (ex["spmm_fw_ptr"][0], ex["spmm_fw_col"], ex["spmm_fw_w"])
    n = args[0].numel() - 1
    x = torch.randn(n, 8, device=dev)
    with pytest.raises(ValueError, match="acc must be"):
        spmm_csr_accum(torch.zeros(n, 4, device=dev), *args, x)
    with pytest.raises(TypeError):
        spmm_csr_accum(torch.zeros(n, 8, device=dev).double(), *args, x)
    with pytest.raises(ValueError, match="acc is on"):
        spmm_csr_accum(torch.zeros(n, 8), *args, x)


def test_panel_function_matches_the_cpu_run(dev):
    ex = _panel_graph(dev).extras
    keys = [ex[f"spmm_{d}_{k}"] for d in ("fw", "bw") for k in ("ptr", "col", "w")]
    n = keys[0].shape[1] - 1
    x0, probe = torch.randn(n, 47), torch.randn(n, 47)
    res = []
    for d in (dev, torch.device("cpu")):
        x = x0.to(d).requires_grad_(True)
        w = keys[2].to(d).clone().requires_grad_(True)
        ks = [k.to(d) for k in keys]
        y = SpMMPanelFunction.apply(x, ks[0], ks[1], w, *ks[3:])
        dx, dw = torch.autograd.grad((y * probe.to(d)).sum(), (x, w))
        res.append([t.detach().cpu() for t in (y, dx, dw)])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_cuda_spmm_on_a_gat_structure_needs_weights(dev):
    g = _graph(dev, directed=False)
    g = prepare_spmm_device(g, symmetric=True, with_orig=True,
                            panel_rows=-(-g.n_pad // PANELS))
    with pytest.raises(RuntimeError, match="store_w=True"):
        spmm(g, g.x)


@pytest.mark.parametrize("attn_drop", [0.0, 0.6])
@pytest.mark.parametrize("H,D", [(1, 4), (1, 47), (8, 16), (3, 50), (32, 2)])
@pytest.mark.parametrize("mode", ["fwd", "dsd", "dsrc"])
def test_gat_accum_kernel_matches_plain_version(dev, mode, H, D, attn_drop):
    g, t = _gat_case(dev, H, D)
    ex = _panel_graph(dev, with_orig=True).extras
    d = "bw" if mode == "dsrc" else "fw"
    ptrs, idx = ex[f"spmm_{d}_ptr"], ex[f"spmm_{d}_col"]
    n = g.n_pad
    acc = tuple(torch.randn(n, w, device=dev)
                for w in gat_output_widths(mode, H, H * D))
    ref = tuple(a.clone() for a in acc)
    back = () if mode == "fwd" else (t["dagg"], t["dden"])
    kw = dict(alpha=0.2, attn_drop=attn_drop,
              seed=torch.tensor([77], device=dev), with_keep=True,
              coord_key=True)
    reset_launch_counts()
    for ptr in ptrs:
        before = [a.clone() for a in acc]
        *outs, keep = gat_pass(mode, ptr, idx, None, t["sd"], t["ss"],
                               t["smax"], t["h2"], *back, acc=acc, **kw)
        assert all(o is a for o, a in zip(outs, acc))
        untouched = ptr[1:] == ptr[:-1]
        assert all(torch.equal(a[untouched], b[untouched])
                   for a, b in zip(acc, before))
        *_, keep_ref = gat_pass_reference(mode, ptr, idx, None, t["sd"],
                                          t["ss"], t["smax"], t["h2"], *back,
                                          acc=ref, **kw)
        assert torch.equal(keep, keep_ref)
    torch.cuda.synchronize()
    assert dict(gat_pass.launches_by) == {(mode, H, D): PANELS}
    for a, r in zip(acc, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


def test_gat_panel_function_matches_the_cpu_run_and_the_single_shot(dev):
    g, t = _gat_case(dev, 4, 8)
    ex = _panel_graph(dev, with_orig=True).extras
    keys = [ex.get(f"spmm_{d}_{k}") for d in ("fw", "bw")
            for k in ("ptr", "col", "orig")]
    assert keys[2] is None and keys[5] is None and keys[0].ndim == 2
    seed = torch.tensor([3], device=dev)
    probe = torch.randn_like(t["h2"])
    grads = []
    for d in (dev, torch.device("cpu")):
        ins = [t[k].to(d).clone().requires_grad_(True)
               for k in ("sd", "ss", "h2")]
        out = GATFusedFunction.apply(
            *ins, *(k if k is None else k.to(d) for k in keys), seed.to(d),
            0.2, 0.5)
        (out * probe.to(d)).sum().backward()
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in ins])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    # without dropout the panel route equals the single-shot route
    one = g.extras
    single = [one[f"spmm_{d}_{k}"] for d in ("fw", "bw")
              for k in ("ptr", "col", "orig")]
    ins = [t[k] for k in ("sd", "ss", "h2")]
    torch.testing.assert_close(
        GATFusedFunction.apply(*ins, *keys, None, 0.2, 0.0),
        GATFusedFunction.apply(*ins, *single, None, 0.2, 0.0),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_bench_blocked_on_card_goes_through_the_panel_kernels(dev, model,
                                                              capsys):
    reset_launch_counts()
    p = bench.main(["--model", model, "--nodes", "20000", "--blocked",
                    "--panel-rows", "5120", "--attn-drop", "0.6", "--steps",
                    "2", "--warmup", "1", "--repeats", "1"])
    assert p["blocked_layout"] and p["panel_rows"] == 5120
    assert p["peak_hbm_bytes"] > 0 and p["device"] != "cpu"
    assert spmm_csr.launches == 0
    if model == "gcn":
        # 4 panels; cache set-up 2 sweeps, 3 cached steps of 2 sweeps, 3
        # uncached steps of 4
        assert spmm_csr_accum.launches == 4 * (2 + 3 * 2 + 3 * 4)
        assert gat_pass.launches == 0
    else:
        assert gat_pass.launches == 4 * 3 * 6
        assert spmm_csr_accum.launches == 0


# ---------------------------------------------------------------------------
# K4, K5, K6: the gather probes
# ---------------------------------------------------------------------------

GATHER_ROWS = 8192


def _gather_case(dev, n_idx, hi, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(GATHER_ROWS, 128, generator=gen, device=dev)
    idx = torch.randint(0, hi, (n_idx,), generator=gen, device=dev,
                        dtype=torch.int32)
    return table, idx


def _close_per_chunk(out, ref, table, rows, n_chunks):
    """Within 1e-6 + 1e-5·Σ|terms| a chunk: fp32, summation order only."""
    scale = table.abs()[rows].reshape(n_chunks, -1).sum(1)
    assert float(((out - ref).abs() / (1e-6 + 1e-5 * scale)).max()) <= 1.0


@pytest.mark.parametrize("n_chunks", [1, 3, 13])
@pytest.mark.parametrize("chunk", [1024, 1000, 96, 7])
def test_gather_block_kernel_matches_plain_version(dev, chunk, n_chunks):
    table, idx = _gather_case(dev, chunk * n_chunks, chunk, seed=chunk)
    reset_launch_counts()
    out = gather_block_sum(table, idx, chunk)
    torch.cuda.synchronize()
    assert gather_block_sum.launches == 1
    assert dict(gather_block_sum.launches_by) == {chunk: 1}
    assert out.shape == (n_chunks,)
    _close_per_chunk(out, gather_block_sum_reference(table, idx, chunk),
                     table, window_rows(idx, GATHER_ROWS, chunk, chunk),
                     n_chunks)


@pytest.mark.parametrize("n_chunks", [1, 5, 37])
@pytest.mark.parametrize("window", [256, 512, 1024, 4096, 90, 3])
def test_gather_window_kernel_matches_plain_version(dev, window, n_chunks):
    table, idx = _gather_case(dev, 1024 * n_chunks, window, seed=window)
    reset_launch_counts()
    out = gather_window_sum(table, idx, window)
    torch.cuda.synchronize()
    assert dict(gather_window_sum.launches_by) == {window: 1}
    _close_per_chunk(out, gather_window_sum_reference(table, idx, window),
                     table, window_rows(idx, GATHER_ROWS, window), n_chunks)


def test_gather_window_kernel_takes_short_chunks(dev):
    table, idx = _gather_case(dev, 50 * 9, 512)
    out = gather_window_sum(table, idx, 512, chunk=50)
    _close_per_chunk(out, gather_window_sum_reference(table, idx, 512, 50),
                     table, window_rows(idx, GATHER_ROWS, 512, 50), 9)


@pytest.mark.parametrize("n_chunks", [1, 3, 11])
@pytest.mark.parametrize("chunk", [1024, 100, 5])
@pytest.mark.parametrize("outstanding", [1, 2, 4, 8])
def test_gather_rows_kernel_matches_plain_version(dev, outstanding, chunk,
                                                  n_chunks):
    table, idx = _gather_case(dev, chunk * n_chunks, GATHER_ROWS,
                              seed=outstanding)
    reset_launch_counts()
    out = gather_rows_sum(table, idx, chunk, outstanding)
    torch.cuda.synchronize()
    assert dict(gather_rows_sum.launches_by) == {outstanding: 1}
    _close_per_chunk(out, gather_rows_sum_reference(table, idx, chunk), table,
                     idx.long(), n_chunks)


@pytest.mark.parametrize("outstanding", [1, 2, 4, 8])
@pytest.mark.parametrize("chunk,n_chunks", [(1024, 192), (1024, 3),
                                            (4096, 5), (31, 400), (1, 7),
                                            (1000, 133)])
def test_gather_rows_ranges_match_plain_and_repeat_bit_for_bit(
        dev, outstanding, chunk, n_chunks):
    """K6's work by slot range: chunks cut into runs that warps' ranges
    cross (few long chunks), whole chunks a warp (many short ones); the
    segment-order plain version agrees, and a second call gives the same
    bits."""
    table, idx = _gather_case(dev, chunk * n_chunks, GATHER_ROWS + 5,
                              seed=chunk + outstanding)
    out = gather_rows_sum(table, idx, chunk, outstanding)
    grid, segments = gather_rows_sum.plan
    assert gather_rows_sum.kernel == "rows_ranges"
    assert gather_rows_sum.cuda_kernels == (1 if segments == 1 else 2)
    n_sms, fit = gk.rows_occupancy(dev.index or 0, outstanding)
    assert fit >= 1
    assert (grid, segments) == gk.rows_plan(
        n_chunks, chunk, n_sms, min(fit, gk.ROWS_BLOCKS_PER_SM))
    assert torch.equal(out, gather_rows_sum(table, idx, chunk, outstanding))
    torch.cuda.synchronize()
    rows = idx.long().clamp(0, GATHER_ROWS - 1)
    _close_per_chunk(out, gather_rows_sum_reference(table, idx, chunk),
                     table, rows, n_chunks)
    _close_per_chunk(out, gk.gather_rows_sum_segmented_reference(
        table, idx, chunk, segments), table, rows, n_chunks)


def test_gather_rows_fill_the_card_at_the_probe_size(dev):
    """Stage D's cut: ROWS_BLOCKS_PER_SM blocks on every SM at depth 8
    (more fit), every warp one run of at most 64 slots."""
    n_sms, fit = gk.rows_occupancy(dev.index or 0, 8)
    assert n_sms == torch.cuda.get_device_properties(dev).multi_processor_count
    assert fit >= gk.ROWS_BLOCKS_PER_SM
    table, idx = _gather_case(dev, 192 * 1024, GATHER_ROWS)
    out = gather_rows_sum(table, idx)
    grid, segments = gather_rows_sum.plan
    assert grid == n_sms * gk.ROWS_BLOCKS_PER_SM
    assert max(hi - lo for lo, hi in gk.rows_warp_slots(
        192, 1024, grid, segments)) <= 64
    _close_per_chunk(out, gather_rows_sum_reference(table, idx, 1024),
                     table, idx.long(), 192)


def test_gather_kernels_are_deterministic_and_agree_where_they_overlap(dev):
    table, idx = _gather_case(dev, 1024 * 6, 1024)
    a = gather_block_sum(table, idx)
    assert torch.equal(a, gather_block_sum(table, idx))
    b = gather_window_sum(table, idx, 1024)
    assert torch.equal(b, gather_window_sum(table, idx, 1024))
    rows = window_rows(idx, GATHER_ROWS, 1024)
    c = gather_rows_sum(table, rows.int(), 1024)
    assert torch.equal(c, gather_rows_sum(table, rows.int(), 1024))
    # three kernels, one function on these inputs
    _close_per_chunk(b, a, table, rows, 6)
    _close_per_chunk(c, a, table, rows, 6)


def test_gather_kernels_clamp_out_of_range_indices(dev):
    table, idx = _gather_case(dev, 2048, 256)
    wild = idx.clone()
    wild[::5] = -3
    wild[1::5] = 10 ** 6
    for call, hi in ((lambda i: gather_block_sum(table, i), 1024),
                     (lambda i: gather_window_sum(table, i, 256), 256),
                     (lambda i: gather_rows_sum(table, i), GATHER_ROWS)):
        assert torch.equal(call(wild), call(wild.clamp(0, hi - 1)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("window,tile_cols",
                         [(w, tc) for w in (1, 32, 90, 256, 512, 1024, 4096)
                          for tc in (8, 16, 32, 64, 128)
                          if w * tc * 4 <= 232_448])
@pytest.mark.parametrize("chunk,n_chunks", [(1024, 3), (31, 40), (1, 7),
                                            (4096, 2)])
def test_gather_window_tiles_match_plain_and_repeat_bit_for_bit(
        dev, window, tile_cols, chunk, n_chunks):
    table, idx = _gather_case(dev, chunk * n_chunks, window, seed=window)
    out = gather_window_sum(table, idx, window, chunk, tile_cols=tile_cols)
    per_call = gather_window_sum.cuda_kernels
    assert torch.equal(out, gather_window_sum(table, idx, window, chunk,
                                              tile_cols=tile_cols))
    torch.cuda.synchronize()
    assert gather_window_sum.kernel == "window_tiles"
    _, segments = window_plan(GATHER_ROWS, n_chunks, window, chunk, tile_cols)
    assert per_call == (1 if 128 // tile_cols * segments == 1 else 2)
    _close_per_chunk(out, gather_window_sum_reference(table, idx, window,
                                                      chunk),
                     table, window_rows(idx, GATHER_ROWS, window, chunk),
                     n_chunks)


@pytest.mark.parametrize("max_l1", [True, False])
@pytest.mark.parametrize("chunk,n_chunks", [(1024, 20), (31, 300), (1, 9),
                                            (4096, 3)])
def test_gather_block_quarters_match_plain_and_repeat_bit_for_bit(
        dev, max_l1, chunk, n_chunks):
    table, idx = _gather_case(dev, chunk * n_chunks, chunk, seed=chunk)
    out = gather_block_sum(table, idx, chunk, max_l1=max_l1)
    assert gather_block_sum.cuda_kernels == 2
    assert gather_block_sum.kernel == "block_quarters"
    assert torch.equal(out, gather_block_sum(table, idx, chunk,
                                             max_l1=max_l1))
    torch.cuda.synchronize()
    _close_per_chunk(out, gather_block_sum_reference(table, idx, chunk),
                     table, window_rows(idx, GATHER_ROWS, chunk, chunk),
                     n_chunks)


def test_gather_occupancy_is_reported(dev):
    from cogdl_tpu_torch.ops.cuda.gather_kernels import blocks_per_sm
    assert blocks_per_sm("window", 1024, 32) >= 1   # 128 KB: one a SM
    assert blocks_per_sm("window", 1024, 8) > blocks_per_sm("window", 1024,
                                                            32)
    assert blocks_per_sm("block") in (1, 2)


def test_gather_wrappers_refuse_on_the_card(dev):
    table, idx = _gather_case(dev, 2048, 256)
    with pytest.raises(TypeError):
        gather_block_sum(table.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather_window_sum(table.T.contiguous().T, idx, 256)
    with pytest.raises(ValueError, match="16-byte"):
        gather_rows_sum(torch.randn(GATHER_ROWS * 128 + 1, device=dev)[1:]
                        .view(GATHER_ROWS, 128), idx)
    with pytest.raises(ValueError, match="window"):
        gather_window_sum(table, idx, 8192, chunk=1024)
    with pytest.raises(ValueError, match="chunk"):
        gather_rows_sum(table, torch.cat([idx] * 4), chunk=8192)
    with pytest.raises(ValueError, match="on cpu"):
        gather_block_sum(table, idx.cpu())


@pytest.mark.parametrize("chunk,segments", [(10, 6), (10, 11), (10, 0),
                                            (4097, 1)])
def test_rows_entry_point_refuses_a_cut_with_an_empty_run(dev, chunk,
                                                          segments):
    """K6's C entry point returns cudaErrorInvalidValue (1) for a cut it
    would sum wrong or not at all: a run left empty (10 slots in 6 runs of
    2), more runs than slots, none, or a chunk past the limit; the output
    stays as it was."""
    import ctypes
    table, idx = _gather_case(dev, chunk * 3, GATHER_ROWS)
    out = torch.full((3,), 7.0, device=dev)
    part = torch.empty(3 * max(segments, 1), device=dev)
    started = ctypes.c_int(5)
    err = gk._library().gather_rows_sum_f32(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), part.data_ptr(),
        GATHER_ROWS, 3, chunk, segments, 4, 8, ctypes.byref(started),
        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 1 and started.value == 0
    assert torch.equal(out, torch.full((3,), 7.0, device=dev))


def test_probe_script_on_card_launches_each_stage_kernel(dev):
    for stage in microbench_gather.STAGES:
        reset_launch_counts()
        rep = microbench_gather.run(stage, rows=8192, gathered=16384,
                                    iters=2, warmup=1)
        mine, key = microbench_gather.stage_case(stage)[4:]
        for fn in (gather_block_sum, gather_window_sum, gather_rows_sum):
            assert dict(fn.launches_by) == (
                {key: rep["calls"]} if fn is mine else {})
        assert spmm_csr.launches == 0 and rep["calls"] == 4


def test_graphsage_on_card_sum_goes_through_k1_and_mean_through_none(dev):
    for aggr, want in (("mean", 0), ("sum", 2 * (3 * 20 + 2 * 21))):
        reset_launch_counts()
        res = experiment(dataset="sbm", model="graphsage", aggr=aggr,
                         epochs=20, seed=[0, 1], patience=1000)
        (runs,) = res.values()
        assert all(math.isfinite(r["train_loss"]) for r in runs)
        assert spmm_csr.launches == want
        assert gat_pass.launches == spmm_csr_accum.launches == 0


# -- K1 and K2 by edge chunks: the structures that sit on the schedule's edges

import chip_smoke  # noqa: E402  (the adversarial structures; imports no jax)
from cogdl_tpu_torch.ops.cuda.segment_kernels import (  # noqa: E402
    K1_KERNELS,
)
from cogdl_tpu_torch.ops.cuda import (  # noqa: E402
    CHUNK_EDGES,
    SCHEDULE_KEYS,
    SpmmSchedule,
    build_spmm_schedule,
    build_spmm_structure,
)

ADVERSARIAL = ("star", "mixed_rows", "no_edge", "middle_third_unnamed",
               "powerlaw", "host_block")


def _adversarial(dev, name, direction, panel_rows=0):
    """One adversarial structure of chip_smoke.py over CSR(A) (``fw``) or
    CSR(Aᵀ), its weights from a seed, and its schedule."""
    found = {n: rest for n, *rest in chip_smoke.adversarial_structures(dev)}
    assert tuple(found) == ADVERSARIAL
    row, col, n = found[name]
    if direction == "bw":
        row, col = col, row
    w = torch.randn(row.numel(), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    st = build_spmm_structure(row, col, w, n, panel_rows)
    return st, SpmmSchedule(*(st[k] for k in SCHEDULE_KEYS)), n


def _within_terms(out, ref, scale):
    """fp32, summation order only, against Σ|terms| as on the card run: a
    star row sums thousands of terms that cancel."""
    return chip_smoke.scaled_err(out, ref, scale) <= 1.0


@pytest.mark.parametrize("feat", [128, 47, 100])
@pytest.mark.parametrize("direction", ["fw", "bw"])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_k1_on_adversarial_structures(dev, name, direction, feat):
    st, sched, n = _adversarial(dev, name, direction)
    x = torch.randn(n, feat, device=dev)
    args = (st["ptr"], st["col"], st["w"], x)
    ref = spmm_csr_reference(*args)
    scale = spmm_csr_reference(st["ptr"], st["col"], st["w"].abs(), x.abs())
    out = spmm_csr(*args, schedule=sched)
    torch.cuda.synchronize()
    assert _within_terms(out, ref, scale)
    for kernel in K1_KERNELS:
        named = spmm_csr(*args, schedule=sched, kernel=kernel)
        assert spmm_csr.kernel == kernel
        assert _within_terms(named, ref, scale)
        assert torch.equal(named, spmm_csr(*args, schedule=sched,
                                           kernel=kernel))
    # a second call, and the schedule the wrapper builds itself: the same bits
    assert torch.equal(out, spmm_csr(*args, schedule=sched))
    assert torch.equal(out, spmm_csr(*args))
    # rows without an edge are written as zeros by both kernels
    empty = st["ptr"][1:] == st["ptr"][:-1]
    for kernel in K1_KERNELS:
        # poison the allocator's next block: the output is torch.empty
        del out
        torch.full_like(x, float("nan"))
        out = spmm_csr(*args, schedule=sched, kernel=kernel)
        assert (out[empty] == 0).all()


@pytest.mark.parametrize("feat", [128, 47, 100])
@pytest.mark.parametrize("direction", ["fw", "bw"])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_k2_on_adversarial_structures(dev, name, direction, feat):
    st, sched, n = _adversarial(dev, name, direction, panel_rows=n_third(dev))
    assert st["ptr"].shape[0] == 3
    x = torch.randn(n, feat, device=dev)
    acc0 = torch.randn(n, feat, device=dev)
    runs = []
    for prepared in (True, True, False):
        acc, ref, scale = acc0.clone(), acc0.clone(), acc0.abs()
        for p, ptr in enumerate(st["ptr"]):
            untouched = ptr[1:] == ptr[:-1]
            before = acc[untouched].clone()
            spmm_csr_accum(acc, ptr, st["col"], st["w"], x,
                           schedule=sched.panel(p) if prepared else None)
            assert torch.equal(acc[untouched], before)
            spmm_csr_accum_reference(ref, ptr, st["col"], st["w"], x)
            spmm_csr_accum_reference(scale, ptr, st["col"], st["w"].abs(),
                                     x.abs())
        torch.cuda.synchronize()
        assert _within_terms(acc, ref, scale)
        runs.append(acc)
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def n_third(dev):
    """A panel height that cuts the adversarial structures into three."""
    return chip_smoke.adversarial_structures(dev)[0][3] // 3


def test_k1_chooses_its_kernel_by_the_longest_row(dev):
    """No row longer than a chunk: one CUDA kernel, the row-a-warp one. A
    star: the chunk kernel and the kernel that adds the cut row's pieces."""
    for name, kernels in (("mixed_rows", 2), ("star", 2), ("no_edge", 1)):
        st, sched, n = _adversarial(dev, name, "fw")
        x = torch.randn(n, 8, device=dev)
        spmm_csr(st["ptr"], st["col"], st["w"], x, schedule=sched)
        assert spmm_csr.cuda_kernels == kernels
        assert (sched.cross.shape[0] > 0) == (kernels == 2)
    short, sched, n = _adversarial(dev, "powerlaw", "fw")
    if sched.cross.shape[0] == 0:
        spmm_csr(short["ptr"], short["col"], short["w"],
                 torch.randn(n, 8, device=dev), schedule=sched)
        assert spmm_csr.cuda_kernels == 1


@pytest.mark.parametrize("feat,passes", [(128, 1), (47, 1), (33, 1), (8, 1),
                                         (64, 1), (130, 3), (260, 2),
                                         (520, 3)])
def test_chunk_kernel_takes_wide_tables_in_passes(dev, feat, passes):
    """One pass covers 64 elements a row at most (float4 where F % 4 == 0:
    256 columns; else floats: 64 columns); K1 on a star starts one kernel a
    pass and one for the cut row."""
    st, sched, n = _adversarial(dev, "star", "fw")
    x = torch.randn(n, feat, device=dev)
    args = (st["ptr"], st["col"], st["w"], x)
    out = spmm_csr(*args, schedule=sched, kernel="chunks")
    assert spmm_csr.cuda_kernels == passes + 1
    scale = spmm_csr_reference(st["ptr"], st["col"], st["w"].abs(), x.abs())
    assert _within_terms(out, spmm_csr_reference(*args), scale)
    acc = torch.ones(n, feat, device=dev)
    spmm_csr_accum(acc, *args, schedule=sched)
    assert spmm_csr_accum.cuda_kernels == passes + 1
    assert _within_terms(acc - 1, spmm_csr_reference(*args), 1 + scale)


@pytest.mark.parametrize("chunk", [32, 64, 256])
def test_kernels_at_other_chunk_sizes(dev, chunk):
    ex = _graph(dev).extras
    ptr, col, w = (ex[f"spmm_bw_{k}"] for k in ("ptr", "col", "w"))
    sched = build_spmm_schedule(ptr, chunk, ex["spmm_bw_erow"])
    x = torch.randn(ptr.numel() - 1, 47, device=dev)
    out = spmm_csr(ptr, col, w, x, "csc", schedule=sched, kernel="chunks")
    torch.testing.assert_close(out, spmm_csr_reference(ptr, col, w, x),
                               rtol=RTOL, atol=ATOL)
    assert CHUNK_EDGES == 128


def test_functions_on_a_star_match_plain_autograd(dev):
    """The hub row in the forward, the hub column in the backward, through
    SpMMFunction (K1) and SpMMPanelFunction (K2) with prepared schedules."""
    for panel_rows in (0, n_third(dev)):
        fw, fs, n = _adversarial(dev, "star", "fw", panel_rows)
        fn = SpMMPanelFunction if panel_rows else SpMMFunction
        x = torch.randn(n, 47, device=dev, requires_grad=True)
        probe = torch.randn(n, 47, device=dev)
        # the transpose holds the same weights in another order: rebuild them
        # from the forward's so that both directions are one matrix
        ptrs = fw["ptr"] if panel_rows else fw["ptr"][None]
        row = torch.cat([torch.repeat_interleave(
            torch.arange(n, device=dev), (p[1:] - p[:-1]).long())
            for p in ptrs])
        col = fw["col"].long()
        t = build_spmm_structure(col, row, fw["w"], n, panel_rows)
        ts = SpmmSchedule(*(t[k] for k in SCHEDULE_KEYS))
        y = fn.apply(x, fw["ptr"], fw["col"], fw["w"], t["ptr"], t["col"],
                     t["w"], fs, ts)
        (dx,) = torch.autograd.grad((y * probe).sum(), x)
        xr = x.detach().clone().requires_grad_(True)
        yr = torch.zeros_like(xr).index_add(0, row,
                                            xr[col] * fw["w"][:, None])
        (dxr,) = torch.autograd.grad((yr * probe).sum(), xr)
        xa, wa, pa = x.detach().abs(), fw["w"].abs(), probe.abs()
        assert _within_terms(y, yr, torch.zeros_like(xa).index_add(
            0, row, xa[col] * wa[:, None]))
        assert _within_terms(dx, dxr, torch.zeros_like(xa).index_add(
            0, col, pa[row] * wa[:, None]))


def test_wrappers_refuse_a_schedule_of_another_structure(dev):
    st, sched, n = _adversarial(dev, "star", "fw")
    x = torch.randn(n, 8, device=dev)
    args = (st["ptr"], st["col"], st["w"], x)
    with pytest.raises(ValueError, match="schedule.erow has"):
        spmm_csr(*args, schedule=sched._replace(erow=sched.erow[:-1]))
    with pytest.raises(ValueError, match="schedule.cross is on"):
        spmm_csr_accum(torch.zeros_like(x), *args,
                       schedule=sched._replace(cross=sched.cross.cpu()))
    with pytest.raises(ValueError, match="kernel must be one of"):
        spmm_csr(*args, schedule=sched, kernel="columns")


# -- rows that start on no 16-byte boundary, and the compact scratch

@pytest.mark.parametrize("feat", [1, 2, 3, 5, 33, 101, 125])
@pytest.mark.parametrize("direction", ["fw", "bw"])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_chunk_kernel_at_widths_four_does_not_divide(dev, name, direction,
                                                     feat):
    """K1's and K2's chunk kernel at widths from one float up, one or two
    columns a lane and more than one pass: within tolerance of the plain
    versions, two calls the same bits, rows without an edge zero (K1) or
    untouched (K2)."""
    st, sched, n = _adversarial(dev, name, direction)
    x = torch.randn(n, feat, device=dev)
    args = (st["ptr"], st["col"], st["w"], x)
    ref = spmm_csr_reference(*args)
    scale = spmm_csr_reference(st["ptr"], st["col"], st["w"].abs(), x.abs())
    torch.full_like(x, float("nan"))       # poison the next torch.empty
    out = spmm_csr(*args, schedule=sched, kernel="chunks")
    assert spmm_csr.kernel == "chunks"
    assert _within_terms(out, ref, scale)
    assert torch.equal(out, spmm_csr(*args, schedule=sched, kernel="chunks"))
    empty = st["ptr"][1:] == st["ptr"][:-1]
    assert (out[empty] == 0).all()
    acc0 = torch.randn(n, feat, device=dev)
    accs = [spmm_csr_accum(acc0.clone(), *args, schedule=sched)
            for _ in range(2)]
    assert _within_terms(accs[0], acc0 + ref, acc0.abs() + scale)
    assert torch.equal(*accs)
    assert torch.equal(accs[0][empty], acc0[empty])


@pytest.mark.parametrize("feat", [128, 47])
def test_scratch_is_written_only_inside_its_pieces(dev, feat):
    """Many cut rows between short ones over three panels: the scratch has a
    row for every piece and no other, so a slot computed wrongly shows as a
    wrong sum here."""
    t = CHUNK_EDGES
    lens = torch.tensor(
        [3, 2 * t + 1, 0, t + 1, 5, 7 * t, t, 1, 3 * t + 9] * 6, device=dev)
    n = 3 * 64
    row = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens)
    col = torch.randint(0, n, (row.numel(),), device=dev)
    w = torch.randn(row.numel(), device=dev)
    x = torch.randn(n, feat, device=dev)
    for panel_rows in (0, 64):
        st = build_spmm_structure(row, col, w, n, panel_rows)
        sched = SpmmSchedule(*(st[k] for k in SCHEDULE_KEYS))
        slots = sched.piece_row.shape[-1]
        assert slots == int(sched.piece_start[..., -1].max())
        # at most one piece a chunk and one more a cut row
        assert slots <= (sched.chunk_start.shape[-1] - 1
                         + sched.cross.shape[-2])
        ptrs = st["ptr"] if panel_rows else st["ptr"][None]
        acc, ref, scale = (torch.zeros_like(x) for _ in range(3))
        for p, ptr in enumerate(ptrs):
            spmm_csr_accum(acc, ptr, st["col"], st["w"], x,
                           schedule=sched.panel(p) if panel_rows else sched)
            spmm_csr_accum_reference(ref, ptr, st["col"], st["w"], x)
            spmm_csr_accum_reference(scale, ptr, st["col"], st["w"].abs(),
                                     x.abs())
        assert _within_terms(acc, ref, scale)
        if not panel_rows:
            out = spmm_csr(st["ptr"], st["col"], st["w"], x, schedule=sched)
            assert spmm_csr.kernel == "chunks"
            assert _within_terms(out, ref, scale)


# -- K3 by edge chunks: the structures that sit on the schedule's edges -------

from cogdl_tpu_torch.ops.cuda.segment_kernels import (  # noqa: E402
    GAT_KERNELS,
    GAT_ROWS_MAX_HEADS,
)


def _gat_tables(dev, n, H, D, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    h2 = torch.randn(n, H * D, generator=gen, device=dev)
    ss = torch.randn(n, H, generator=gen, device=dev)
    return dict(sd=torch.randn(n, H, generator=gen, device=dev), ss=ss,
                smax=ss.amax(0).contiguous(), h2=h2,
                dagg=torch.randn(n, H * D, generator=gen, device=dev),
                dden=torch.randn(n, H, generator=gen, device=dev))


def _gat_scale(mode, ptr, idx, orig, t, back, **kw):
    """Σ|terms| of each output element (every term is a product with
    ex·slope·keep >= 0)."""
    return gat_pass_reference(mode, ptr, idx, orig, t["sd"], t["ss"],
                              t["smax"], t["h2"].abs(),
                              *(b.abs() for b in back), **kw)


@pytest.mark.parametrize("H,D", [(8, 16), (1, 47), (64, 4)])
@pytest.mark.parametrize("direction", ["fw", "bw"])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_k3_on_adversarial_structures(dev, name, direction, H, D):
    """Every mode, attention dropout 0 and 0.6: single-shot with the kernel
    the wrapper chooses and each by name, then accumulating over three
    panels from a non-zero accumulator; within Σ|terms|, keep masks, two
    calls and both schedules bit for bit, rows without an edge zero (single
    shot) or untouched (accumulating)."""
    st, sched, n = _adversarial(dev, name, direction)
    row = torch.repeat_interleave(torch.arange(n, device=dev),
                                  (st["ptr"][1:] - st["ptr"][:-1]).long())
    orig = torch.randperm(row.numel(), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1)
                          ).int()
    pan, psched, _ = _adversarial(dev, name, direction,
                                  panel_rows=n_third(dev))
    seed = torch.tensor([4321], device=dev)
    empty = st["ptr"][1:] == st["ptr"][:-1]
    kernels = [k for k in GAT_KERNELS if k != "rows" or H <= GAT_ROWS_MAX_HEADS]
    for mode in ("fwd", "dsd", "dsrc"):
        t = _gat_tables(dev, n, H, D)
        back = () if mode == "fwd" else (t["dagg"], t["dden"])
        args = (mode, st["ptr"], st["col"], orig, t["sd"], t["ss"], t["smax"],
                t["h2"], *back)
        for drop in (0.0, 0.6):
            kw = dict(alpha=0.2, attn_drop=drop, seed=seed, with_keep=True)
            *refs, keep_ref = gat_pass_reference(*args, **kw)
            *scale, _ = _gat_scale(*args[:4], t, back, **kw)
            first = gat_pass(*args, schedule=sched, **kw)
            runs = [first] + [gat_pass(*args, schedule=sched, kernel=k, **kw)
                              for k in kernels]
            torch.cuda.synchronize()
            for *outs, keep in runs:
                assert torch.equal(keep, keep_ref)
                assert all(_within_terms(o, r, sc)
                           for o, r, sc in zip(outs, refs, scale))
                assert all((o[empty] == 0).all() for o in outs)
            for again in (gat_pass(*args, schedule=sched, **kw),
                          gat_pass(*args, **kw)):
                assert all(torch.equal(a, b) for a, b in zip(first, again))
            # accumulating, coordinate key
            kwa = dict(alpha=0.2, attn_drop=drop, seed=seed, coord_key=True)
            acc0 = tuple(torch.randn(n, w, device=dev)
                         for w in gat_output_widths(mode, H, H * D))
            results = []
            for prepared in (True, True, False):
                acc, ref = (tuple(a.clone() for a in acc0) for _ in range(2))
                scale = tuple(a.abs() for a in acc0)
                for p, ptr in enumerate(pan["ptr"]):
                    untouched = ptr[1:] == ptr[:-1]
                    before = [a[untouched].clone() for a in acc]
                    pargs = (mode, ptr, pan["col"], None, t["sd"], t["ss"],
                             t["smax"], t["h2"], *back)
                    gat_pass(*pargs, acc=acc, schedule=psched.panel(p)
                             if prepared else None, **kwa)
                    assert all(torch.equal(a[untouched], b)
                               for a, b in zip(acc, before))
                    gat_pass_reference(*pargs, acc=ref, **kwa)
                    _gat_scale(*pargs[:4], t, back, acc=scale, **kwa)
                assert all(_within_terms(o, r, sc)
                           for o, r, sc in zip(acc, ref, scale))
                results.append(acc)
            assert all(torch.equal(a, b) for other in results[1:]
                       for a, b in zip(results[0], other))


def test_k3_chooses_its_kernel_by_the_longest_row(dev):
    """No row longer than a chunk and at most 32 heads: the row-a-warp
    kernel, one CUDA kernel a call. A cut row: the chunk kernel and the
    cross kernel (two for the modes with a vector output). 64 heads: the
    chunk kernel in two passes."""
    star, ssched, n = _adversarial(dev, "star", "fw")
    flat, fsched, _ = _adversarial(dev, "star", "bw")
    assert ssched.cross.shape[0] == 1 and fsched.cross.shape[0] == 0
    orig = torch.arange(star["col"].numel(), device=dev, dtype=torch.int32)
    for (st, sched), H, kernel, counts in (
            ((flat, fsched), 8, "rows", (1, 1, 1)),
            ((star, ssched), 8, "chunks", (3, 2, 3)),
            ((flat, fsched), 64, "chunks", (2, 2, 2))):
        t = _gat_tables(dev, n, H, 4)
        for mode, want in zip(("fwd", "dsd", "dsrc"), counts):
            back = () if mode == "fwd" else (t["dagg"], t["dden"])
            gat_pass(mode, st["ptr"], st["col"], orig, t["sd"], t["ss"],
                     t["smax"], t["h2"], *back, alpha=0.2, schedule=sched)
            assert gat_pass.kernel == kernel
            assert gat_pass.cuda_kernels == want, (mode, H)
    with pytest.raises(ValueError, match="1 <= H <= 32"):
        gat_pass("fwd", star["ptr"], star["col"], orig, t["sd"], t["ss"],
                 t["smax"], t["h2"], alpha=0.2, schedule=ssched,
                 kernel="rows")


# -- sampled mini-batch training ---------------------------------------------

from cogdl_tpu_torch.data.device_sampling import (  # noqa: E402
    DeviceNeighborSampler,
    sample_blocks_device,
)
from cogdl_tpu_torch.models import build_model  # noqa: E402
from cogdl_tpu_torch.wrappers.sampled_node_classification import (  # noqa: E402
    DeviceSampledNodeClfWrapper,
)


def test_sampled_blocks_on_the_card_keep_the_samplers_promises(dev):
    g = chip_smoke._holed_graph(5000, dev)
    seeds = torch.from_numpy(DeviceNeighborSampler(
        g, (5, 3), batch_size=64).epoch_seeds()[0]).to(dev)
    blocks, frame = sample_blocks_device(
        g, seeds, torch.Generator(device=dev).manual_seed(0), (5, 3))
    assert frame.is_cuda and all(b.col.is_cuda for b in blocks)
    live, dead = chip_smoke.check_blocks(g, blocks, frame, seeds)
    assert live > 0 and dead > 0


def test_sampled_logits_on_the_card_match_the_cpu(dev):
    info = chip_smoke.phase_sampled_check(dev, num_nodes=5000, batch_size=64,
                                          fanouts=(5, 3))
    assert max(info["max_abs_diff"].values()) < 1e-4


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_sampled_train_step_launches_no_kernel_and_waits_for_nothing(dev,
                                                                    model):
    """A sampled step on the card: no hand-written kernel, and no operation
    that makes the host wait for the card (sync debug mode raises on one)."""
    from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph

    g = add_self_loops(powerlaw_graph(3000, avg_degree=8, feat_dim=16,
                                      num_classes=5, device_features=True,
                                      device=dev))
    net = build_model(model, in_features=16, out_features=5, hidden_size=8,
                      nhead=2).to(dev)
    w = DeviceSampledNodeClfWrapper(net, fanouts=(4, 3), batch_size=32)
    w._sampler = DeviceNeighborSampler(g, (4, 3), batch_size=32)
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = w.epoch_xs(g)

    def step(x):
        opt.zero_grad(set_to_none=True)
        loss = w.loss(w.make_batch(g, x), gen)
        loss.backward()
        opt.step()
        return loss.detach()

    step(rows[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [step(x) for x in rows[1:]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.stack(losses).isfinite().all()
    assert (spmm_csr.launches, spmm_csr_accum.launches,
            gat_pass.launches) == (0, 0, 0)


# -- host-sampled mini-batch training ----------------------------------------

from cogdl_tpu_torch.data.sampling import Prefetcher  # noqa: E402
from cogdl_tpu_torch.wrappers.sampled_node_classification import (  # noqa: E402
    SampledNodeClfWrapper,
)


def _host_sampled(dev, model, **kw):
    """A small device_features graph on the card and the neighbor_sampling
    wrapper over it, its sampler built (seed 1)."""
    from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph

    g = add_self_loops(powerlaw_graph(3000, avg_degree=8, feat_dim=16,
                                      num_classes=5, device_features=True,
                                      device=dev))
    net = build_model(model, in_features=16, out_features=5, hidden_size=8,
                      **kw)
    w = SampledNodeClfWrapper(net, fanouts=(4, 3), batch_size=32, seed=1,
                              device_features=True)
    w.build_sampler(g)
    return g, net, w


def _tensors(item):
    """Every tensor of a batch of blocks, by field, in order."""
    out = []
    for b in item:
        for name in b.__dataclass_fields__:
            v = getattr(b, name)
            if isinstance(v, torch.Tensor):
                out.append((name, v))
        out += sorted((b.extras or {}).items())
    return out


def test_prefetched_host_batches_land_on_the_card_as_drawn(dev):
    """Each batch the worker copies to the card (pinned, on its own
    stream) equals the same seed's batch left on the host, the blocks'
    kernel structure included; the resident feature table is not
    copied."""
    g, _, w = _host_sampled(dev, "gat", nhead=2)
    _, _, twin = _host_sampled(dev, "gat", nhead=2)
    on_card = list(w.train_batches(g))
    on_host = list(Prefetcher(twin._epoch_batches))
    assert len(on_card) == len(on_host) == len(w._sampler)
    for a, b in zip(on_card, on_host):
        assert "spmm_fw_orig" in a[0].extras
        assert a[0].extras["x_table"] is g.x
        for (na, ta), (nb, tb) in zip(_tensors(a), _tensors(b)):
            assert na == nb and ta.is_cuda
            assert torch.equal(ta, tb.to(dev)), na


@pytest.mark.parametrize("model,kw,per_step", [
    ("graphsage", {"aggr": "sum"},
     {"spmm_csr": {("csr", 16): 1, ("csr", 8): 1, ("csc", 8): 1}}),
    ("graphsage", {"aggr": "mean"}, {}),
    ("gat", {"nhead": 2},
     {"gat_pass": {(m, h, d): 1 for m in ("fwd", "dsd", "dsrc")
                   for h, d in ((2, 8), (1, 5))}}),
])
def test_host_sampled_step_launches_k1_k3_and_waits_for_nothing(dev, model,
                                                                kw, per_step):
    """A host-sampled step on the card: K1 over each block's CSR (and the
    hidden layer's CSC backward) for GraphSAGE ``sum``, K3's three modes
    a layer for GAT, nothing for ``mean``; and no operation that makes the
    host wait for the card (sync debug mode raises on one)."""
    g, net, w = _host_sampled(dev, model, **kw)
    net.to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = list(w.train_batches(g))

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = w.loss(batch, gen)
        loss.backward()
        opt.step()
        return loss.detach()

    step(batches[0])
    torch.cuda.synchronize()
    losses = []
    for batch in batches[1:]:
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses.append(step(batch))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert {f.__name__: dict(f.launches_by) for f in
                (spmm_csr, spmm_csr_accum, gat_pass) if f.launches} == per_step
    assert torch.stack(losses).isfinite().all()


def test_host_sampled_blocks_run_k1_k3_like_their_plain_versions(dev):
    info = chip_smoke.phase_host_sampled_check(
        dev, num_nodes=5000, batch_size=64, fanouts=(5, 3), timing_batches=2)
    assert max(info["max_abs_diff"].values()) < 1e-4
    assert all(max(r["k1"], r["k3"]) <= 1.0 for r in info["blocks"].values())


# -- cluster and GraphSAINT mini-batch training --------------------------------

from cogdl_tpu_torch.data.graph import row_norm  # noqa: E402
from cogdl_tpu_torch.wrappers.sampled_node_classification import (  # noqa: E402
    ClusterNodeClfWrapper,
    GraphSAINTWrapper,
)


def _subgraph_wrapper(dev, name):
    """A small powerlaw graph on the card and a cluster wrapper over GCN or
    a GraphSAINT wrapper over GraphSAINT 1-1-0, prepared (seed 1)."""
    from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph

    g = powerlaw_graph(3000, avg_degree=8, feat_dim=16, num_classes=5,
                       device_features=True, device=dev)
    if name == "cluster":
        net = build_model("gcn", in_features=16, out_features=5,
                          hidden_size=8)
        w = ClusterNodeClfWrapper(net, n_clusters=8, cluster_batch=2, seed=1)
    else:
        net = build_model("graphsaint", in_features=16, out_features=5,
                          hidden_size=8)
        w = GraphSAINTWrapper(net, walk_roots=200, batches_per_epoch=4,
                              est_samples=6, seed=1)
    return w.prepare_graph(g), net, w


@pytest.mark.parametrize("name,per_step", [
    ("cluster", {("csr", 8): 1, ("csr", 5): 1, ("csc", 8): 1, ("csc", 5): 1}),
    ("graphsaint", {("csr", 16): 2, ("csc", 16): 1}),
])
def test_subgraph_step_launches_k1_and_waits_for_nothing(dev, name,
                                                         per_step):
    """A cluster or GraphSAINT step on the card runs K1 over its batch's
    fresh structure (GCN: CSR and CSC at both widths; GraphSAINT 1-1-0 at
    hidden 8: CSR F=16, CSR F=16 and CSC F=16 for layer 1's two orders) and
    no operation that makes the host wait for the card."""
    graph, net, w = _subgraph_wrapper(dev, name)
    net.to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = list(w.train_batches(graph))
    assert all(b.x.is_cuda and "spmm_fw_w" in b.extras for b in batches)

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = w.loss(batch, gen)
        loss.backward()
        opt.step()
        return loss.detach()

    step(batches[0])
    torch.cuda.synchronize()
    losses = []
    for batch in batches[1:]:
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses.append(step(batch))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert dict(spmm_csr.launches_by) == per_step
    assert torch.stack(losses).isfinite().all()


def test_a_norm_after_the_structure_makes_cuda_spmm_raise(dev):
    """A normalisation that changes the weights drops the structure, so the
    kernel's dispatcher raises instead of reading the old weights; a graph
    already tagged keeps it."""
    g = _graph(dev)
    assert spmm(sym_norm(g), g.x).is_cuda      # tagged: kept
    with pytest.raises(RuntimeError, match="prepare_spmm"):
        spmm(row_norm(g), g.x)


def test_cluster_and_saint_batches_run_k1_like_their_plain_versions(dev):
    info = chip_smoke.phase_cluster_saint_check(
        dev, num_nodes=5000, saint_kw=dict(chip_smoke.SAINT_KW,
                                           walk_roots=200, est_samples=6),
        iters=2)
    for label in ("cluster", "saint"):
        assert info[label]["k1"] <= 1.0
        assert max(info[label]["max_abs_diff"].values()) < 1e-4
        assert info[label]["profile"]["busy_ms"] > 0


# -- the full-batch node-classification zoo -----------------------------------

ZOO = ("gcnii", "appnp", "mixhop", "sgc", "mlp", "deepergcn", "drgcn",
       "drgat")


@pytest.mark.parametrize("model", ZOO)
def test_zoo_model_on_card_matches_the_cpu_and_launches_its_kernel(dev,
                                                                   model):
    """Each zoo model on ``sbm`` through ``experiment()`` on the card: the
    models that propagate launch K1 (DrGAT K3) and nothing else, MLP and
    DeeperGCN launch nothing; and the same weights give the card's logits
    within 1e-4 of the CPU's, dropout off."""
    from cogdl_tpu_torch.models import build_model
    from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
    from cogdl_tpu_torch.wrappers.sampled_node_classification import (
        reads_kernel_structure,
    )

    reset_launch_counts()
    (res,) = experiment(dataset="sbm", model=model, epochs=3,
                        eval_step=1)[("sbm", model)]
    assert math.isfinite(res["train_loss"])
    net = build_model(model, in_features=32, out_features=4, dropout=0.0)
    launched = {"spmm_csr": spmm_csr.launches, "gat_pass": gat_pass.launches}
    expected = ("gat_pass" if model == "drgat" else "spmm_csr"
                if reads_kernel_structure(net) else None)
    assert {k for k, v in launched.items() if v} == (
        {expected} if expected else set())
    if model == "deepergcn":
        # 3 blocks, not 14: card and CPU differ only in summation order, and
        # 14 residual blocks carry that to logits of up to 121 here, 1.0-1.5x
        # the elementwise tolerance in 10 repeats on the H100 (0.045x at 3
        # blocks); chip_smoke.py's zoo-parity holds all 14 at 20k nodes
        net = build_model(model, in_features=32, out_features=4,
                          dropout=0.0, num_layers=3)
    net.reset_parameters(torch.Generator().manual_seed(0))
    g = sbm_graph(num_nodes=400, seed=0)
    logits = []
    for d in (torch.device("cpu"), dev):
        m = copy.deepcopy(net).to(d)
        with torch.no_grad():
            logits.append(m(NodeClfWrapper(m).prepare_graph(g.to(d))).cpu())
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-4, atol=1e-4)
