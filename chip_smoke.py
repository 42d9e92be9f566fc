#!/usr/bin/env python3
"""Smoke run of cogdl_tpu_torch on one NVIDIA card (written for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (K1, the CSR SpMM, and K3,
the fused GAT attention pass), holds each against its plain PyTorch version
at the main paths' shapes, trains GCN and then GAT through ``experiment()``
and checks that each path went through its kernel, compares card and CPU
logits, and checks accuracy on ``sbm``. Prints one JSON line of kernel
measurements and, last, ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, when torch sees no CUDA device or any phase fails.

The phases are functions of a device and a size so that a CPU test can
rehearse them at a tiny size.
"""

from __future__ import annotations

import copy
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from cogdl_tpu_torch.data.graph import add_self_loops, sym_norm
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import powerlaw_graph
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.models import build_model
from cogdl_tpu_torch.ops import edge_softmax, gather, gather_src, mh_spmm
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper

# bench.py's default GCN configuration: 100k nodes, avg degree 30, F=100,
# hidden 128, 47 classes
NUM_NODES = 100_000
AVG_DEGREE = 30
FEAT_DIM = 100
HIDDEN = 128
NUM_CLASSES = 47
MAIN_EPOCHS = 30
# bench.py's GAT configuration (bench.py:297-300): hidden 128 as 8 heads of
# 16, the output layer one head over the 47 classes; dropout and attention
# dropout 0.6 (the gat entry of configs.py)
GAT_HEADS, GAT_HEAD_DIM = 8, HIDDEN // 8
GAT_SHAPES = ((GAT_HEADS, GAT_HEAD_DIM), (1, NUM_CLASSES))
GAT_ATTN_DROP = 0.6
GAT_ALPHA = 0.2
# the GAT parity run's size: the CPU side's unfused route builds an
# [E, 128] message tensor on the host
GAT_PARITY_NODES = 20_000

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# K1 against its plain version: both are fp32 and differ only in summation
# order, whose error grows with the magnitude of the terms summed, so the
# tolerance is relative to Σ|w·x| of each output element (hub rows of the
# transposed structure sum ~10^4-10^5 terms).
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
# card logits against CPU logits: two fp32 layers, matmuls and SpMMs summed
# in different orders
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4
SBM_MIN_TEST_ACC = 0.95

# each kernel's source and the TPU kernel it replaces
SPMM_SOURCE = "cogdl_tpu_torch/csrc/spmm_csr.cu"
SPMM_REPLACES = "cogdl_tpu/ops/pallas/segment_kernels.py:294"
GAT_SOURCE = "cogdl_tpu_torch/csrc/gat_fused.cu"
GAT_REPLACES = "cogdl_tpu/ops/pallas/segment_kernels.py:975"


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, device: torch.device, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call: CUDA events on the card, the host clock on
    the CPU (rehearsal only)."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(n_rows: int, nnz: int, feat: int, x_rows: int):
    """Least time for one call on the H100: each input read once (row_ptr,
    col, w, and the ``x_rows`` rows of x that ``col`` names), the output's
    ``n_rows`` rows written once, against the HBM rate; 2·nnz·F flops
    against the fp32 rate. Returns ``(ms, "bytes" | "operations")``."""
    nbytes = 4 * (n_rows + 1) + 8 * nnz + 4 * (x_rows + n_rows) * feat
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * nnz * feat / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gat_bound_ms(mode: str, n_rows: int, nnz: int, x_rows: int,
                 own_rows: int, heads: int, head_dim: int, drop: bool):
    """Least time for one K3 pass on the H100. Bytes, each input read once:
    ``ptr``, the ``nnz`` neighbour indices (and ``orig`` ids under
    dropout), the neighbour-table rows of the ``x_rows`` nodes that the
    indices name (fwd/dsd: h2 and ss; dsrc: dagg, sd and dden), the
    grouping key's own node tables for its ``own_rows`` rows with edges
    (fwd: sd; dsd: sd, dagg, dden; dsrc: ss, h2) and ``smax``; each output
    row written once for all ``n_rows`` rows (fwd: num and den; dsd: dsd;
    dsrc: dh2 and dss). Operations: 2 flops per (edge, column) for each
    accumulated vector (fwd/dsd one, dsrc two) and 8 per (edge, head) for
    the score, shift and exp, against the fp32 rate. Returns
    ``(ms, "bytes" | "operations")``."""
    hd = heads * head_dim
    nbr_w = {"fwd": hd + heads, "dsd": hd + heads, "dsrc": hd + 2 * heads}[mode]
    own_w = {"fwd": heads, "dsd": hd + 2 * heads, "dsrc": hd + heads}[mode]
    out_w = {"fwd": hd + heads, "dsd": heads, "dsrc": hd + heads}[mode]
    nbytes = (4 * (n_rows + 1) + 4 * nnz * (2 if drop else 1)
              + 4 * (x_rows * nbr_w + own_rows * own_w + heads)
              + 4 * n_rows * out_w)
    vectors = 2 if mode == "dsrc" else 1
    flops = 2.0 * nnz * hd * vectors + 8.0 * nnz * heads
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def scaled_err(out, ref, scale):
    """Largest ``|out − ref| / (atol + rtol · scale)``: at most 1 passes."""
    d = (out - ref).detach().abs()
    return float((d / (KERNEL_ATOL + KERNEL_RTOL * scale.detach())).max())


def phase_device() -> str:
    line = smi_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {line}")
    return line


def phase_build() -> float:
    path, log, seconds = sk.build()
    print(f"[build] {path.name} in {seconds:.2f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"[build] {line.strip()}")
    sk.load_library()
    return seconds


@functools.lru_cache(maxsize=1)
def kernel_graph(num_nodes: int, device: torch.device):
    """The main path's graph as the model sees it: powerlaw + self loops +
    sym norm, with K1's structure."""
    g = powerlaw_graph(num_nodes, avg_degree=AVG_DEGREE, feat_dim=FEAT_DIM,
                       num_classes=NUM_CLASSES, seed=0)
    return prepare_spmm(sym_norm(add_self_loops(g)).to(device))


def phase_kernel_check(device: torch.device, num_nodes: int = NUM_NODES,
                       iters: int = 20):
    """K1 against spmm_csr_reference over CSR(A) and CSR(Aᵀ) at F=128 and
    F=47, then the autograd Function against plain autograd. Returns one
    measurement entry per case."""
    g = kernel_graph(num_nodes, device)
    ex = g.extras
    gen = torch.Generator(device=device).manual_seed(0)
    entries = []
    for direction, structure in (("fw", "csr"), ("bw", "csc")):
        ptr, col, w = (ex[f"spmm_{direction}_ptr"], ex[f"spmm_{direction}_col"],
                       ex[f"spmm_{direction}_w"])
        n, nnz = ptr.numel() - 1, col.numel()
        # x rows the structure reads: pad rows are named by no real edge
        x_rows = int(torch.unique(col).numel())
        lib_a = torch.sparse_csr_tensor(ptr, col, w, size=(n, n),
                                        check_invariants=False)
        for feat in (HIDDEN, NUM_CLASSES):
            x = torch.randn(n, feat, generator=gen, device=device)
            out = sk.spmm_csr(ptr, col, w, x, structure)
            ref = sk.spmm_csr_reference(ptr, col, w, x)
            scale = sk.spmm_csr_reference(ptr, col, w.abs(), x.abs())
            err = scaled_err(out, ref, scale)
            name = f"spmm_csr[{structure},F={feat}]"
            if not err <= 1.0:
                raise AssertionError(f"{name}: kernel disagrees with its plain "
                                     f"version ({err:.3g} x tolerance)")
            b_ms, b_by = bound_ms(n, nnz, feat, x_rows)
            entry = {
                "name": name, "route": "cuda", "source": SPMM_SOURCE,
                "replaces": SPMM_REPLACES, "launches": None,
                "case": ["spmm_csr", structure, feat],
                "max_abs_err": float((out - ref).abs().max()),
                "err_over_tol": err,
                "ms": time_ms(lambda: sk.spmm_csr(ptr, col, w, x, structure),
                              device, iters),
                "plain_ms": time_ms(
                    lambda: sk.spmm_csr_reference(ptr, col, w, x), device,
                    max(iters // 4, 1)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lambda: torch.sparse.mm(lib_a, x), device,
                                      iters),
                "rows": n, "x_rows": x_rows, "nnz": nnz, "max_row_nnz": int(
                    (ptr[1:] - ptr[:-1]).max()),
            }
            print(f"[kernel] {json.dumps(entry)}")
            entries.append(entry)

    # autograd: dX through K1 over the transposed structure, dw by SDDMM
    keys = [ex[k] for k in ("spmm_fw_ptr", "spmm_fw_col", "spmm_fw_w",
                            "spmm_bw_ptr", "spmm_bw_col", "spmm_bw_w")]
    x = torch.randn(g.n_pad, NUM_CLASSES, generator=gen, device=device,
                    requires_grad=True)
    w = keys[2].clone().requires_grad_(True)
    probe = torch.randn(g.n_pad, NUM_CLASSES, generator=gen, device=device)
    y = sk.SpMMFunction.apply(x, keys[0], keys[1], w, *keys[3:])
    dx, dw = torch.autograd.grad((y * probe).sum(), (x, w))
    x_ref = x.detach().clone().requires_grad_(True)
    w_ref = keys[2].clone().requires_grad_(True)
    y_ref = sk.spmm_csr_reference(keys[0], keys[1], w_ref, x_ref)
    dx_ref, dw_ref = torch.autograd.grad((y_ref * probe).sum(), (x_ref, w_ref))
    dx_scale = sk.spmm_csr_reference(keys[3], keys[4], keys[5].abs(), probe.abs())
    fw_row = torch.repeat_interleave(
        torch.arange(g.n_pad, device=device), (keys[0][1:] - keys[0][:-1]).long())
    dw_scale = (probe.abs()[fw_row]
                * x.detach().abs()[keys[1].long()]).sum(-1)
    grad_err = {"dx": scaled_err(dx, dx_ref, dx_scale),
                "dw": scaled_err(dw, dw_ref, dw_scale),
                "y": scaled_err(y, y_ref, sk.spmm_csr_reference(
                    keys[0], keys[1], keys[2].abs(), x.detach().abs()))}
    print(f"[kernel] autograd err/tol {json.dumps(grad_err)}")
    if not max(grad_err.values()) <= 1.0:
        raise AssertionError(f"SpMMFunction disagrees with plain autograd: "
                             f"{grad_err}")
    return entries


def phase_main_path(device: torch.device, num_nodes: int = NUM_NODES,
                    epochs: int = MAIN_EPOCHS):
    """GCN on the powerlaw graph through experiment(), at the default dropout
    of 0.5. On the card every train step launches K1 4 times (each layer's
    forward over the CSR and backward over the CSC) and every evaluation
    twice (each layer's forward); a CPU run launches it never. Returns the
    launches of each (structure, F) case and in all."""
    g = powerlaw_graph(num_nodes, avg_degree=AVG_DEGREE, feat_dim=FEAT_DIM,
                       num_classes=NUM_CLASSES, seed=0)
    ds = Dataset.from_graph(g, name=f"powerlaw-{num_nodes}")
    sk.reset_launch_counts()
    results = experiment(dataset=ds, model="gcn", hidden_size=HIDDEN,
                         epochs=epochs, patience=epochs + 1, seed=0,
                         device=str(device))
    launches = sk.spmm_csr.launches
    by_case = dict(sk.spmm_csr.launches_by)
    (runs,) = results.values()
    res = runs[0]
    evals = epochs + 1   # one per epoch and the final one
    on_card = device.type == "cuda"
    expected = {(s, f): (epochs + (evals if s == "csr" else 0)) * on_card
                for s in ("csr", "csc") for f in (HIDDEN, NUM_CLASSES)}
    if {k: by_case.get(k, 0) for k in expected} != expected or (
            launches != sum(expected.values())):
        raise AssertionError(f"main path launched K1 {launches} times, by "
                             f"case {by_case}; expected {expected} ({epochs} "
                             f"steps, {evals} evaluations)")
    if not np.isfinite(res["train_loss"]):
        raise AssertionError(f"main path loss is not finite: {res}")
    if sk.gat_pass.launches:
        raise AssertionError(f"GCN launched K3 {sk.gat_pass.launches} times")
    info = {"launches": launches, "launches_per_step": 4,
            "launches_by_case": {f"{s},F={f}": by_case.get((s, f), 0)
                                 for s, f in expected},
            "train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "train_loss": res["train_loss"], "epochs": epochs}
    print(f"[main] {json.dumps(info)}")
    info["launches_by"] = by_case
    return info


def phase_parity(device: torch.device, num_nodes: int = NUM_NODES):
    """The same GCN weights with dropout off on ``device`` and on the CPU
    (plain versions); returns the largest logit difference."""
    g = powerlaw_graph(num_nodes, avg_degree=AVG_DEGREE, feat_dim=FEAT_DIM,
                       num_classes=NUM_CLASSES, seed=0)
    model = build_model("gcn", in_features=FEAT_DIM, out_features=NUM_CLASSES,
                        hidden_size=HIDDEN, dropout=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    logits = {}
    for dev in (torch.device("cpu"), device):
        m = copy.deepcopy(model).to(dev)
        prepared = NodeClfWrapper(m).prepare_graph(g.to(dev))
        with torch.no_grad():
            logits[dev.type] = m(prepared, training=False)[:num_nodes].cpu()
    ref, out = logits["cpu"], logits[device.type]
    diff = float((out - ref).abs().max())
    print(f"[parity] max |logits_{device.type} - logits_cpu| = {diff:.3g}")
    if not torch.allclose(out, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
        raise AssertionError(f"card logits differ from CPU logits by {diff}")
    return diff


def phase_quality(device: torch.device, epochs: int = 100):
    results = experiment(dataset="sbm", model="gcn", epochs=epochs, seed=[0, 1],
                         device=str(device))
    (runs,) = results.values()
    acc = float(np.mean([r["test_acc"] for r in runs]))
    print(f"[quality] sbm test_acc {acc:.4f} (bar {SBM_MIN_TEST_ACC})")
    if acc < SBM_MIN_TEST_ACC:
        raise AssertionError(f"sbm test_acc {acc} < {SBM_MIN_TEST_ACC}")
    return acc


def _gat_inputs(n: int, heads: int, head_dim: int, gen, device):
    """Random K3 inputs over ``n`` rows: ``ss = Σ_d a_src·h2`` as the layer
    forms it, scaled so that the scores are O(1)."""
    hd = heads * head_dim
    h2 = torch.randn(n, hd, generator=gen, device=device)
    a_src = torch.randn(heads, head_dim, generator=gen,
                        device=device) / head_dim ** 0.5
    ss = (h2.view(n, heads, head_dim) * a_src).sum(-1).contiguous()
    return {"sd": torch.randn(n, heads, generator=gen, device=device),
            "ss": ss, "smax": ss.amax(0).contiguous(), "h2": h2,
            "dagg": torch.randn(n, hd, generator=gen, device=device),
            "dden": torch.randn(n, heads, generator=gen, device=device)}


def phase_gat_kernel_check(device: torch.device, num_nodes: int = NUM_NODES,
                           iters: int = 20):
    """K3 against gat_pass_reference in each mode at the GAT main path's two
    shapes, with attention dropout off and at 0.6: every output element
    within ``KERNEL_ATOL + KERNEL_RTOL·Σ|terms|`` and the keep masks equal
    bit for bit. Times each mode and shape at dropout 0.6 (the training
    passes). Returns one measurement entry per mode and shape."""
    g = kernel_graph(num_nodes, device)
    ex = g.extras
    gen = torch.Generator(device=device).manual_seed(1)
    seed = torch.tensor([123456789], dtype=torch.int64, device=device)
    entries = []
    for heads, head_dim in GAT_SHAPES:
        t = _gat_inputs(g.n_pad, heads, head_dim, gen, device)
        for mode in sk.GAT_MODES:
            d = "bw" if mode == "dsrc" else "fw"
            ptr, idx, orig = (ex[f"spmm_{d}_{k}"] for k in ("ptr", "col", "orig"))
            back = () if mode == "fwd" else (t["dagg"], t["dden"])
            base = (mode, ptr, idx, orig, t["sd"], t["ss"], t["smax"], t["h2"])
            abs_base = base[:-1] + (t["h2"].abs(),)
            name = f"gat_pass[{mode},H={heads},D={head_dim}]"
            errs, max_abs = [], 0.0
            for drop in (0.0, GAT_ATTN_DROP):
                kw = dict(alpha=GAT_ALPHA, attn_drop=drop, seed=seed,
                          with_keep=True)
                *outs, keep = sk.gat_pass(*base, *back, **kw)
                *refs, keep_ref = sk.gat_pass_reference(*base, *back, **kw)
                # every term is a product with ex·slope·keep >= 0, so the
                # plain pass over |tables| sums the terms' magnitudes
                *scales, _ = sk.gat_pass_reference(
                    *abs_base, *(b.abs() for b in back), **kw)
                if not torch.equal(keep, keep_ref):
                    raise AssertionError(
                        f"{name}: keep mask differs from the plain version's "
                        f"at drop {drop} in {int((keep != keep_ref).sum())} "
                        "entries")
                errs += [scaled_err(o, r, sc)
                         for o, r, sc in zip(outs, refs, scales)]
                max_abs = max([max_abs] + [float((o - r).abs().max())
                                           for o, r in zip(outs, refs)])
            if not max(errs) <= 1.0:
                raise AssertionError(f"{name}: kernel disagrees with its plain "
                                     f"version ({max(errs):.3g} x tolerance)")
            kw = dict(alpha=GAT_ALPHA, attn_drop=GAT_ATTN_DROP, seed=seed)
            nnz = idx.numel()
            x_rows = int(torch.unique(idx).numel())
            own_rows = int((ptr[1:] > ptr[:-1]).sum())
            b_ms, b_by = gat_bound_ms(mode, g.n_pad, nnz, x_rows, own_rows,
                                      heads, head_dim, drop=True)
            entry = {
                "name": name, "route": "cuda", "source": GAT_SOURCE,
                "replaces": GAT_REPLACES, "launches": None,
                "case": ["gat_pass", mode, heads, head_dim],
                "max_abs_err": max_abs, "err_over_tol": max(errs),
                "ms": time_ms(lambda: sk.gat_pass(*base, *back, **kw), device,
                              iters),
                "plain_ms": time_ms(
                    lambda: sk.gat_pass_reference(*base, *back, **kw), device,
                    max(iters // 4, 1), warmup=1),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "rows": g.n_pad, "x_rows": x_rows, "own_rows": own_rows,
                "nnz": nnz, "attn_drop": GAT_ATTN_DROP,
                "max_row_nnz": int((ptr[1:] - ptr[:-1]).max()),
            }
            print(f"[gat-kernel] {json.dumps(entry)}")
            entries.append(entry)
    return entries


def phase_gat_autograd(device: torch.device, num_nodes: int = NUM_NODES):
    """GATFusedFunction (K3) against plain autograd through the unfused
    route (gather, edge_softmax, mh_spmm) at dropout 0, both shapes: the
    output and the grads of sd and h (through ss = Σ_d a_src·h), each within
    ``KERNEL_ATOL + LOGIT_RTOL·max|plain|``. Returns the errors over
    tolerance."""
    g = kernel_graph(num_nodes, device)
    ex = g.extras
    keys = [ex[f"spmm_{d}_{k}"] for d in ("fw", "bw")
            for k in ("ptr", "col", "orig")]
    plain = g.replace(extras=None)
    gen = torch.Generator(device=device).manual_seed(2)
    n, report = g.n_pad, {}
    for heads, head_dim in GAT_SHAPES:
        t = _gat_inputs(n, heads, head_dim, gen, device)
        a_src = torch.randn(heads, head_dim, generator=gen,
                            device=device) / head_dim ** 0.5
        probe = torch.randn(n, heads * head_dim, generator=gen, device=device)
        res = {}
        for route in ("fused", "plain"):
            sd = t["sd"].clone().requires_grad_(True)
            h = t["h2"].view(n, heads, head_dim).clone().requires_grad_(True)
            ss = (h * a_src).sum(-1)
            if route == "fused":
                out = sk.GATFusedFunction.apply(
                    sd, ss, h.view(n, -1), *keys, None, GAT_ALPHA, 0.0)
            else:
                e = gather(sd, plain.row) + gather_src(plain, ss)
                att = edge_softmax(
                    plain, torch.nn.functional.leaky_relu(e, GAT_ALPHA))
                out = mh_spmm(plain, att, h).reshape(n, -1)
            res[route] = (out.detach(),) + torch.autograd.grad(
                (out * probe).sum(), (sd, h))
        errs = {k: float((a - b).abs().max()
                         / (KERNEL_ATOL + LOGIT_RTOL * b.abs().max()))
                for k, a, b in zip(("out", "dsd", "dh"), res["fused"],
                                   res["plain"])}
        report[f"H={heads},D={head_dim}"] = errs
    print(f"[gat-autograd] err/tol {json.dumps(report)}")
    if not max(max(r.values()) for r in report.values()) <= 1.0:
        raise AssertionError(f"GATFusedFunction disagrees with plain autograd: "
                             f"{report}")
    return report


def phase_gat_main_path(device: torch.device, num_nodes: int = NUM_NODES,
                        epochs: int = MAIN_EPOCHS):
    """GAT on the powerlaw graph through experiment() with the gat best
    config (dropout and attention dropout 0.6, lr 0.005) at bench.py's
    widths. On the card every train step launches K3 6 times (each layer's
    fwd, dsd and dsrc) and every evaluation twice (each layer's fwd); a CPU
    run launches it never. Returns the launches of each (mode, H, D) case
    and in all."""
    g = powerlaw_graph(num_nodes, avg_degree=AVG_DEGREE, feat_dim=FEAT_DIM,
                       num_classes=NUM_CLASSES, seed=0)
    ds = Dataset.from_graph(g, name=f"powerlaw-{num_nodes}")
    sk.reset_launch_counts()
    results = experiment(dataset=ds, model="gat", use_best_config=True,
                         hidden_size=GAT_HEAD_DIM, nhead=GAT_HEADS,
                         epochs=epochs, patience=epochs + 1, seed=0,
                         device=str(device))
    launches = sk.gat_pass.launches
    by_case = dict(sk.gat_pass.launches_by)
    (runs,) = results.values()
    res = runs[0]
    evals = epochs + 1   # one per epoch and the final one
    on_card = device.type == "cuda"
    expected = {(m, h, d): (epochs + (evals if m == "fwd" else 0)) * on_card
                for m in sk.GAT_MODES for h, d in GAT_SHAPES}
    if by_case != {k: v for k, v in expected.items() if v} or (
            launches != sum(expected.values())):
        raise AssertionError(f"GAT main path launched K3 {launches} times, "
                             f"by case {by_case}; expected {expected} "
                             f"({epochs} steps, {evals} evaluations)")
    if sk.spmm_csr.launches:
        raise AssertionError(f"GAT launched K1 {sk.spmm_csr.launches} times")
    if not np.isfinite(res["train_loss"]):
        raise AssertionError(f"GAT main path loss is not finite: {res}")
    info = {"launches": launches, "launches_per_step": 6,
            "launches_per_eval": 2,
            "launches_by_case": {f"{m},H={h},D={d}": by_case.get((m, h, d), 0)
                                 for m, h, d in expected},
            "train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "train_loss": res["train_loss"], "epochs": epochs}
    print(f"[gat-main] {json.dumps(info)}")
    info["launches_by"] = by_case
    return info


def phase_gat_parity(device: torch.device,
                     num_nodes: int = GAT_PARITY_NODES):
    """The same GAT weights with dropout off on ``device`` (fused route,
    K3) and on the CPU (unfused route); returns the largest logit
    difference."""
    g = powerlaw_graph(num_nodes, avg_degree=AVG_DEGREE, feat_dim=FEAT_DIM,
                       num_classes=NUM_CLASSES, seed=0)
    model = build_model("gat", in_features=FEAT_DIM, out_features=NUM_CLASSES,
                        hidden_size=GAT_HEAD_DIM, nhead=GAT_HEADS,
                        dropout=0.0, attn_drop=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    logits = {}
    for dev in (torch.device("cpu"), device):
        m = copy.deepcopy(model).to(dev)
        prepared = NodeClfWrapper(m).prepare_graph(g.to(dev))
        with torch.no_grad():
            logits[dev.type] = m(prepared, training=False)[:num_nodes].cpu()
    ref, out = logits["cpu"], logits[device.type]
    diff = float((out - ref).abs().max())
    print(f"[gat-parity] max |logits_{device.type} - logits_cpu| = {diff:.3g} "
          f"({num_nodes} nodes)")
    if not torch.allclose(out, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
        raise AssertionError(f"card GAT logits differ from CPU logits by "
                             f"{diff}")
    return diff


def phase_gat_quality(device: torch.device, epochs: int = 100):
    results = experiment(dataset="sbm", model="gat", epochs=epochs, seed=[0, 1],
                         device=str(device))
    (runs,) = results.values()
    acc = float(np.mean([r["test_acc"] for r in runs]))
    print(f"[gat-quality] sbm test_acc {acc:.4f} (bar {SBM_MIN_TEST_ACC})")
    if acc < SBM_MIN_TEST_ACC:
        raise AssertionError(f"GAT sbm test_acc {acc} < {SBM_MIN_TEST_ACC}")
    return acc


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    entries = phase_kernel_check(device)
    main_info = phase_main_path(device)
    phase_parity(device)
    phase_quality(device)
    entries += phase_gat_kernel_check(device)
    phase_gat_autograd(device)
    gat_info = phase_gat_main_path(device)
    phase_gat_parity(device)
    phase_gat_quality(device)
    launches_by = {"spmm_csr": main_info["launches_by"],
                   "gat_pass": gat_info["launches_by"]}
    for e in entries:
        kernel, *case = e.pop("case")
        e["launches"] = launches_by[kernel].get(tuple(case), 0)
    print(f"[done] {time.perf_counter() - t0:.1f} s; GCN main path "
          f"train_step_ms={main_info['train_step_ms']:.3f} "
          f"eval_ms={main_info['eval_ms']:.3f}; GAT main path "
          f"train_step_ms={gat_info['train_step_ms']:.3f} "
          f"eval_ms={gat_info['eval_ms']:.3f} on {smi}")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
