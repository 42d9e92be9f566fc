#!/usr/bin/env python3
"""Smoke run of cogdl_tpu_torch on one NVIDIA card (written for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (K1, the CSR SpMM, K2, the
accumulating CSR SpMM, and K3, the fused GAT attention pass), holds each
against its plain PyTorch version at the main paths' shapes, trains GCN and
then GAT through ``experiment()`` and checks that each path went through its
kernel, compares card and CPU logits, and checks accuracy on ``sbm``. Then
the products-scale path of ``cogdl_tpu_torch.bench`` (2.45 M nodes, about
125 M edges, the panel structure built on the card): K2 and K3's
accumulating form against their plain versions panel by panel, sweeps of
panel heights for GCN and GAT, and GCN and GAT train steps with exact
launch counts. K1, K2 and K3 cut their work by edge chunks: all three are
also held against their plain versions on structures that sit on the chunk
schedule's edges (a star, rows of exactly one chunk more or less, no edge
at all), and K1/K2's chunk size is swept. Then
the gather probes (K4, K5 and K6 against their plain versions at the sizes of
``cogdl_tpu_torch.scripts.microbench_gather``, timed as the host queues
the calls and with the host held out (``device_ms``), warm and with a cold
L2; also on adversarial shapes (uneven window groups, chunks of 1 to 4096
slots, windows of 1 to 4096 rows, fewer chunks than SMs and more, clamped
indices) with every kernel they may run, and swept over K5's tile widths,
K4's carve-outs and K6's depths; every stage of
that script with exact launch counts) and full-batch GraphSAGE through
``experiment()``. Last, sampled mini-batch training with the device
sampler: GraphSAGE and GAT through ``experiment()`` with exact launch counts
(none on a train step), the sampler's blocks checked on the card against
the graph and card logits over them against the CPU's, and
``bench --sampled`` at 100k nodes and at the products scale with
``torch.profiler``'s busy time; then host-sampled training: the port's C++
sampler built with g++ and held bit for bit against its numpy replay,
GraphSAGE and GAT through ``experiment(wrapper="neighbor_sampling")`` with
exact launch counts (K1 and K3 over a fresh block structure every step),
K1 and K3 over a full-size host block against their plain versions, card
against CPU logits over it, and ``bench --sampled --host-sampler`` at 100k
and products with the worker's own time a batch and ``torch.profiler``'s
busy time; then ClusterGCN and GraphSAINT: GCN through
``experiment(wrapper="cluster")`` and GraphSAINT (and GCN under its
wrapper) through ``experiment(model="graphsaint")`` with exact launch
counts (K1 over a fresh subgraph structure every step, at F=256 for
GraphSAINT's concatenated orders), K1 over a full-size cluster and SAINT
batch against its plain version at every width those paths run, card
against CPU logits over both, ``bfs_partition``'s time, the worker's time a
batch and ``torch.profiler``'s busy time; then the full-batch zoo and the
rest of it (each model through ``experiment()`` with exact launch counts,
card against CPU logits, ``sbm`` accuracy against the JAX package's); then
DisenGCN and SRGCN at 100k nodes (no kernel of ours) and graph
classification: K1 over the structure of a union batch of 128 small graphs
at F = 8, 32, 37 and 64 and on the adversarial structures at F = 8 and 37,
GIN, SortPool and DiffPool through ``experiment()`` on an NCI1-scale
``random-graphs`` set with exact launch counts, card against CPU logits,
and test accuracy against the JAX package's; then the heterogeneous
family on an ACM-scale ``hetero-sbm`` set (7,500 nodes, 1,870 features, two
metapath graphs of about 1.09 M edges): K1 at F=1870 and K3 at (8, 8) over
a metapath graph's structure, HAN, GTN, RGCN, CompGCN (at 3,025 nodes) and
Simple-HGN through ``experiment()`` with exact launch counts (K3 for HAN,
K1 for GTN, none for the rest), card against CPU logits at 1,500 nodes,
and test accuracy against the JAX package's; then the node-classification
stragglers at 100k nodes: Graph U-Net, GCNMix, SAGN and M3S (two stages
over the graph with a third of its non-train nodes in no split), Correct &
Smooth and ``unet`` through ``experiment()`` with exact K1 launch counts,
PATCHY-SAN on the NCI1-scale set (no kernel of ours), K1 at F=100, card
against CPU outputs at 20k nodes (Graph U-Net's keep masks and their
margin) and test accuracy against the JAX package's; then self-supervised
learning: DGI, MVGRL, GraphMAE, GraphMAE2, BGRL, unsupervised GraphSAGE and
GCN under the self-auxiliary wrapper at 100k nodes, GRACE at 20k and
InfoGraph on the NCI1-scale set through ``experiment()`` with exact K1
launch counts and the probes' own time (a logistic regression on the
card, an SVC on the host: no scikit-learn), K1 at F=512 and at F=256 over
the CSC, card against CPU embeddings, losses and probe accuracies at 20k
nodes, and test accuracy against the JAX package's. Prints one JSON line
of kernel measurements and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when torch sees no CUDA device
or any phase fails. ``--gather-only`` builds the kernels and runs only the
gather probes' kernel check; its last line says ``"gather_only": true``.

The phases are functions of a device and a size so that a CPU test can
rehearse them at a tiny size.
"""

from __future__ import annotations

import argparse
import collections
import copy
import functools
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cogdl_tpu_torch import bench, native
from cogdl_tpu_torch.data.device_sampling import (
    DeviceNeighborSampler,
    frame_features,
    sample_blocks_device,
)
from cogdl_tpu_torch.data.graph import add_self_loops, from_coo, sym_norm
from cogdl_tpu_torch.data.sampling import bfs_partition, graph_csr
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import (
    hetero_sbm_graph,
    powerlaw_graph,
    powerlaw_graph_device,
    random_graphs_dataset,
)
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.models import build_model
from cogdl_tpu_torch.models.nn.patchy_san import assemble_fields
from cogdl_tpu_torch.ops import (
    cache_propagation,
    edge_softmax,
    gather,
    gather_src,
    mh_spmm,
    spmm,
    spmm_coo,
)
from cogdl_tpu_torch.ops.cuda import gather_kernels as gk
from cogdl_tpu_torch.ops.cuda import (
    CHUNK_EDGES,
    SCHEDULE_KEYS,
    SpmmSchedule,
    build_spmm_schedule,
    build_spmm_structure,
    prepare_spmm,
    prepare_spmm_device,
    stored_schedule,
)
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.scripts import microbench_gather as mg
from cogdl_tpu_torch.utils.probe import logreg_probe
from cogdl_tpu_torch.utils.svm import cross_val_accuracy, stratified_kfold
from cogdl_tpu_torch.utils.timing import behind_sleep, time_device_ms, time_ms
from cogdl_tpu_torch.wrappers import default_wrapper_for, fetch_wrapper
from cogdl_tpu_torch.wrappers.graph_classification import (
    GraphClfWrapper,
    InfoGraphWrapper,
    PatchySANWrapper,
)
from cogdl_tpu_torch.wrappers.heterogeneous import HeterogeneousGNNWrapper
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from cogdl_tpu_torch.wrappers.sampled_node_classification import (
    ClusterNodeClfWrapper,
    GraphSAINTWrapper,
    SampledNodeClfWrapper,
)

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
# shared memory / L1 reads: 32 banks x 4 B a clock on each of 132 SMs at the
# 1.98 GHz boost clock; what a gather probe that reads every slot's row out
# of on-chip memory needs at the least
ONCHIP_BYTES_PER_S = 132 * 128 * 1.98e9
# the write between two launches of a cold-L2 time: more than the 50 MB L2;
# the card's sleep while the host queues those writes and calls
COLD_FLUSH_BYTES = 64 * 2 ** 20
COLD_SLEEP_MS = 50.0
# The gather probes' `ms` is the median over this many copies of the table,
# each at its own addresses and timed after its own warm-up: a copy's warm
# time follows which of its rows the L2 keeps (K6 reads 44 MB of a 51 MB
# table through a 50 MB L2), so one copy's time is not a stable figure.
GATHER_TIMING_TABLES = 5

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
ACCUM_SOURCE = "cogdl_tpu_torch/csrc/spmm_csr_accum.cu"
ACCUM_REPLACES = "cogdl_tpu/ops/pallas/segment_kernels.py:244"
GAT_SOURCE = "cogdl_tpu_torch/csrc/gat_fused.cu"
GAT_REPLACES = "cogdl_tpu/ops/pallas/segment_kernels.py:975"

GATHER_BLOCK_SOURCE = "cogdl_tpu_torch/csrc/gather_block.cu"
GATHER_BLOCK_REPLACES = "scripts/microbench_gather7.py:82"
GATHER_WINDOW_SOURCE = "cogdl_tpu_torch/csrc/gather_window.cu"
GATHER_WINDOW_REPLACES = "scripts/microbench_gather7.py:111"
GATHER_ROWS_SOURCE = "cogdl_tpu_torch/csrc/gather_rows_async.cu"
GATHER_ROWS_REPLACES = "scripts/microbench_gather7.py:165"
# the gather probes' adversarial shapes: windows (K5) and chunk sizes (K4's
# block height too), whole windows in a table of WINDOWS_IN_TABLE windows
# and 77 rows more
GATHER_ADV_WINDOWS = (1, 32, 256, 1024, 4096)
GATHER_ADV_CHUNKS = (1, 31, 1024, 4096)
WINDOWS_IN_TABLE = 3
# K6's adversarial table: rows from anywhere in it, so its height only sets
# which indices are clamped
GATHER_ADV_ROWS = 3 * 4096 + 77
# the SM count the CPU rehearsal cuts K6's cases by (the H100's)
NOMINAL_SMS = 132
# GraphSAGE's short run with the "sum" aggregator (the K1 count) and the
# aggregators whose card logits are held against the CPU's
SAGE_SUM_EPOCHS = 30
SAGE_AGGREGATORS = ("mean", "sum", "max", "gcn")

# the sampled path: bench --sampled's defaults, B=1024 seeds and fanouts
# (15, 10) seeds outward, over the 100k graph; a few epochs through
# experiment() (10 steps each: about 10% of the nodes are train nodes)
SAMPLED_BATCH = 1024
SAMPLED_FANOUTS = (15, 10)
SAMPLED_EPOCHS = 5
# (label, model, model kwargs) of the sampled main path, at the bench's
# widths; GraphSAGE at its default dropout (0.5), GAT as the sampled bench
# runs it, dropout and attention dropout 0
SAMPLED_MODELS = (
    ("sage-mean", "graphsage", {"hidden_size": HIDDEN, "aggr": "mean"}),
    ("sage-sum", "graphsage", {"hidden_size": HIDDEN, "aggr": "sum"}),
    ("gat", "gat", {"hidden_size": GAT_HEAD_DIM, "nhead": GAT_HEADS,
                    "dropout": 0.0, "attn_drop": 0.0}),
)
# the sampled bench's graphs: (nodes, average degree, --products)
SAMPLED_SCALES = ((NUM_NODES, AVG_DEGREE, False),
                  (bench.PRODUCTS_NODES, bench.PRODUCTS_AVG_DEGREE, True))
# the sampled check's graph: every HOLE_EVERY-th node loses its CSR row (its
# in-edges), so that destinations without an edge are drawn
HOLE_EVERY = 10

# the products-scale path (bench --products): 2.45M nodes x 50, a few steps
PRODUCTS_NODES = bench.PRODUCTS_NODES
PRODUCTS_AVG_DEGREE = bench.PRODUCTS_AVG_DEGREE
PRODUCTS_STEPS = 3
# panels forced in the checks at the 100k graph and the 20k parity graph
CHECK_PANELS = 4
# the panel sweep: 1 is the one-shot K1, the others K2 over that many panels,
# from slices of the feature table above the 50 MB L2 to a tenth of it
SWEEP_PANELS = (1, 2, 4, 8, 32, 128, 256)
# the panel count of the sweep at which a panel's time is taken apart: slices
# of about 10 MB, the default height before K2 was cut by edges
SPLIT_PANELS = 128
# the chunk sweep: edges a warp of K1/K2 takes
SWEEP_CHUNK_EDGES = (32, 64, 128, 256)
# widths of the adversarial checks: float4 lanes, two columns a lane, float4
# with idle lanes
ADVERSARIAL_FEATS = (HIDDEN, NUM_CLASSES, FEAT_DIM)
# K3's (heads, head width) there: the GAT main path's two, and 64 heads,
# which take two passes of 32 heads
ADVERSARIAL_GAT_SHAPES = GAT_SHAPES + ((64, 4),)
# the GAT panel sweep at the products shape: 1 is the single-shot K3, the
# others K3 accumulating over that many panels; 126 was the default before
# K3 was cut by edges
GAT_SWEEP_PANELS = (1, 2, 8, 32, 126)


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def smi_state() -> str:
    """The card's SM and memory clocks, temperature and power draw as
    nvidia-smi reports them now, or "not measured" where there is no
    nvidia-smi (the CPU rehearsal)."""
    try:
        out = subprocess.run(
            ["nvidia-smi",
             "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.stdout.strip().splitlines()[0]


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


def accum_bound_ms(n_rows: int, nnz: int, feat: int, x_rows: int,
                   own_rows: int):
    """Least time for one K2 call on the H100: the panel's row pointers, its
    ``nnz`` col and w entries and the ``x_rows`` rows of x they name read
    once, the ``own_rows`` rows of acc that have an edge read once and
    written once, against the HBM rate; 2·nnz·F flops against the fp32
    rate. Returns ``(ms, "bytes" | "operations")``."""
    nbytes = 4 * (n_rows + 1) + 8 * nnz + 4 * (x_rows + 2 * own_rows) * feat
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * nnz * feat / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gat_bound_ms(mode: str, n_rows: int, nnz: int, x_rows: int,
                 own_rows: int, heads: int, head_dim: int, drop: bool,
                 accum: bool = False):
    """Least time for one K3 pass on the H100. Bytes, each input read once:
    ``ptr``, the ``nnz`` neighbour indices (and ``orig`` ids under
    dropout), the neighbour-table rows of the ``x_rows`` nodes that the
    indices name (fwd/dsd: h2 and ss; dsrc: dagg, sd and dden), the
    grouping key's own node tables for its ``own_rows`` rows with edges
    (fwd: sd; dsd: sd, dagg, dden; dsrc: ss, h2) and ``smax``; each output
    row written once for all ``n_rows`` rows (fwd: num and den; dsd: dsd;
    dsrc: dh2 and dss). Operations: 2 flops per (edge, column) for each
    accumulated vector (fwd/dsd one, dsrc two) and 8 per (edge, head) for
    the score, shift and exp, against the fp32 rate. With ``accum`` (one
    panel's pass of the accumulating form) the outputs are read once and
    written once for the ``own_rows`` rows with edges only; its coordinate
    key reads no ``orig`` ids, so pass ``drop=False``. Returns
    ``(ms, "bytes" | "operations")``."""
    hd = heads * head_dim
    nbr_w = {"fwd": hd + heads, "dsd": hd + heads, "dsrc": hd + 2 * heads}[mode]
    own_w = {"fwd": heads, "dsd": hd + 2 * heads, "dsrc": hd + heads}[mode]
    out_w = {"fwd": hd + heads, "dsd": heads, "dsrc": hd + heads}[mode]
    nbytes = (4 * (n_rows + 1) + 4 * nnz * (2 if drop else 1)
              + 4 * (x_rows * nbr_w + own_rows * own_w + heads)
              + 4 * (2 * own_rows if accum else n_rows) * out_w)
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


def schedule_stats(sched: SpmmSchedule):
    """``(chunks, rows cut across chunks)`` of a schedule, padding left out."""
    starts = sched.chunk_start
    return (int((starts[..., 1:] > starts[..., :-1]).sum()),
            int((sched.cross[..., 0] >= 0).sum()))


def schedule_build_s(ptr, erow, device: torch.device,
                     chunk_edges: int = CHUNK_EDGES):
    """The schedule of ``ptr`` built anew, and the seconds that took."""
    _sync(device)
    t0 = time.perf_counter()
    sched = build_spmm_schedule(ptr, chunk_edges, erow)
    _sync(device)
    return sched, time.perf_counter() - t0


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


@functools.lru_cache(maxsize=2)
def _powerlaw_host(num_nodes: int):
    return powerlaw_graph(num_nodes, avg_degree=AVG_DEGREE, feat_dim=FEAT_DIM,
                          num_classes=NUM_CLASSES, seed=0)


def main_graph(num_nodes: int):
    """The main path's powerlaw graph at ``num_nodes`` on the host,
    generated once a run; each caller gets a copy of its own, so that no
    phase sees what another changed."""
    return copy.deepcopy(_powerlaw_host(num_nodes))


@functools.lru_cache(maxsize=1)
def kernel_graph(num_nodes: int, device: torch.device):
    """The main path's graph as the model sees it: powerlaw + self loops +
    sym norm, with K1's structure."""
    g = main_graph(num_nodes)
    return prepare_spmm(sym_norm(add_self_loops(g)).to(device))


def phase_kernel_check(device: torch.device, num_nodes: int = NUM_NODES,
                       iters: int = 20):
    """K1 against spmm_csr_reference over CSR(A) and CSR(Aᵀ) at F=128 and
    F=47: the kernel the wrapper chooses and each one by name, a second call and a call with the schedule the wrapper builds itself bit
    for bit equal; then the autograd Function against plain autograd.
    Returns one measurement entry per case."""
    g = kernel_graph(num_nodes, device)
    ex = g.extras
    gen = torch.Generator(device=device).manual_seed(0)
    entries = []
    for direction, structure in (("fw", "csr"), ("bw", "csc")):
        ptr, col, w = (ex[f"spmm_{direction}_ptr"], ex[f"spmm_{direction}_col"],
                       ex[f"spmm_{direction}_w"])
        n, nnz = ptr.numel() - 1, col.numel()
        sched = stored_schedule(ex, direction)
        _, structure_s = schedule_build_s(ptr, sched.erow, device)
        chunks, cross_rows = schedule_stats(sched)
        # x rows the structure reads: pad rows are named by no real edge
        x_rows = int(torch.unique(col).numel())
        lib_a = torch.sparse_csr_tensor(ptr, col, w, size=(n, n),
                                        check_invariants=False)
        for feat in (HIDDEN, NUM_CLASSES):
            x = torch.randn(n, feat, generator=gen, device=device)
            def run(kernel=None, schedule=sched):
                return sk.spmm_csr(ptr, col, w, x, structure,
                                   schedule=schedule, kernel=kernel)

            out = run()
            per_call, ran = sk.spmm_csr.cuda_kernels, sk.spmm_csr.kernel
            ref = sk.spmm_csr_reference(ptr, col, w, x)
            scale = sk.spmm_csr_reference(ptr, col, w.abs(), x.abs())
            name = f"spmm_csr[{structure},F={feat}]"
            err = max(scaled_err(o, ref, scale)
                      for o in (out, *(run(k) for k in sk.K1_KERNELS)))
            if not err <= 1.0:
                raise AssertionError(f"{name}: kernel disagrees with its plain "
                                     f"version ({err:.3g} x tolerance)")
            if not (torch.equal(out, run())
                    and torch.equal(out, run(schedule=None))):
                raise AssertionError(
                    f"{name}: a second call, or a call with the schedule the "
                    "wrapper builds, gave other bits")
            b_ms, b_by = bound_ms(n, nnz, feat, x_rows)
            ms = time_ms(run, device, iters)
            lib_ms = time_ms(lambda: torch.sparse.mm(lib_a, x), device, iters)
            entry = {
                "name": name, "route": "cuda", "source": SPMM_SOURCE,
                "replaces": SPMM_REPLACES, "launches": None,
                "case": ["spmm_csr", structure, feat],
                "max_abs_err": float((out - ref).abs().max()),
                "err_over_tol": err,
                "ms": ms,
                "plain_ms": time_ms(
                    lambda: sk.spmm_csr_reference(ptr, col, w, x), device,
                    max(iters // 4, 1)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "rows": n, "x_rows": x_rows, "nnz": nnz, "max_row_nnz": int(
                    (ptr[1:] - ptr[:-1]).max()),
                "kernel": "chunks" if cross_rows else "rows",
                "kernel_ran": ran, "chunk_edges": CHUNK_EDGES, "chunks": chunks,
                "cross_rows": cross_rows,
                "scratch_rows": sched.piece_row.shape[-1],
                "cuda_kernels_per_call": per_call,
                "ms_over_library": ms / lib_ms, "share_of_bound": b_ms / ms,
                "structure_s": structure_s,
                **{f"ms_{k}": time_ms(lambda: run(k), device, iters)
                   for k in sk.K1_KERNELS},
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
    y = sk.SpMMFunction.apply(x, keys[0], keys[1], w, *keys[3:],
                              stored_schedule(ex, "fw"), stored_schedule(ex, "bw"))
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
    g = main_graph(num_nodes)
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


@functools.lru_cache(maxsize=1)
def parity_graph(num_nodes: int):
    """The host graph of the logit parities at ``num_nodes``, built once
    for the phases in a row that use it."""
    return main_graph(num_nodes)


def _logit_parity(tag: str, name: str, device: torch.device, num_nodes: int,
                  **model_kw):
    """The same weights of model ``name`` with dropout off on ``device``
    (the kernels) and on the CPU (their plain versions), through the
    wrapper's ``prepare_graph``; returns the largest logit difference."""
    g = parity_graph(num_nodes)
    model = build_model(name, in_features=FEAT_DIM, out_features=NUM_CLASSES,
                        dropout=0.0, **model_kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    logits = {}
    for dev in (torch.device("cpu"), device):
        m = copy.deepcopy(model).to(dev)
        prepared = NodeClfWrapper(m).prepare_graph(g.to(dev))
        with torch.no_grad():
            logits[dev.type] = m(prepared, training=False)[:num_nodes].cpu()
    ref, out = logits["cpu"], logits[device.type]
    diff = float((out - ref).abs().max())
    print(f"[{tag}] max |logits_{device.type} - logits_cpu| = {diff:.3g}, "
          f"max |logits_cpu| = {float(ref.abs().max()):.3g} "
          f"({num_nodes} nodes, {time.perf_counter() - t0:.1f} s)")
    if not torch.allclose(out, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
        raise AssertionError(f"card {name} logits differ from CPU logits by "
                             f"{diff} ({model_kw})")
    return diff


def phase_parity(device: torch.device, num_nodes: int = NUM_NODES):
    """GCN logits on ``device`` (K1) against the CPU's."""
    return _logit_parity("parity", "gcn", device, num_nodes,
                         hidden_size=HIDDEN)


def _sbm_quality(tag: str, model: str, device: torch.device, epochs: int):
    """Mean test accuracy of ``model`` on ``sbm`` over two seeds, held to the
    bar."""
    results = experiment(dataset="sbm", model=model, epochs=epochs,
                         seed=[0, 1], device=str(device))
    (runs,) = results.values()
    acc = float(np.mean([r["test_acc"] for r in runs]))
    print(f"[{tag}] sbm test_acc {acc:.4f} (bar {SBM_MIN_TEST_ACC})")
    if acc < SBM_MIN_TEST_ACC:
        raise AssertionError(f"{model} sbm test_acc {acc} < "
                             f"{SBM_MIN_TEST_ACC}")
    return acc


def phase_quality(device: torch.device, epochs: int = 100):
    return _sbm_quality("quality", "gcn", device, epochs)


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


def gat_kernels(heads: int):
    """The K3 kernels that take ``heads`` heads, by name."""
    return tuple(k for k in sk.GAT_KERNELS
                 if k != "rows" or heads <= sk.GAT_ROWS_MAX_HEADS)


def gat_single_check(name: str, base, back, sched, seed):
    """K3 single-shot (``base`` = mode, ptr, idx, orig, sd, ss, smax, h2)
    against gat_pass_reference at attention dropout 0 and 0.6: the
    kernel the wrapper chooses and each one by name, every output element
    within ``KERNEL_ATOL + KERNEL_RTOL·Σ|terms|``, the keep masks equal bit
    for bit; a second call, and a call with the schedule the wrapper builds
    itself, equal bit for bit. Returns ``(error over tolerance, largest
    absolute error, CUDA kernels a call, kernel the wrapper ran)``."""
    abs_base = base[:-1] + (base[-1].abs(),)
    heads = base[4].shape[1]
    errs, max_abs, per_call, ran = [], 0.0, 0, None
    for drop in (0.0, GAT_ATTN_DROP):
        kw = dict(alpha=GAT_ALPHA, attn_drop=drop, seed=seed, with_keep=True)
        *refs, keep_ref = sk.gat_pass_reference(*base, *back, **kw)
        # every term is a product with ex·slope·keep >= 0, so the plain
        # pass over |tables| sums the terms' magnitudes
        *scales, _ = sk.gat_pass_reference(*abs_base,
                                           *(b.abs() for b in back), **kw)
        first = sk.gat_pass(*base, *back, schedule=sched, **kw)
        per_call, ran = sk.gat_pass.cuda_kernels, sk.gat_pass.kernel
        runs = [first] + [sk.gat_pass(*base, *back, schedule=sched,
                                      kernel=k, **kw)
                          for k in gat_kernels(heads)]
        for *outs, keep in runs:
            if not torch.equal(keep, keep_ref):
                raise AssertionError(
                    f"{name}: keep mask differs from the plain version's at "
                    f"drop {drop} in {int((keep != keep_ref).sum())} entries")
            errs += [scaled_err(o, r, sc)
                     for o, r, sc in zip(outs, refs, scales)]
            max_abs = max([max_abs] + [float((o - r).abs().max())
                                       for o, r in zip(outs, refs)])
        again = sk.gat_pass(*base, *back, schedule=sched, **kw)
        own = sk.gat_pass(*base, *back, **kw)
        if not all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(first, again, own)):
            raise AssertionError(
                f"{name}: a second call, or a call with the schedule the "
                f"wrapper builds, gave other bits at drop {drop}")
    return max(errs), max_abs, per_call, ran


def phase_gat_kernel_check(device: torch.device, num_nodes: int = NUM_NODES,
                           iters: int = 20, shapes=GAT_SHAPES, graph=None,
                           label: str = ""):
    """K3 against gat_pass_reference in each mode at each ``(heads,
    head_dim)`` of ``shapes`` (the GAT main path's two by default), with
    attention dropout off and at 0.6 (:func:`gat_single_check`):
    every output element within ``KERNEL_ATOL + KERNEL_RTOL·Σ|terms|``, the
    keep masks equal bit for bit, repeat calls and both schedules bit for
    bit. Times each mode and shape at dropout 0.6 (the training passes),
    the kernel the wrapper chooses and each by name, with the host held
    out too (``device_ms``). Over ``graph``'s structure when given (its
    entries' names end in ``label``), else the main path's graph's.
    Returns one measurement entry per mode and shape."""
    g = kernel_graph(num_nodes, device) if graph is None else graph
    ex = g.extras
    gen = torch.Generator(device=device).manual_seed(1)
    seed = torch.tensor([123456789], dtype=torch.int64, device=device)
    entries = []
    for heads, head_dim in shapes:
        t = _gat_inputs(g.n_pad, heads, head_dim, gen, device)
        for mode in sk.GAT_MODES:
            d = "bw" if mode == "dsrc" else "fw"
            ptr, idx, orig = (ex[f"spmm_{d}_{k}"] for k in ("ptr", "col", "orig"))
            sched = stored_schedule(ex, d)
            chunks, cross_rows = schedule_stats(sched)
            back = () if mode == "fwd" else (t["dagg"], t["dden"])
            base = (mode, ptr, idx, orig, t["sd"], t["ss"], t["smax"], t["h2"])
            name = f"gat_pass[{mode},H={heads},D={head_dim}{label}]"
            err, max_abs, per_call, ran = gat_single_check(name, base, back,
                                                           sched, seed)
            if not err <= 1.0:
                raise AssertionError(f"{name}: kernel disagrees with its plain "
                                     f"version ({err:.3g} x tolerance)")
            kw = dict(alpha=GAT_ALPHA, attn_drop=GAT_ATTN_DROP, seed=seed)

            def run(kernel=None):
                return sk.gat_pass(*base, *back, schedule=sched,
                                   kernel=kernel, **kw)

            nnz = idx.numel()
            x_rows = int(torch.unique(idx).numel())
            own_rows = int((ptr[1:] > ptr[:-1]).sum())
            b_ms, b_by = gat_bound_ms(mode, g.n_pad, nnz, x_rows, own_rows,
                                      heads, head_dim, drop=True)
            ms = time_ms(run, device, iters)
            device_ms, host_us = time_device_ms(run, device, iters)
            entry = {
                "name": name, "route": "cuda", "source": GAT_SOURCE,
                "replaces": GAT_REPLACES, "launches": None,
                "case": ["gat_pass", mode, heads, head_dim],
                "max_abs_err": max_abs, "err_over_tol": err,
                "ms": ms, "device_ms": device_ms,
                "host_us_per_call": host_us,
                "plain_ms": time_ms(
                    lambda: sk.gat_pass_reference(*base, *back, **kw), device,
                    max(iters // 4, 1), warmup=1),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "rows": g.n_pad, "x_rows": x_rows, "own_rows": own_rows,
                "nnz": nnz, "attn_drop": GAT_ATTN_DROP,
                "max_row_nnz": int((ptr[1:] - ptr[:-1]).max()),
                "kernel": "chunks" if cross_rows else "rows",
                "kernel_ran": ran, "chunk_edges": CHUNK_EDGES,
                "chunks": chunks, "cross_rows": cross_rows,
                "scratch_rows": sched.piece_row.shape[-1],
                "cuda_kernels_per_call": per_call,
                "share_of_bound": b_ms / ms,
                **{f"ms_{k}": time_ms(lambda: run(k), device, iters)
                   for k in gat_kernels(heads)},
            }
            print(f"[gat-kernel] {json.dumps(entry)}")
            entries.append(entry)
    return entries


def phase_gat_autograd(device: torch.device, num_nodes: int = NUM_NODES,
                       n_panels: int = 0):
    """GATFusedFunction (K3) against plain autograd through the unfused
    route (gather, edge_softmax, mh_spmm) at dropout 0, both shapes: the
    output and the grads of sd and h (through ss = Σ_d a_src·h), each within
    ``KERNEL_ATOL + LOGIT_RTOL·max|plain|``. With ``n_panels`` the Function
    takes its panel route (K3 accumulating) over that many source panels.
    Returns the errors over tolerance."""
    g = kernel_graph(num_nodes, device)
    ex = g.extras if not n_panels else prepare_spmm_device(
        g, with_orig=True, panel_rows=-(-g.n_pad // n_panels)).extras
    keys = [ex.get(f"spmm_{d}_{k}") for d in ("fw", "bw")
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
                    sd, ss, h.view(n, -1), *keys, None, GAT_ALPHA, 0.0,
                    stored_schedule(ex, "fw"), stored_schedule(ex, "bw"))
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
    print(f"[gat-autograd] panels={n_panels} err/tol {json.dumps(report)}")
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
    g = main_graph(num_nodes)
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
    """GAT logits on ``device`` (fused route, K3) against the CPU's (unfused
    route)."""
    return _logit_parity("gat-parity", "gat", device, num_nodes,
                         hidden_size=GAT_HEAD_DIM, nhead=GAT_HEADS,
                         attn_drop=0.0)


def phase_gat_quality(device: torch.device, epochs: int = 100):
    return _sbm_quality("gat-quality", "gat", device, epochs)


# ---------------------------------------------------------------------------
# The products-scale slice: K2, K3 accumulating, the panel structure, bench
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _panel_stats(ptr: torch.Tensor, col: torch.Tensor):
    """``(nnz, x_rows, own_rows)`` of one panel: its edges, the distinct
    neighbour rows they name and the grouping rows that have an edge."""
    lo, hi = int(ptr[0]), int(ptr[-1])
    return (hi - lo, int(torch.unique(col[lo:hi]).numel()),
            int((ptr[1:] > ptr[:-1]).sum()))


def accum_check(ptrs, col, w, x, acc0, structure: str, device: torch.device,
                sched=None):
    """K2 panel by panel from the non-zero ``acc0`` against its plain
    version run the same way, with the panel structure's schedule ``sched``
    or, without one, the schedule the wrapper builds. After every call the
    rows without an edge in the panel must hold what they held, bit for bit.
    Returns ``(acc, error over tolerance, largest absolute error, plain ms
    per sweep)``; the tolerance is relative to ``|acc0| + Σ|w·x|`` of each
    element."""
    acc, ref, scale = acc0.clone(), acc0.clone(), acc0.abs()
    xa, wa = x.abs(), w.abs()
    plain_ms = 0.0
    for p, ptr in enumerate(ptrs):
        untouched = ptr[1:] == ptr[:-1]
        before = acc[untouched]
        sk.spmm_csr_accum(acc, ptr, col, w, x, structure,
                          schedule=sched and sched.panel(p))
        if not torch.equal(acc[untouched], before):
            raise AssertionError(f"spmm_csr_accum[{structure}]: panel {p} "
                                 "changed rows it has no edge for")
        del before
        _sync(device)
        t0 = time.perf_counter()
        sk.spmm_csr_accum_reference(ref, ptr, col, w, x)
        _sync(device)
        plain_ms += (time.perf_counter() - t0) * 1e3
        sk.spmm_csr_accum_reference(scale, ptr, col, wa, xa)
    return (acc, scaled_err(acc, ref, scale), float((acc - ref).abs().max()),
            plain_ms)


def _panel_graph(num_nodes: int, device: torch.device, n_panels: int):
    """The 100k kernel graph with a panel structure of ``n_panels`` source
    panels in both directions (it is directed, so the transpose is built)."""
    g = kernel_graph(num_nodes, device)
    return g, prepare_spmm_device(g, panel_rows=-(-g.n_pad // n_panels))


def phase_accum_kernel_check(device: torch.device, num_nodes: int = NUM_NODES,
                             n_panels: int = CHECK_PANELS):
    """K2 against spmm_csr_accum_reference over the panels of CSR(A) and
    CSR(Aᵀ) at F=128 and F=47 from a non-zero accumulator, and the sum over the panels against one K1
    call on the unpanelled CSR. Returns the errors over tolerance."""
    g, gp = _panel_graph(num_nodes, device, n_panels)
    gen = torch.Generator(device=device).manual_seed(3)
    report = {}
    for direction, structure in (("fw", "csr"), ("bw", "csc")):
        ptrs, col, w = (gp.extras[f"spmm_{direction}_{k}"]
                        for k in ("ptr", "col", "w"))
        one = [g.extras[f"spmm_{direction}_{k}"] for k in ("ptr", "col", "w")]
        if ptrs.shape[0] < n_panels:
            raise AssertionError(f"{ptrs.shape[0]} panels, wanted {n_panels}")
        for feat in (HIDDEN, NUM_CLASSES):
            x = torch.randn(g.n_pad, feat, generator=gen, device=device)
            acc0 = torch.randn(g.n_pad, feat, generator=gen, device=device)
            acc, err, _, _ = accum_check(
                ptrs, col, w, x, acc0, structure, device,
                stored_schedule(gp.extras, direction))
            total = sk.spmm_csr(*one, x, structure,
                                schedule=stored_schedule(g.extras, direction))
            scale = acc0.abs() + sk.spmm_csr_reference(
                one[0], one[1], one[2].abs(), x.abs())
            report[f"{structure},F={feat}"] = {
                "vs_plain": err,
                "vs_one_k1_call": scaled_err(acc - acc0, total, scale)}
    print(f"[accum-kernel] panels={n_panels} err/tol {json.dumps(report)}")
    if not max(max(r.values()) for r in report.values()) <= 1.0:
        raise AssertionError(f"spmm_csr_accum disagrees: {report}")
    return report


def phase_panel_autograd(device: torch.device, num_nodes: int = NUM_NODES,
                         n_panels: int = CHECK_PANELS):
    """SpMMPanelFunction (K2) against plain autograd over the same
    panel-major edge list: y, dX and dw within
    ``KERNEL_ATOL + KERNEL_RTOL·Σ|terms|``. Returns the errors over
    tolerance."""
    g, gp = _panel_graph(num_nodes, device, n_panels)
    keys = [gp.extras[f"spmm_{d}_{k}"] for d in ("fw", "bw")
            for k in ("ptr", "col", "w")]
    gen = torch.Generator(device=device).manual_seed(4)
    x = torch.randn(g.n_pad, NUM_CLASSES, generator=gen, device=device,
                    requires_grad=True)
    w = keys[2].clone().requires_grad_(True)
    probe = torch.randn(g.n_pad, NUM_CLASSES, generator=gen, device=device)
    y = sk.SpMMPanelFunction.apply(
        x, keys[0], keys[1], w, *keys[3:], stored_schedule(gp.extras, "fw"),
        stored_schedule(gp.extras, "bw"))
    dx, dw = torch.autograd.grad((y * probe).sum(), (x, w))
    row = torch.cat([sk.panel_edges(ptr)[1] for ptr in keys[0]])
    col = keys[1].long()

    def plain(xv, wv):
        return torch.zeros_like(xv).index_add(0, row, xv[col] * wv[:, None])

    x_ref = x.detach().clone().requires_grad_(True)
    w_ref = keys[2].clone().requires_grad_(True)
    y_ref = plain(x_ref, w_ref)
    dx_ref, dw_ref = torch.autograd.grad((y_ref * probe).sum(), (x_ref, w_ref))
    xa, wa, pa = x.detach().abs(), keys[2].abs(), probe.abs()
    errs = {"y": scaled_err(y, y_ref, plain(xa, wa)),
            "dx": scaled_err(dx, dx_ref, torch.zeros_like(xa).index_add(
                0, col, pa[row] * wa[:, None])),
            "dw": scaled_err(dw, dw_ref, (pa[row] * xa[col]).sum(-1))}
    print(f"[panel-autograd] panels={n_panels} err/tol {json.dumps(errs)}")
    if not max(errs.values()) <= 1.0:
        raise AssertionError(f"SpMMPanelFunction disagrees with plain "
                             f"autograd: {errs}")
    return errs


def gat_accum_check(mode: str, ptrs, idx, t, drop: float, seed, gen,
                    device: torch.device, with_keep: bool,
                    plain_dtype: torch.dtype = torch.float32, sched=None,
                    acc0=None):
    """K3's accumulating form (coordinate-keyed dropout) panel by panel from
    non-zero accumulators (``acc0``, else drawn from ``gen``) against its
    plain version run the same way, with the panel structure's schedule
    ``sched`` or, without one, the schedule the wrapper builds; rows
    without an edge in a panel must keep their values bit for bit and, with
    ``with_keep``, the keep masks must be equal. Returns ``(accumulators,
    error over tolerance, largest absolute error, plain ms per sweep)``; the
    tolerance is relative to ``|acc0| + Σ|terms|`` of each element.

    ``plain_dtype``: the type the plain version runs in, on the same inputs.
    At the products shape it is float64: there the float32 ``index_add_``
    of the plain version, 677,146 positive terms into one row of the
    denominator, is itself 20 times the tolerance away from the float64
    sum, while the kernel is within 0.11 of it (NVIDIA H100 80GB HBM3,
    700.00 W)."""
    n, heads = t["sd"].shape
    hd = t["h2"].shape[1]
    acc = tuple(a.clone() for a in acc0) if acc0 is not None else tuple(
        torch.randn(n, wd, generator=gen, device=device)
        for wd in sk.gat_output_widths(mode, heads, hd))
    ref = tuple(a.to(plain_dtype, copy=True) for a in acc)
    scale = tuple(a.abs().to(plain_dtype) for a in acc)
    back = () if mode == "fwd" else (t["dagg"], t["dden"])
    base = (t["sd"], t["ss"], t["smax"])
    kw = dict(alpha=GAT_ALPHA, attn_drop=drop, seed=seed, coord_key=True)
    pt = {k: v.to(plain_dtype) for k, v in t.items()}
    p_back = () if mode == "fwd" else (pt["dagg"], pt["dden"])
    p_base = (pt["sd"], pt["ss"], pt["smax"])
    plain_ms = 0.0
    for p, ptr in enumerate(ptrs):
        untouched = ptr[1:] == ptr[:-1]
        before = [a[untouched] for a in acc]
        outs = sk.gat_pass(mode, ptr, idx, None, *base, t["h2"], *back,
                           acc=acc, with_keep=with_keep,
                           schedule=sched and sched.panel(p), **kw)
        if not all(torch.equal(a[untouched], b) for a, b in zip(acc, before)):
            raise AssertionError(f"gat_pass[{mode}]: panel {p} changed rows "
                                 "it has no edge for")
        del before
        _sync(device)
        t0 = time.perf_counter()
        refs = sk.gat_pass_reference(mode, ptr, idx, None, *p_base, pt["h2"],
                                     *p_back, acc=ref, with_keep=with_keep,
                                     **kw)
        _sync(device)
        plain_ms += (time.perf_counter() - t0) * 1e3
        if with_keep and not torch.equal(outs[-1], refs[-1]):
            raise AssertionError(
                f"gat_pass[{mode}]: panel {p}'s keep mask differs from the "
                f"plain version's at drop {drop}")
        del outs, refs
        # every term is a product with ex·slope·keep >= 0, so the plain
        # pass over |tables| sums the terms' magnitudes
        sk.gat_pass_reference(mode, ptr, idx, None, *p_base, pt["h2"].abs(),
                              *(b.abs() for b in p_back), acc=scale, **kw)
    errs = [scaled_err(a.to(plain_dtype), r, sc)
            for a, r, sc in zip(acc, ref, scale)]
    max_abs = max(float((a - r).abs().max()) for a, r in zip(acc, ref))
    return acc, max(errs), max_abs, plain_ms


def phase_gat_accum_check(device: torch.device, num_nodes: int = NUM_NODES,
                          n_panels: int = CHECK_PANELS):
    """K3's accumulating form against gat_pass_reference in each mode at
    both GAT shapes, attention dropout off and at 0.6, over ``n_panels``
    panels of the 100k graph: sums within ``KERNEL_ATOL +
    KERNEL_RTOL·Σ|terms|``, coordinate-keyed keep masks equal bit for bit.
    Returns the errors over tolerance."""
    g = kernel_graph(num_nodes, device)
    gp = prepare_spmm_device(g, with_orig=True,
                             panel_rows=-(-g.n_pad // n_panels))
    gen = torch.Generator(device=device).manual_seed(5)
    seed = torch.tensor([987654321], dtype=torch.int64, device=device)
    report = {}
    for heads, head_dim in GAT_SHAPES:
        t = _gat_inputs(g.n_pad, heads, head_dim, gen, device)
        for mode in sk.GAT_MODES:
            d = "bw" if mode == "dsrc" else "fw"
            ptrs, idx = gp.extras[f"spmm_{d}_ptr"], gp.extras[f"spmm_{d}_col"]
            report[f"{mode},H={heads},D={head_dim}"] = max(
                gat_accum_check(mode, ptrs, idx, t, drop, seed, gen, device,
                                with_keep=True,
                                sched=stored_schedule(gp.extras, d))[1]
                for drop in (0.0, GAT_ATTN_DROP))
    print(f"[gat-accum] panels={n_panels} err/tol {json.dumps(report)}")
    if not max(report.values()) <= 1.0:
        raise AssertionError(f"accumulating gat_pass disagrees: {report}")
    return report


def phase_panel_sweep(device: torch.device, nodes: int = PRODUCTS_NODES,
                      avg_degree: int = PRODUCTS_AVG_DEGREE,
                      panels=SWEEP_PANELS, steps: int = 2,
                      split_at: int = SPLIT_PANELS):
    """GCN train step without the propagation cache at the products shape
    over structures of 1 panel (one-shot K1, ``panel_rows=0``) and of more
    (K2): one warm-up step, then ``steps`` timed. Recorded, no limit; what
    ``device_layout`` says of its default panel count is read off this table. At
    ``split_at`` panels the row also holds :func:`accum_hub_split`."""
    g = powerlaw_graph_device(nodes, avg_degree=avg_degree, feat_dim=FEAT_DIM,
                              device=device)
    args = bench.parse_args(["--model", "gcn", "--no-prop-cache", "--warmup",
                             "1", "--steps", str(steps), "--repeats", "1"])
    rows = []
    for n_panels in panels:
        pr = 0 if n_panels == 1 else -(-g.n_pad // n_panels)
        _sync(device)
        t0 = time.perf_counter()
        gp = prepare_spmm_device(g, symmetric=True, panel_rows=pr)
        _sync(device)
        build_s = time.perf_counter() - t0
        model, opt = bench.make_model(args, gp, device)
        gen = torch.Generator(device=device).manual_seed(0)
        sk.reset_launch_counts()
        dt = bench.time_steps(model, opt, gp, args, gen)
        one_shot = sk.spmm_csr.launches > 0
        if device.type == "cuda" and one_shot != (n_panels == 1):
            raise AssertionError(f"sweep at {n_panels} panels launched K1 "
                                 f"{sk.spmm_csr.launches} times")
        row = {"panels": n_panels, "panel_rows": pr,
               "slice_mb_f128": (pr or g.n_pad) * HIDDEN * 4 / 1e6,
               "kernel": "K1" if n_panels == 1 else "K2",
               "step_ms_no_cache": dt * 1e3, "structure_s": build_s}
        print(f"[sweep] {json.dumps(row)}")
        if n_panels == split_at:
            row["hub_split"] = accum_hub_split(gp.extras, g.n_pad, device)
        rows.append(row)
        del gp, model, opt
    return rows


def phase_gat_panel_sweep(device: torch.device, nodes: int = PRODUCTS_NODES,
                          avg_degree: int = PRODUCTS_AVG_DEGREE,
                          panels=GAT_SWEEP_PANELS, steps: int = 2):
    """GAT train step (attention dropout 0.6) at the products shape over
    structures of 1 panel (single-shot K3, ``panel_rows=0``) and of more
    (K3 accumulating, P calls a mode, shape and step): one warm-up step,
    then
    ``steps`` timed. Recorded, no limit, as :func:`phase_panel_sweep`
    records GCN's; what ``device_layout`` says of its default panel count
    is read off both tables."""
    g = powerlaw_graph_device(nodes, avg_degree=avg_degree, feat_dim=FEAT_DIM,
                              device=device)
    args = bench.parse_args(["--model", "gat", "--attn-drop",
                             str(GAT_ATTN_DROP), "--warmup", "1", "--steps",
                             str(steps), "--repeats", "1"])
    rows = []
    for n_panels in panels:
        pr = 0 if n_panels == 1 else -(-g.n_pad // n_panels)
        _sync(device)
        t0 = time.perf_counter()
        gp = prepare_spmm_device(g, symmetric=True, with_orig=True,
                                 panel_rows=pr)
        _sync(device)
        build_s = time.perf_counter() - t0
        model, opt = bench.make_model(args, gp, device)
        gen = torch.Generator(device=device).manual_seed(0)
        sk.reset_launch_counts()
        dt = bench.time_steps(model, opt, gp, args, gen)
        want = n_panels * (steps + 1) * (device.type == "cuda")
        got = dict(sk.gat_pass.launches_by)
        if set(got.values()) - {want} or (
                sk.spmm_csr.launches + sk.spmm_csr_accum.launches):
            raise AssertionError(f"GAT sweep at {n_panels} panels launched "
                                 f"K3 {got}, K1/K2 {sk.spmm_csr.launches} / "
                                 f"{sk.spmm_csr_accum.launches} times")
        row = {"panels": int(gp.extras["spmm_fw_ptr"].shape[0])
               if pr else 1, "panel_rows": pr,
               "kernel": "K3" if n_panels == 1 else "K3 accumulating",
               "step_ms": dt * 1e3, "structure_s": build_s}
        print(f"[gat-sweep] {json.dumps(row)}")
        rows.append(row)
        del gp, model, opt
    return rows


def _accum_entries(ex, n_pad: int, device: torch.device, iters: int, launches):
    """K2 at the main path's structure, F=128 and F=47: held against its
    plain version panel by panel, then each panel timed by itself (kernel,
    ``torch.sparse.addmm`` on the panel's CSR). ``ms`` and the other times
    and the bound are means per launch, i.e. per panel; the sweep over all
    panels is beside them."""
    ptrs, col, w = ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_w"]
    n_panels = ptrs.shape[0]
    sched = stored_schedule(ex, "fw")
    _, structure_s = schedule_build_s(ptrs, sched.erow, device)
    chunks, cross_rows = schedule_stats(sched)
    stats = [_panel_stats(ptr, col) for ptr in ptrs]
    gen = torch.Generator(device=device).manual_seed(6)
    entries = []
    for feat in (HIDDEN, NUM_CLASSES):
        x = torch.randn(n_pad, feat, generator=gen, device=device)
        acc0 = torch.randn(n_pad, feat, generator=gen, device=device)
        acc, err, max_abs, plain_ms = accum_check(ptrs, col, w, x, acc0,
                                                  "csr", device, sched)
        name = f"spmm_csr_accum[F={feat}]"
        if not err <= 1.0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({err:.3g} x tolerance)")
        del acc0
        ms_by_panel, lib_by_panel, per_call = [], [], []
        for p, ptr in enumerate(ptrs):
            ms_by_panel.append(time_ms(
                lambda: sk.spmm_csr_accum(acc, ptr, col, w, x, "csr",
                                          schedule=sched.panel(p)),
                device, iters, warmup=1))
            per_call.append(sk.spmm_csr_accum.cuda_kernels)
            lo, hi = int(ptr[0]), int(ptr[-1])
            lib_a = torch.sparse_csr_tensor(ptr - lo, col[lo:hi], w[lo:hi],
                                            size=(n_pad, n_pad),
                                            check_invariants=False)
            lib_by_panel.append(time_ms(
                lambda: torch.sparse.addmm(acc, lib_a, x), device, iters,
                warmup=1))
            del lib_a
        bounds = [accum_bound_ms(n_pad, nnz, feat, x_rows, own)
                  for nnz, x_rows, own in stats]
        entry = {
            "name": name, "route": "cuda", "source": ACCUM_SOURCE,
            "replaces": ACCUM_REPLACES,
            "launches": sum(v for (_, f), v in launches.items() if f == feat),
            "max_abs_err": max_abs, "err_over_tol": err,
            "ms": sum(ms_by_panel) / n_panels,
            "plain_ms": plain_ms / n_panels,
            "bound_ms": sum(b for b, _ in bounds) / n_panels,
            "bound_by": ("bytes" if all(by == "bytes" for _, by in bounds)
                         else "operations"),
            "library_ms": sum(lib_by_panel) / n_panels,
            "panels": n_panels, "sweep_ms": sum(ms_by_panel),
            "ms_panel_min": min(ms_by_panel), "ms_panel_max": max(ms_by_panel),
            "library_sweep_ms": sum(lib_by_panel),
            "rows": n_pad, "nnz": sum(st[0] for st in stats),
            "nnz_panel_min": min(st[0] for st in stats),
            "nnz_panel_max": max(st[0] for st in stats),
            "max_row_nnz": int((ptrs[:, 1:] - ptrs[:, :-1]).max()),
            "chunk_edges": CHUNK_EDGES, "chunks": chunks,
            "cross_rows": cross_rows,
            "scratch_rows": sched.piece_row.shape[-1],
            "cuda_kernels_per_call": max(per_call),
            "cuda_kernels_sweep": sum(per_call),
            "ms_over_library": sum(ms_by_panel) / sum(lib_by_panel),
            "share_of_bound": sum(b for b, _ in bounds) / sum(ms_by_panel),
            "structure_s": structure_s,
        }
        print(f"[products-kernel] {json.dumps(entry)}")
        entries.append(entry)
        del x, acc
    return entries


def accum_chunk_sweep(ex, n_pad: int, device: torch.device,
                      chunk_edges=SWEEP_CHUNK_EDGES, iters: int = 2):
    """K2's sweep over all panels of the structure at each chunk size and
    both widths, the schedule rebuilt for each (recorded, no limit)."""
    ptrs, col, w = ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_w"]
    erow = ex["spmm_fw_erow"]
    gen = torch.Generator(device=device).manual_seed(9)
    rows = []
    for feat in (HIDDEN, NUM_CLASSES):
        x = torch.randn(n_pad, feat, generator=gen, device=device)
        acc = torch.zeros(n_pad, feat, device=device)
        for t_edges in chunk_edges:
            sched, build_s = schedule_build_s(ptrs, erow, device, t_edges)

            def sweep():
                for p, ptr in enumerate(ptrs):
                    sk.spmm_csr_accum(acc, ptr, col, w, x, "csr",
                                      schedule=sched.panel(p))

            chunks, cross_rows = schedule_stats(sched)
            row = {"kernel": "spmm_csr_accum", "F": feat,
                   "chunk_edges": t_edges, "chunks": chunks,
                   "cross_rows": cross_rows, "panels": ptrs.shape[0],
                   "sweep_ms": time_ms(sweep, device, iters, warmup=1),
                   "structure_s": build_s}
            print(f"[chunk-sweep] {json.dumps(row)}")
            rows.append(row)
            del sched
        del x, acc
    return rows


def accum_hub_split(ex, n_pad: int, device: torch.device, iters: int = 5):
    """What a panel's time is made of under each design, on the middle
    panel of the structure at F=128 and F=47 (recorded, no limit). The
    row-a-warp K1 kernel stands for a K2 that gives a row to a warp (it is
    that loop without the read-modify-write, and it writes zeros into the
    rows without an edge, which such a K2 would leave alone): the panel as
    it is, the panel without its longest row's edges (what is saved is the
    hub slice), and a structure of as many rows with no edge at all (what
    remains is the warps that read two row pointers, write a row of zeros
    and leave). Beside them the chunk kernel on the first two."""
    ptrs, col, w = ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_w"]
    ptr = ptrs[ptrs.shape[0] // 2]
    lo, hi = int(ptr[0]), int(ptr[-1])
    lens = ptr[1:] - ptr[:-1]
    hub = int(lens.argmax())
    a, b = int(ptr[hub]) - lo, int(ptr[hub + 1]) - lo
    keep = torch.ones(hi - lo, dtype=torch.bool, device=device)
    keep[a:b] = False
    cases = {"panel": (ptr - lo, col[lo:hi].contiguous(),
                       w[lo:hi].contiguous())}
    cut = (ptr - lo).clone()
    cut[hub + 1:] -= b - a
    cases["panel_without_hub_row"] = (cut, cases["panel"][1][keep],
                                      cases["panel"][2][keep])
    cases["rows_without_edges"] = (torch.zeros_like(ptr), col[:0], w[:0])
    gen = torch.Generator(device=device).manual_seed(10)
    report = {"panel": ptrs.shape[0] // 2, "nnz": hi - lo,
              "hub_row_nnz": b - a, "rows": n_pad,
              "rows_with_edge": int((lens > 0).sum())}
    for feat in (HIDDEN, NUM_CLASSES):
        x = torch.randn(n_pad, feat, generator=gen, device=device)
        for name, (cptr, ccol, cw) in cases.items():
            sched = build_spmm_schedule(cptr)
            for kernel in ("rows", "chunks"):
                if kernel == "chunks" and name == "rows_without_edges":
                    continue
                report[f"{name},F={feat},{kernel}_ms"] = time_ms(
                    lambda: sk.spmm_csr(cptr, ccol, cw, x, "csr",
                                        schedule=sched, kernel=kernel),
                    device, iters, warmup=1)
        del x
    print(f"[hub-split] {json.dumps(report)}")
    return report


def _gat_accum_entries(ex, n_pad: int, device: torch.device, iters: int,
                       launches):
    """K3's accumulating form at the main path's structure, every mode at
    both GAT shapes with attention dropout 0.6: held against its plain
    version (run in float64, see :func:`gat_accum_check`) panel by panel,
    then each panel timed by itself, on the stored schedule. Times and bound
    are means per launch, i.e. per panel; the sweep over all panels is
    beside them."""
    ptrs, idx = ex["spmm_fw_ptr"], ex["spmm_fw_col"]
    n_panels = ptrs.shape[0]
    sched = stored_schedule(ex, "fw")
    chunks, cross_rows = schedule_stats(sched)
    stats = [_panel_stats(ptr, idx) for ptr in ptrs]
    gen = torch.Generator(device=device).manual_seed(7)
    seed = torch.tensor([192837465], dtype=torch.int64, device=device)
    entries = []
    for heads, head_dim in GAT_SHAPES:
        t = _gat_inputs(n_pad, heads, head_dim, gen, device)
        hd = heads * head_dim
        for mode in sk.GAT_MODES:
            name = f"gat_pass_accum[{mode},H={heads},D={head_dim}]"
            _, err, max_abs, plain_ms = gat_accum_check(
                mode, ptrs, idx, t, GAT_ATTN_DROP, seed, gen, device,
                with_keep=False, plain_dtype=torch.float64, sched=sched)
            if not err <= 1.0:
                raise AssertionError(f"{name}: kernel disagrees with its "
                                     f"plain version ({err:.3g} x tolerance)")
            if not entries:
                # recorded, no limit: the same check against the float32
                # plain version, the reason for the float64 one
                err32 = gat_accum_check(mode, ptrs, idx, t, GAT_ATTN_DROP,
                                        seed, gen, device, with_keep=False,
                                        sched=sched)[1]
                print(f"[products-kernel] {name}: {err32:.3g} x tolerance "
                      "from the plain version run in float32")
            acc = tuple(torch.zeros(n_pad, wd, device=device)
                        for wd in sk.gat_output_widths(mode, heads, hd))
            back = () if mode == "fwd" else (t["dagg"], t["dden"])
            kw = dict(alpha=GAT_ALPHA, attn_drop=GAT_ATTN_DROP, seed=seed,
                      coord_key=True, acc=acc)
            ms_by_panel, per_call = [], []
            for p, ptr in enumerate(ptrs):
                ms_by_panel.append(time_ms(
                    lambda: sk.gat_pass(mode, ptr, idx, None, t["sd"],
                                        t["ss"], t["smax"], t["h2"], *back,
                                        schedule=sched.panel(p), **kw),
                    device, iters, warmup=1))
                per_call.append(sk.gat_pass.cuda_kernels)
            bounds = [gat_bound_ms(mode, n_pad, nnz, x_rows, own, heads,
                                   head_dim, drop=False, accum=True)
                      for nnz, x_rows, own in stats]
            entry = {
                "name": name, "route": "cuda", "source": GAT_SOURCE,
                "replaces": GAT_REPLACES,
                "launches": launches.get((mode, heads, head_dim), 0),
                "max_abs_err": max_abs, "err_over_tol": err,
                "ms": sum(ms_by_panel) / n_panels,
                "plain_ms": plain_ms / n_panels,
                "bound_ms": sum(b for b, _ in bounds) / n_panels,
                "bound_by": ("bytes" if all(by == "bytes" for _, by in bounds)
                             else "operations"),
                "library_ms": None, "panels": n_panels,
                "plain_dtype": "float64",
                "sweep_ms": sum(ms_by_panel),
                "ms_panel_min": min(ms_by_panel),
                "ms_panel_max": max(ms_by_panel),
                "rows": n_pad, "nnz": sum(st[0] for st in stats),
                "max_row_nnz": int((ptrs[:, 1:] - ptrs[:, :-1]).max()),
                "attn_drop": GAT_ATTN_DROP,
                "chunk_edges": CHUNK_EDGES, "chunks": chunks,
                "cross_rows": cross_rows,
                "scratch_rows": sched.piece_row.shape[-1],
                "cuda_kernels_per_call": max(per_call),
                "cuda_kernels_sweep": sum(per_call),
                "share_of_bound": (sum(b for b, _ in bounds)
                                   / sum(ms_by_panel)),
            }
            print(f"[products-kernel] {json.dumps(entry)}")
            entries.append(entry)
            del acc
    return entries


def phase_products(device: torch.device, model: str,
                   nodes: int = PRODUCTS_NODES,
                   avg_degree: int = PRODUCTS_AVG_DEGREE,
                   panel_rows=None, steps: int = PRODUCTS_STEPS,
                   iters: int = 2):
    """The products-scale main path through the functions of
    ``cogdl_tpu_torch.bench``: the graph generated and its panel structure
    built on the device, the raw edges freed, one warm-up step and then
    ``steps`` train steps (GCN with the propagation cache and then without,
    GAT with attention dropout 0.6). Checks that the loss is finite and
    falls, that the backward shares the forward's structure, and on the card
    the exact launch counts: with P panels a GCN step launches K2 P + P
    times with the cache and 2·P + 2·P without, a GAT step K3 2·P times in
    each mode, and neither launches K1. Then holds the path's kernel against
    its plain version at this structure and times it. Returns ``(info,
    kernel entries)``."""
    argv = ["--model", model, "--nodes", str(nodes), "--avg-degree",
            str(avg_degree), "--blocked", "--device", str(device)]
    if (nodes, avg_degree) == (PRODUCTS_NODES, PRODUCTS_AVG_DEGREE):
        argv.append("--products")
    if model == "gat":
        argv += ["--attn-drop", str(GAT_ATTN_DROP)]
    if panel_rows is not None:
        argv += ["--panel-rows", str(panel_rows)]
    args = bench.parse_args(argv)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    graph = bench.make_graph(args, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    ex = graph.extras
    ptrs = ex["spmm_fw_ptr"]
    if ptrs.ndim != 2 or ptrs.shape[0] < 2:
        raise AssertionError(f"{model}: the products path has no panel "
                             f"structure (ptr {tuple(ptrs.shape)})")
    if not all(ex[f"spmm_bw_{k}"] is ex[f"spmm_fw_{k}"]
               for k in ("ptr", "col")):
        raise AssertionError(f"{model}: the backward structure is not the "
                             "forward's")
    if graph.row.numel() != 1 or graph.col.numel() != 1:
        raise AssertionError(f"{model}: the raw edge arrays were not freed")
    n_panels = ptrs.shape[0]
    runs = [("", graph)]
    if model == "gcn":
        t0 = time.perf_counter()
        cached = cache_propagation(graph)
        _sync(device)
        setup_s += time.perf_counter() - t0
        runs = [("cached", cached), ("uncached", graph)]
    net, opt = bench.make_model(args, graph, device)
    gen = torch.Generator(device=device).manual_seed(0)
    info = {"model": model, "nodes": nodes, "edges": graph.num_edges,
            "panels": n_panels,
            "panel_rows": graph.meta_get("spmm_panel_rows"),
            "setup_s": setup_s, "steps": steps}
    kernel = sk.spmm_csr_accum if model == "gcn" else sk.gat_pass
    total = {}
    for label, gr in runs:
        bench.train_steps(net, opt, gr, 1, gen)             # warm-up
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        losses = bench.train_steps(net, opt, gr, steps, gen)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_case = dict(kernel.launches_by)
        if model == "gcn":
            feats = (NUM_CLASSES,) if label == "cached" else (HIDDEN,
                                                              NUM_CLASSES)
            expected = {(s, f): n_panels * steps * on_card
                        for s in ("csr", "csc") for f in feats}
            other = sk.spmm_csr.launches + sk.gat_pass.launches
        else:
            expected = {(m, h, d): n_panels * steps * on_card
                        for m in sk.GAT_MODES for h, d in GAT_SHAPES}
            other = sk.spmm_csr.launches + sk.spmm_csr_accum.launches
        if by_case != {k: v for k, v in expected.items() if v} or other:
            raise AssertionError(
                f"products {model} {label}: launches {by_case} (and {other} "
                f"of other kernels); expected {expected} ({steps} steps, "
                f"{n_panels} panels)")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"products {model} {label}: loss not "
                                 f"finite or not falling: {losses}")
        for k, v in by_case.items():
            total[k] = total.get(k, 0) + v
        key = f"{label}_" if label else ""
        info.update({f"{key}step_ms": step_ms, f"{key}losses": losses,
                     f"{key}launches_per_step": sum(expected.values()) // steps})
    if on_card:
        info["peak_hbm_bytes"] = int(torch.cuda.max_memory_allocated(device))
    print(f"[products] {json.dumps(info)}")
    del net, opt, runs
    entries = (_accum_entries if model == "gcn" else _gat_accum_entries)(
        ex, graph.n_pad, device, iters, total)
    if model == "gcn":
        # the launches counted above are the main path's, not the probes'
        info["chunk_sweep"] = accum_chunk_sweep(ex, graph.n_pad, device,
                                                iters=iters)
    return info, entries


def phase_panel_parity(device: torch.device,
                       num_nodes: int = GAT_PARITY_NODES,
                       n_panels: int = CHECK_PANELS):
    """Logits of a small GCN and GAT over a panel structure on ``device``
    (K2, K3 accumulating) against the CPU run of the same code (their plain
    versions), dropout off; returns the largest differences."""
    g = powerlaw_graph_device(num_nodes, avg_degree=AVG_DEGREE,
                              feat_dim=FEAT_DIM, num_classes=NUM_CLASSES,
                              device="cpu")
    diffs = {}
    for name in ("gcn", "gat"):
        kw = dict(hidden_size=HIDDEN) if name == "gcn" else dict(
            hidden_size=GAT_HEAD_DIM, nhead=GAT_HEADS, attn_drop=0.0)
        model = build_model(name, in_features=FEAT_DIM,
                            out_features=NUM_CLASSES, dropout=0.0, **kw)
        model.reset_parameters(torch.Generator().manual_seed(0))
        logits = {}
        for dev in (torch.device("cpu"), device):
            m = copy.deepcopy(model).to(dev)
            gp = prepare_spmm_device(
                g.to(dev), symmetric=True, with_orig=name == "gat",
                panel_rows=-(-g.n_pad // n_panels))
            if gp.extras["spmm_fw_ptr"].shape[0] < n_panels:
                raise AssertionError("too few panels in the parity graph")
            with torch.no_grad():
                logits[dev.type] = m(gp, training=False)[:num_nodes].cpu()
        ref, out = logits["cpu"], logits[device.type]
        diffs[name] = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"panel {name}: card logits differ from CPU "
                                 f"logits by {diffs[name]}")
    print(f"[panel-parity] max |logits_{device.type} - logits_cpu| = "
          f"{json.dumps(diffs)} ({num_nodes} nodes, {n_panels} panels)")
    return diffs


# ---------------------------------------------------------------------------
# K1 and K2 by edge chunks: adversarial structures and the chunk sweep
# ---------------------------------------------------------------------------

def adversarial_structures(device: torch.device, chunk: int = CHUNK_EDGES,
                           seed: int = 11):
    """Edge lists ``(name, row, col, n)`` built on ``device`` from ``seed``
    that sit on the chunk schedule's edges, ``T`` edges a chunk: a star (one
    row holds every edge); rows of exactly T−1, T, T+1 and 2T edges, a row
    that ends on a chunk boundary, rows without an edge at the start,
    between and at the end; no edge at all; a small power-law graph;
    ``middle_third_unnamed``, whose columns leave the middle third of the
    rows out, so that the middle one of three source panels is empty; and
    ``host_block``, shaped as a host-sampled block: a few rows at the top
    of the frame hold fanout-sized rows (15, then 10 edges), every other row
    (the sink's among them) none, and half the edges read one hub column,
    whose row of the transposed structure is cut across chunks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = chunk

    def edges(lens, n, col_hi=None):
        lens = torch.tensor(lens, device=device)
        row = torch.repeat_interleave(
            torch.arange(lens.numel(), device=device), lens)
        col = torch.randint(0, col_hi or n, (row.numel(),), generator=gen,
                            device=device)
        return row, col, n

    n = 6 * 64
    # T−1, T, T+1 | 2T | T: the fifth row ends on boundary 6T
    mixed = [0, 0, t - 1, t, t + 1, 0, 2 * t, t, 0, 3, 2 * t + 5, 1, 0, 0]
    out = [("star", *edges([0] * 5 + [20 * t + 7], n)),
           ("mixed_rows", *edges(mixed, n)),
           ("no_edge", *edges([0] * n, n))]
    row, col, _ = edges([3] * 100 + [5 * t + 1] + [1] * 50 + [t] * 3, n,
                        col_hi=n // 3)
    col = torch.where(torch.arange(col.numel(), device=device) % 2 == 0,
                      col, col + 2 * (n // 3))
    out.append(("middle_third_unnamed", row, col, n))
    g = powerlaw_graph(n, avg_degree=12, feat_dim=4, num_classes=3, seed=seed)
    E = g.num_edges
    out.append(("powerlaw", g.row[:E].long().to(device),
                g.col[:E].long().to(device), n))
    row, col, _ = edges([15] * 8 + [10] * 16, n)
    hub = torch.arange(col.numel(), device=device) % 2 == 0
    out.append(("host_block", row, torch.where(hub, n // 2, col), n))
    return out


def phase_adversarial(device: torch.device, feats=ADVERSARIAL_FEATS,
                      gat_shapes=ADVERSARIAL_GAT_SHAPES, n_panels: int = 3):
    """K1 (the kernel the wrapper chooses and each one by name) and K2 (over
    ``n_panels`` source panels, from a non-zero accumulator, rows without an
    edge bit-equal after every call) against their plain versions on
    :func:`adversarial_structures`, both directions, every width of
    ``feats``; then K3 in its three modes on the same structures, both
    directions, every shape of ``gat_shapes``, attention dropout 0 and 0.6,
    single-shot (:func:`gat_single_check`) and accumulating over the panels
    (:func:`gat_accum_check`). Hard limits: every element within
    ``KERNEL_ATOL + KERNEL_RTOL·Σ|terms|``; K3's keep masks bit-equal; two
    calls on the same inputs equal bit for bit; the prepared schedule and
    the one the wrapper builds equal bit for bit. Returns the largest error
    over tolerance per structure; the printed line also names the check
    each structure's largest error came from."""
    gen = torch.Generator(device=device).manual_seed(12)
    seed = torch.tensor([55555], dtype=torch.int64, device=device)
    report, worst_at = {}, {}
    for name, row, col, n in adversarial_structures(device):
        wts = torch.randn(row.numel(), generator=gen, device=device)
        worst = [0.0, None]     # largest error over tolerance, its check

        def note(err, check, worst=worst):
            if err > worst[0]:
                worst[:] = [err, check]
        for structure, (r, c) in (("csr", (row, col)), ("csc", (col, row))):
            one = build_spmm_structure(r, c, wts, n, with_orig=True)
            pan = build_spmm_structure(r, c, wts, n,
                                       panel_rows=-(-n // n_panels))
            s_one, s_pan = (SpmmSchedule(*(st[k] for k in SCHEDULE_KEYS))
                            for st in (one, pan))
            if name == "middle_third_unnamed" and structure == "csr" and (
                    int(pan["ptr"][1, -1] - pan["ptr"][1, 0]) != 0):
                raise AssertionError("the middle panel should hold no edge")
            for feat in feats:
                x = torch.randn(n, feat, generator=gen, device=device)
                args = (one["ptr"], one["col"], one["w"], x, structure)
                ref = sk.spmm_csr_reference(*args[:4])
                scale = sk.spmm_csr_reference(one["ptr"], one["col"],
                                              one["w"].abs(), x.abs())
                out = sk.spmm_csr(*args, schedule=s_one)
                same = (torch.equal(out, sk.spmm_csr(*args, schedule=s_one))
                        and torch.equal(out, sk.spmm_csr(*args)))
                for kernel in sk.K1_KERNELS:
                    named = [sk.spmm_csr(*args, schedule=s_one, kernel=kernel)
                             for _ in range(2)]
                    note(scaled_err(named[0], ref, scale),
                         f"spmm_csr[{structure},F={feat},{kernel}]")
                    same = same and torch.equal(*named)
                note(scaled_err(out, ref, scale),
                     f"spmm_csr[{structure},F={feat}]")
                acc0 = torch.randn(n, feat, generator=gen, device=device)
                accs = [accum_check(pan["ptr"], pan["col"], pan["w"], x, acc0,
                                    structure, device, sched)
                        for sched in (s_pan, s_pan, None)]
                note(accs[0][1], f"spmm_csr_accum[{structure},F={feat}]")
                same = same and all(torch.equal(accs[0][0], a[0])
                                    for a in accs[1:])
                if not same:
                    raise AssertionError(
                        f"adversarial {name} [{structure},F={feat}]: a second "
                        "call, or the schedule the wrapper builds, gave "
                        "other bits")
            # K3 in every mode over the same structure: the mode says which
            # end of an edge its row is (dsrc: the source)
            for (heads, head_dim), mode in itertools.product(gat_shapes,
                                                              sk.GAT_MODES):
                t = _gat_inputs(n, heads, head_dim, gen, device)
                back = () if mode == "fwd" else (t["dagg"], t["dden"])
                tag = f"adversarial {name} [{structure},gat_pass[{mode},H=" \
                      f"{heads},D={head_dim}]]"
                err, *_ = gat_single_check(
                    tag, (mode, one["ptr"], one["col"], one["orig"], t["sd"],
                          t["ss"], t["smax"], t["h2"]), back, s_one, seed)
                note(err, tag)
                acc0 = tuple(torch.randn(n, wd, generator=gen, device=device)
                             for wd in sk.gat_output_widths(
                                 mode, heads, heads * head_dim))
                for drop in (0.0, GAT_ATTN_DROP):
                    accs = [gat_accum_check(mode, pan["ptr"], pan["col"], t,
                                            drop, seed, gen, device, True,
                                            sched=sched, acc0=acc0)
                            for sched in (s_pan, s_pan, None)]
                    note(accs[0][1], f"{tag} accumulating, drop {drop}")
                    if not all(torch.equal(a, b) for other in accs[1:]
                               for a, b in zip(accs[0][0], other[0])):
                        raise AssertionError(
                            f"{tag}: accumulating, a second sweep, or one on "
                            f"the schedule the wrapper builds, gave other "
                            f"bits at drop {drop}")
        report[name], worst_at[name] = worst
    print(f"[adversarial] chunk_edges={CHUNK_EDGES} err/tol "
          f"{json.dumps(report)} largest at {json.dumps(worst_at)}")
    if not max(report.values()) <= 1.0:
        raise AssertionError(f"K1/K2/K3 disagree with their plain versions "
                             f"on an adversarial structure: {report}")
    return report


def phase_chunk_sweep(device: torch.device, num_nodes: int = NUM_NODES,
                      chunk_edges=SWEEP_CHUNK_EDGES, iters: int = 20):
    """K1's chunk kernel over CSR(A) and CSR(Aᵀ) of the main path's graph at
    F=128 and F=47 for each chunk size, the schedule rebuilt for each and
    the result held against the plain version (hard limit); times recorded,
    no limit. ``CHUNK_EDGES`` of ``device_layout`` is read off this table
    and K2's, which :func:`phase_products` prints."""
    g = kernel_graph(num_nodes, device)
    ex = g.extras
    gen = torch.Generator(device=device).manual_seed(13)
    rows = []
    for direction, structure in (("fw", "csr"), ("bw", "csc")):
        ptr, col, w, erow = (ex[f"spmm_{direction}_{k}"]
                             for k in ("ptr", "col", "w", "erow"))
        for feat in (HIDDEN, NUM_CLASSES):
            x = torch.randn(g.n_pad, feat, generator=gen, device=device)
            ref = sk.spmm_csr_reference(ptr, col, w, x)
            scale = sk.spmm_csr_reference(ptr, col, w.abs(), x.abs())
            for t_edges in chunk_edges:
                sched, build_s = schedule_build_s(ptr, erow, device, t_edges)

                def run():
                    return sk.spmm_csr(ptr, col, w, x, structure,
                                       schedule=sched, kernel="chunks")

                err = scaled_err(run(), ref, scale)
                if not err <= 1.0:
                    raise AssertionError(
                        f"spmm_csr[{structure},F={feat}] at {t_edges} edges "
                        f"a chunk disagrees with its plain version "
                        f"({err:.3g} x tolerance)")
                chunks, cross_rows = schedule_stats(sched)
                row = {"kernel": "spmm_csr", "structure": structure,
                       "F": feat, "chunk_edges": t_edges, "chunks": chunks,
                       "cross_rows": cross_rows, "err_over_tol": err,
                       "cuda_kernels_per_call": sk.spmm_csr.cuda_kernels,
                       "ms": time_ms(run, device, iters),
                       "structure_s": build_s}
                print(f"[chunk-sweep] {json.dumps(row)}")
                rows.append(row)
    return rows


def tail_report(entries):
    """The ratios that say whether the hub tail is gone, from the kernel
    entries of this run (recorded, no limit): K1 over CSR(Aᵀ) against K1
    over CSR(A) at the same width, and K1 and K2 against the one PyTorch
    call for the same function."""
    by_name = {e["name"]: e for e in entries}
    report = {}
    for feat in (HIDDEN, NUM_CLASSES):
        fw = by_name[f"spmm_csr[csr,F={feat}]"]
        bw = by_name[f"spmm_csr[csc,F={feat}]"]
        k2 = by_name[f"spmm_csr_accum[F={feat}]"]
        report[f"F={feat}"] = {
            "k1_csc_over_csr": bw["ms"] / fw["ms"],
            "k1_csr_over_library": fw["ms_over_library"],
            "k1_csc_over_library": bw["ms_over_library"],
            "k2_sweep_over_library": k2["ms_over_library"]}
    print(f"[tail] {json.dumps(report)}")
    return report


# ---------------------------------------------------------------------------
# The gather probes (K4, K5, K6) and the probe script
# ---------------------------------------------------------------------------

def gather_bound_ms(distinct_rows: int, n_idx: int, n_chunks: int):
    """Least time for one gather-probe call on the H100: the
    ``distinct_rows`` table rows that the indices name read once (512 B
    each), the ``n_idx`` int32 indices read once, one float a chunk written,
    against the HBM rate; one add per gathered float against the fp32 rate.
    Returns ``(ms, "bytes" | "operations")``."""
    nbytes = 512 * distinct_rows + 4 * n_idx + 4 * n_chunks
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 128.0 * n_idx / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gather_onchip_bound_ms(n_idx: int) -> float:
    """Least time for the ``n_idx`` gathered rows (512 B each) to be read
    out of on-chip memory once: what K4 and K5, which serve every slot from
    shared memory or L1, need at the least. Recorded beside ``bound_ms``,
    which stays the bytes bound."""
    return 512.0 * n_idx / ONCHIP_BYTES_PER_S * 1e3


def time_cold_ms(fn, device: torch.device, iters: int = 10) -> float:
    """Mean milliseconds of ``fn`` with a cold L2: a write of
    ``COLD_FLUSH_BYTES`` before each call, CUDA events around the call
    only, every call queued while the stream sleeps (:func:`behind_sleep`)
    so that the events time the card and not the host's enqueue (the host
    clock on the CPU, rehearsal only)."""
    flush = torch.empty(COLD_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    flush.fill_(1.0)
    fn()
    if device.type == "cuda":
        _sync(device)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(iters)]

        def enqueue():
            for start, end in events:
                flush.fill_(1.0)
                start.record()
                fn()
                end.record()

        behind_sleep(enqueue, COLD_SLEEP_MS)
        torch.cuda.synchronize(device)
        return sum(a.elapsed_time(b) for a, b in events) / iters
    total = 0.0
    for _ in range(iters):
        flush.fill_(1.0)
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    return total * 1e3 / iters


def busy_us(spans) -> float:
    """The card's busy time in the profiler's µs: the union of the
    ``(start, end)`` spans, so that operations that overlap (a programmatic
    dependent launch starts before the kernel it waits for ends) count
    once."""
    busy, reach = 0, None
    for lo, hi in sorted(spans):
        if reach is None or lo > reach:
            busy, reach = busy + hi - lo, hi
        elif hi > reach:
            busy, reach = busy + hi - reach, hi
    return busy


def profiler_kernel_ms(fn, device: torch.device, iters: int = 20):
    """Cross-check of a device time: the time ``torch.profiler``'s CUDA
    kernels kept the card busy over ``iters`` calls of ``fn``, per call,
    with the kernels a call and each kernel's own duration a call by
    name. ``profiler_ms`` is None, with the reason, where
    the profiler saw no device time (and on the CPU, where there is
    none)."""
    if device.type != "cuda":
        return {"profiler_ms": None, "profiler_note": "no card (rehearsal)"}
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"profiler_ms": None,
                "profiler_note": "the profiler recorded no device time"}
    by_name = collections.Counter()
    spans = []
    for e in kernels:
        # "void (anonymous namespace)::name<...>(args)" -> "name<...>"
        by_name[e.name.split("::")[-1].split("(")[0]] += (
            e.time_range.elapsed_us() / 1e3 / iters)
        spans.append((e.time_range.start, e.time_range.end))
    return {"profiler_ms": busy_us(spans) / 1e3 / iters,
            "profiler_kernels_per_call": len(kernels) / iters,
            "profiler_ms_by_kernel": dict(by_name)}


def gather_cases(rows: int, gathered: int):
    """One case per gather kernel and size the probe script runs:
    ``(name, stage, source, replaces, entries of idx, index range, kernel,
    plain version, slot -> table row, wrapper, cut)``, the kernel, plain
    version and slot map functions of ``(table, idx)``, ``cut()`` the
    fields that say how the kernel cut its work (K4, K5: from the shapes;
    K6: what its last call on the card used, None before one)."""
    chunk = mg.T
    n_chunks = gathered // chunk

    def tiles(plan):
        return lambda: {"tile_cols": plan[0], "segments": plan[1]}

    cases = [(f"gather_block_sum[T={chunk}]", "B", GATHER_BLOCK_SOURCE,
              GATHER_BLOCK_REPLACES, gathered, chunk,
              lambda t, i: gk.gather_block_sum(t, i, chunk),
              lambda t, i: gk.gather_block_sum_reference(t, i, chunk),
              lambda t, i: gk.window_rows(i, t.shape[0], chunk, chunk),
              gk.gather_block_sum, tiles(gk.block_plan(rows, n_chunks,
                                                       chunk)))]
    for w in mg.WINDOWS:
        cases.append((
            f"gather_window_sum[W={w}]", f"C{w}", GATHER_WINDOW_SOURCE,
            GATHER_WINDOW_REPLACES, gathered, w,
            lambda t, i, w=w: gk.gather_window_sum(t, i, w, chunk),
            lambda t, i, w=w: gk.gather_window_sum_reference(t, i, w, chunk),
            lambda t, i, w=w: gk.window_rows(i, t.shape[0], w, chunk),
            gk.gather_window_sum,
            tiles(gk.window_plan(rows, n_chunks, w, chunk))))
    depth = mg.OUTSTANDING

    def rows_cut():
        grid, segments = gk.gather_rows_sum.plan or (None, None)
        return {"segments": segments, "grid": grid}

    cases.append((
        f"gather_rows_sum[outstanding={depth}]", "D", GATHER_ROWS_SOURCE,
        GATHER_ROWS_REPLACES, mg.stage_case("D", rows, gathered).rows_gathered,
        rows,
        lambda t, i: gk.gather_rows_sum(t, i, chunk, depth),
        lambda t, i: gk.gather_rows_sum_reference(t, i, chunk),
        lambda t, i: i.long(), gk.gather_rows_sum, rows_cut))
    return cases


def phase_gather_kernel_check(device: torch.device, rows: int = mg.N,
                              gathered: int = mg.E, iters: int = 20):
    """K4, K5 (every window) and K6 against their plain versions at the
    probe script's sizes: every chunk's sum within ``KERNEL_ATOL +
    KERNEL_RTOL·Σ|terms|`` of the plain version's (fp32 both, summation
    order only; 131,072 terms a chunk), and the grand total within the same
    bound, over all terms, of the plain version run in float64; a second
    call equal bit for bit. Times the kernel warm over
    ``GATHER_TIMING_TABLES`` copies of the table, each after its own
    warm-up: ``ms``, the median of CUDA events around 20 calls as the host
    queues them (each copy's in ``ms_tables``), and ``device_ms``, the
    median of the same calls queued behind a sleep of the stream so that
    the events time the card alone (:func:`time_device_ms`; each copy's in
    ``device_ms_tables``), with the host's enqueue time a call
    (``host_us_per_call``) and ``torch.profiler``'s kernel durations as a
    cross-check (``profiler_ms``); then with a cold L2 (``ms_cold``), the
    plain version and the one PyTorch call for the same function
    (``index_select`` of the named rows, reshape, ``sum``). Prints the
    card's clocks, temperature and power at the start and the end
    (``[gather-state]``). Returns one measurement entry per case, each with
    its share of the bytes bound (from ``device_ms``), the kernel that ran,
    its CUDA kernels a call and its cut; K4 and K5 also the on-chip
    bound."""
    state = smi_state()
    print(f"[gather-state] start: clocks.sm, clocks.mem, temperature.gpu, "
          f"power.draw = {state}")
    gen = torch.Generator(device=device).manual_seed(8)
    table = torch.randn((rows, 128), generator=gen, device=device)
    entries = []
    for (name, stage, source, replaces, n_idx, hi, kernel, plain,
         named_rows, wrapper, cut) in gather_cases(rows, gathered):
        idx = torch.randint(0, hi, (n_idx,), generator=gen, device=device,
                            dtype=torch.int32)
        n_chunks = n_idx // mg.T
        out = kernel(table, idx)
        again = kernel(table, idx)
        _sync(device)
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: a second call gave other bits")
        ref = plain(table, idx)
        scale = plain(table.abs(), idx)
        err = scaled_err(out, ref, scale)
        total_err = float(
            (out.double().sum() - plain(table.double(), idx).sum()).abs()
            / (KERNEL_ATOL + KERNEL_RTOL * scale.double().sum()))
        if not max(err, total_err) <= 1.0:
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version ({err:.3g} "
                f"x tolerance per chunk, {total_err:.3g} x on the total)")
        named = named_rows(table, idx)
        distinct = int(torch.unique(named).numel())
        b_ms, b_by = gather_bound_ms(distinct, n_idx, n_chunks)
        copies = [table.clone() for _ in range(GATHER_TIMING_TABLES)]
        ms_tables, device_tables, host_us = [], [], []
        for c in copies:
            ms_tables.append(time_ms(lambda c=c: kernel(c, idx), device,
                                     iters))
            d_ms, h_us = time_device_ms(lambda c=c: kernel(c, idx), device,
                                        iters)
            device_tables.append(d_ms)
            host_us.append(h_us)
        del copies
        ms = float(np.median(ms_tables))
        device_ms = float(np.median(device_tables))
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "stage": stage,
            "max_abs_err": float((out - ref).abs().max()),
            "err_over_tol": err, "total_err_over_tol": total_err,
            "ms": ms, "ms_tables": ms_tables,
            "device_ms": device_ms, "device_ms_tables": device_tables,
            "device_ms_by": ("sleep window" if device.type == "cuda"
                             else "host clock (CPU rehearsal)"),
            "host_us_per_call": float(np.median(host_us)),
            "smi_at_start": state,
            "ms_cold": time_cold_ms(lambda: kernel(table, idx), device,
                                    max(iters // 2, 1)),
            "plain_ms": time_ms(lambda: plain(table, idx), device,
                                max(iters // 4, 1), warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(
                lambda: torch.index_select(table, 0, named).view(
                    n_chunks, -1).sum(1), device, max(iters // 4, 1),
                warmup=1),
            "ns_per_row": ms * 1e6 / n_idx,
            "gathered_bytes_per_s": n_idx * 512 / (ms * 1e-3),
            "rows_gathered": n_idx, "chunks": n_chunks,
            "distinct_rows": distinct,
        }
        # last: the profiler's own start and end cost the host time
        entry.update(profiler_kernel_ms(lambda: kernel(table, idx), device,
                                        iters))
        entry.update({"share_of_bound": b_ms / device_ms,
                      "cuda_kernels_per_call": wrapper.cuda_kernels,
                      "kernel_ran": wrapper.kernel, **cut()})
        if wrapper is not gk.gather_rows_sum:   # K4, K5 read on-chip memory
            entry["onchip_bound_ms"] = gather_onchip_bound_ms(n_idx)
        print(f"[gather-kernel] {json.dumps(entry)}")
        entries.append(entry)
        del idx, named, ref, scale, out, again
    print(f"[gather-state] end: clocks.sm, clocks.mem, temperature.gpu, "
          f"power.draw = {smi_state()}")
    return entries


def gather_adversarial_cases(windows=GATHER_ADV_WINDOWS,
                             chunks=GATHER_ADV_CHUNKS,
                             k: int = WINDOWS_IN_TABLE, rows_chunks=None,
                             n_sms: int = NOMINAL_SMS):
    """``(kernel, window, chunk, n_rows, n_chunks)`` of the gather probes'
    adversarial checks: K5 at every window of ``windows`` and K4 (window =
    chunk) at every chunk of ``chunks``, each in a table of ``k`` windows
    and 77 rows (so ``n_rows % window`` is not 0 past window 77, and small
    windows get more of them), with fewer chunks than windows, as many, and
    three times as many and one; then K6 (window = the table) at every
    chunk of ``rows_chunks`` (default ``chunks``) in a table of
    ``GATHER_ADV_ROWS`` rows, with fewer chunks than the card's ``n_sms``
    SMs, as many, and ``3·n_sms + 7``, a multiple of neither the SM count
    nor the grid (a multiple of it)."""
    out = []
    for kernel, spans in (("window", windows), ("block", chunks)):
        for window in spans:
            for chunk in (chunks if kernel == "window" else (window,)):
                n_rows = window * k + 77
                n_windows = n_rows // window
                for n_chunks in (max(n_windows // 2, 1), n_windows,
                                 3 * n_windows + 1):
                    out.append((kernel, window, chunk, n_rows, n_chunks))
    for chunk in (chunks if rows_chunks is None else rows_chunks):
        for n_chunks in (max(n_sms // 2, 1), n_sms, 3 * n_sms + 7):
            out.append(("rows", GATHER_ADV_ROWS, chunk, GATHER_ADV_ROWS,
                        n_chunks))
    return out


def gather_variants(kernel: str, window: int):
    """Every kernel a probe wrapper may start at this window, as keyword
    arguments of the wrapper: K5 at every tile width that fits (each its
    own instantiation), K4 with the carve-out at its least and the CUDA
    driver's default, K6 at every depth."""
    if kernel == "window":
        return [{"tile_cols": tc} for tc in gk.TILE_COLS
                if window * tc * 4 <= gk.MAX_TILE_BYTES]
    if kernel == "rows":
        return [{"outstanding": d} for d in gk.OUTSTANDING]
    return [{"max_l1": max_l1} for max_l1 in (True, False)]


def mid_chunk_ranges(n_chunks: int, chunk: int, plan) -> int:
    """How many of K6's warps, cut by ``plan = (grid, segments)``, walk a
    range of slots that starts and ends inside a chunk."""
    return sum(1 for lo, hi in gk.rows_warp_slots(n_chunks, chunk, *plan)
               if hi > lo and lo % chunk and hi % chunk)


def phase_gather_adversarial(device: torch.device, windows=GATHER_ADV_WINDOWS,
                             chunks=GATHER_ADV_CHUNKS, seed: int = 21,
                             rows_chunks=None, n_sms=None):
    """K4, K5 and K6, every kernel they may run (:func:`gather_variants`),
    against their plain versions on :func:`gather_adversarial_cases`: a
    table whose rows differ by up to six orders of magnitude (a lost or
    doubled row shows), indices that the kernels clamp (−5, the window or
    the table's height, and 2³¹−1) among the drawn ones. K6's cases are cut
    by the card's SM count (``n_sms``, else ``NOMINAL_SMS`` on the CPU);
    on the card at least one of its warps must walk a range that starts and
    ends inside a chunk. Hard limits: every chunk within ``KERNEL_ATOL +
    KERNEL_RTOL·Σ|terms|`` of the plain version; a second call equal bit
    for bit. Returns the largest error over tolerance per kernel and window
    (K6: per chunk size)."""
    on_card = device.type == "cuda"
    if n_sms is None:
        n_sms = (torch.cuda.get_device_properties(device).multi_processor_count
                 if on_card else NOMINAL_SMS)
    gen = torch.Generator(device=device).manual_seed(seed)
    report, mid_chunk = {}, 0
    calls = {"window": gk.gather_window_sum, "block": gk.gather_block_sum,
             "rows": gk.gather_rows_sum}
    for kernel, window, chunk, n_rows, n_chunks in gather_adversarial_cases(
            windows, chunks, rows_chunks=rows_chunks, n_sms=n_sms):
        mag = 10.0 ** torch.randint(-3, 4, (n_rows, 1), generator=gen,
                                    device=device)
        table = torch.randn((n_rows, 128), generator=gen, device=device) * mag
        idx = torch.randint(0, window, (n_chunks * chunk,), generator=gen,
                            device=device, dtype=torch.int32)
        for i, wild in enumerate((-5, window, 2 ** 31 - 1)):
            idx[i::7] = wild
        if kernel == "window":
            def plain(t):
                return gk.gather_window_sum_reference(t, idx, window, chunk)
        elif kernel == "block":
            def plain(t):
                return gk.gather_block_sum_reference(t, idx, chunk)
        else:
            def plain(t):
                return gk.gather_rows_sum_reference(t, idx, chunk)
        ref, scale = plain(table), plain(table.abs())
        for kw in gather_variants(kernel, window):
            tag = (f"gather_{kernel}_sum[W={window},T={chunk},rows={n_rows},"
                   f"chunks={n_chunks},{kw}]")
            args = (window, chunk) if kernel == "window" else (chunk,)
            outs = [calls[kernel](table, idx, *args, **kw) for _ in range(2)]
            if not torch.equal(*outs):
                raise AssertionError(f"{tag}: a second call gave other bits")
            err = scaled_err(outs[0], ref, scale)
            if not err <= 1.0:
                raise AssertionError(
                    f"{tag}: disagrees with its plain version on an "
                    f"adversarial shape ({err:.3g} x tolerance)")
            if kernel == "rows" and on_card:
                mid_chunk += mid_chunk_ranges(n_chunks, chunk,
                                              gk.gather_rows_sum.plan)
            key = (f"rows,T={chunk}" if kernel == "rows"
                   else f"{kernel},W={window}")
            report[key] = max(report.get(key, 0.0), err)
    if on_card and any(k.startswith("rows") for k in report) and not mid_chunk:
        raise AssertionError("K6's adversarial cases cut no warp's range "
                             "inside a chunk at both ends")
    print(f"[gather-adversarial] err/tol {json.dumps(report)}; K6 warps "
          f"walking a range that starts and ends inside a chunk: {mid_chunk}")
    return report


def phase_gather_sweep(device: torch.device, rows: int = mg.N,
                       gathered: int = mg.E, iters: int = 20):
    """Recorded, no limit on time: K5 at each window of the probe script
    over every tile width that fits (the blocks that share an SM beside
    it), K4 with the carve-out at its least and the CUDA driver's, and K6
    at probe stage D's size at every depth (its grid, cut and the blocks
    that fit on a SM beside each), at the probe's sizes; ``ms`` as the host queues the
    calls and ``device_ms`` behind a sleep (:func:`time_device_ms`); each
    result held against the plain version (hard limit). Returns the
    rows."""
    gen = torch.Generator(device=device).manual_seed(9)
    table = torch.randn((rows, 128), generator=gen, device=device)
    on_card = device.type == "cuda"
    d_rows = mg.stage_case("D", rows, gathered).rows_gathered
    out = []
    for kernel, window in ([("block", mg.T)]
                           + [("window", w) for w in mg.WINDOWS]
                           + [("rows", rows)]):
        n_idx = d_rows if kernel == "rows" else gathered
        idx = torch.randint(0, window, (n_idx,), generator=gen,
                            device=device, dtype=torch.int32)
        ref = gk.gather_window_sum_reference(table, idx, window, mg.T)
        scale = gk.gather_window_sum_reference(table.abs(), idx, window, mg.T)
        for kw in gather_variants(kernel, window):
            extra = {}
            if kernel == "window":
                def run(kw=kw):
                    return gk.gather_window_sum(table, idx, window, mg.T, **kw)
                occupancy = (gk.blocks_per_sm("window", window,
                                              kw["tile_cols"])
                             if on_card else None)
            elif kernel == "block":
                def run(kw=kw):
                    return gk.gather_block_sum(table, idx, mg.T, **kw)
                occupancy = gk.blocks_per_sm("block") if on_card else None
            else:
                def run(kw=kw):
                    return gk.gather_rows_sum(table, idx, mg.T, **kw)
                occupancy = None   # what the call used, below
            err = scaled_err(run(), ref, scale)
            if not err <= 1.0:
                raise AssertionError(f"gather sweep {kernel} W={window} {kw}: "
                                     f"disagrees with its plain version "
                                     f"({err:.3g} x tolerance)")
            if kernel == "rows" and on_card:
                grid, segments = gk.gather_rows_sum.plan
                n_sms, fits = gk.rows_occupancy(device.index or 0,
                                                kw["outstanding"])
                occupancy = grid // n_sms
                extra = {"grid": grid, "segments": segments,
                         "fits_per_sm": fits}
            elif kernel == "rows":
                extra = {"grid": None, "segments": None, "fits_per_sm": None}
            d_ms, h_us = time_device_ms(run, device, iters)
            row = {"kernel": kernel, "window": window, **kw,
                   "blocks_per_sm": occupancy, **extra, "err_over_tol": err,
                   "ms": time_ms(run, device, iters), "device_ms": d_ms,
                   "host_us_per_call": h_us}
            print(f"[gather-sweep] {json.dumps(row)}")
            out.append(row)
        del idx, ref, scale
    return out


def phase_gather_path(device: torch.device, rows: int = mg.N,
                      gathered: int = mg.E, iters: int = 20, warmup: int = 3):
    """Every stage of ``cogdl_tpu_torch.scripts.microbench_gather`` through
    its ``run``. On the card each call of a stage launches that stage's
    kernel once and no other kernel (stage A launches none); a CPU run
    launches none. Stages B and C1024 draw the same indices over the same
    table and compute the same sum in two kernels: their totals must agree
    within ``KERNEL_ATOL + KERNEL_RTOL·Σ|terms|``, Σ|terms| taken as its
    expectation for a standard normal table, ``0.8·128·E``. Returns the
    stages' reports and the launches of each stage's kernel."""
    on_card = device.type == "cuda"
    wrappers = (gk.gather_block_sum, gk.gather_window_sum, gk.gather_rows_sum)
    reports, launches = {}, {}
    for stage in mg.STAGES:
        sk.reset_launch_counts()
        rep = mg.run(stage, device, rows, gathered, iters=iters,
                     warmup=warmup)
        mine, key = mg.stage_case(stage)[4:]
        for fn in sk.COUNTED_WRAPPERS:
            want = ({key: rep["calls"]} if fn is mine and on_card else {})
            if dict(fn.launches_by) != want or (
                    fn.launches != sum(want.values())):
                raise AssertionError(
                    f"probe stage {stage}: {fn.__name__} launched "
                    f"{fn.launches} times, {dict(fn.launches_by)}; expected "
                    f"{want} ({rep['calls']} calls)")
        if not np.isfinite(rep["total"]):
            raise AssertionError(f"probe stage {stage}: total not finite")
        if mine in wrappers:
            launches[stage] = mine.launches
        reports[stage] = rep
    b, c = reports["B"]["total"], reports[f"C{mg.T}"]["total"]
    if not abs(b - c) <= KERNEL_ATOL + KERNEL_RTOL * 0.8 * 128 * gathered:
        raise AssertionError(f"probe stages B and C{mg.T} sum the same rows "
                             f"and disagree: {b} vs {c}")
    print(f"[gather-path] {json.dumps({'launches': launches, 'stages': reports})}")
    return {"stages": reports, "launches": launches}


# ---------------------------------------------------------------------------
# Full-batch GraphSAGE
# ---------------------------------------------------------------------------

def phase_sage_main_path(device: torch.device, num_nodes: int = NUM_NODES,
                         epochs: int = MAIN_EPOCHS,
                         sum_epochs: int = SAGE_SUM_EPOCHS):
    """GraphSAGE on the powerlaw graph through experiment() at bench.py's
    widths, dropout 0.5. First ``aggr="mean"``, the default: gather and
    segment mean are torch index ops on every device, so no kernel may be
    launched. Then a short ``aggr="sum"`` run, whose aggregation is ``spmm``:
    on the card every train step launches K1 3 times (each layer's forward
    over the CSR at its input width, F=100 and F=128, and the second layer's
    backward over the CSC; the first layer's input needs no gradient) and
    every evaluation twice. Returns both runs' step times and the K1
    launches of each (structure, F) case."""
    g = main_graph(num_nodes)
    ds = Dataset.from_graph(g, name=f"powerlaw-{num_nodes}")
    on_card = device.type == "cuda"
    info = {}
    for aggr, n_epochs in (("mean", epochs), ("sum", sum_epochs)):
        sk.reset_launch_counts()
        results = experiment(dataset=ds, model="graphsage",
                             hidden_size=HIDDEN, aggr=aggr, epochs=n_epochs,
                             patience=n_epochs + 1, seed=0,
                             device=str(device))
        (runs,) = results.values()
        res = runs[0]
        evals = n_epochs + 1   # one per epoch and the final one
        expected = {}
        if aggr == "sum" and on_card:
            expected = {("csr", FEAT_DIM): n_epochs + evals,
                        ("csr", HIDDEN): n_epochs + evals,
                        ("csc", HIDDEN): n_epochs}
        by_case = dict(sk.spmm_csr.launches_by)
        others = sum(fn.launches for fn in sk.COUNTED_WRAPPERS
                     if fn is not sk.spmm_csr)
        if by_case != expected or others or (
                sk.spmm_csr.launches != sum(expected.values())):
            raise AssertionError(
                f"GraphSAGE aggr={aggr} launched K1 {by_case} and other "
                f"kernels {others} times; expected {expected} ({n_epochs} "
                f"steps, {evals} evaluations)")
        if not np.isfinite(res["train_loss"]):
            raise AssertionError(f"GraphSAGE aggr={aggr} loss is not finite: "
                                 f"{res}")
        info[aggr] = {"train_step_ms": res["train_step_ms"],
                      "eval_ms": res["eval_ms"],
                      "train_loss": res["train_loss"], "epochs": n_epochs,
                      "launches": sk.spmm_csr.launches,
                      "launches_by_case": {f"{s},F={f}": v
                                           for (s, f), v in by_case.items()}}
    print(f"[sage-main] {json.dumps(info)}")
    return info


def phase_sage_parity(device: torch.device,
                      num_nodes: int = GAT_PARITY_NODES):
    """GraphSAGE logits on ``device`` against the CPU's for every
    aggregator (``sum`` and ``gcn`` run K1 on the card); returns the largest
    differences."""
    return {aggr: _logit_parity("sage-parity", "graphsage", device, num_nodes,
                                hidden_size=HIDDEN, aggr=aggr)
            for aggr in SAGE_AGGREGATORS}


def phase_sage_quality(device: torch.device, epochs: int = 100):
    return _sbm_quality("sage-quality", "graphsage", device, epochs)


# ---------------------------------------------------------------------------
# Sampled mini-batch training: the device sampler, GraphSAGE and GAT over
# its blocks, full-batch evaluation
# ---------------------------------------------------------------------------

def _sampled_expected(model: str, aggr, evals: int, on_card: bool):
    """The launches of a sampled run, by counted wrapper and case: none on
    any train step (the blocks carry no kernel structure, and the fanout
    routes are torch reshape-reduces); each full-batch evaluation launches
    what the full-batch model does, K1 for each layer of GraphSAGE ``sum``
    (F=100 and F=128) and K3's fwd for each layer of GAT."""
    if not on_card:
        return {}
    if model == "gat":
        return {"gat_pass": {("fwd", h, d): evals for h, d in GAT_SHAPES}}
    if aggr == "sum":
        return {"spmm_csr": {("csr", f): evals for f in (FEAT_DIM, HIDDEN)}}
    return {}


def _launch_counts():
    """Every counted wrapper's launches since the last reset, by case."""
    return {fn.__name__: dict(fn.launches_by) for fn in sk.COUNTED_WRAPPERS
            if fn.launches}


def phase_sampled_main_path(device: torch.device, num_nodes: int = NUM_NODES,
                            epochs: int = SAMPLED_EPOCHS,
                            batch_size: int = SAMPLED_BATCH,
                            fanouts=SAMPLED_FANOUTS, models=SAMPLED_MODELS):
    """Sampled training through experiment(wrapper="neighbor_sampling_device")
    on the powerlaw graph: GraphSAGE ``mean``, GraphSAGE ``sum`` and GAT,
    each for one epoch and then for ``epochs`` from the same seed. Checks the
    exact launch counts (0 of K1-K6 on every sampled train step, so the
    whole run launches only what its evaluations do: 2 K1 an evaluation for
    ``sum``, 2 K3 fwd for GAT, none for ``mean``; a CPU run none), that the
    losses are finite and that the last epoch's mean loss is below the first
    epoch's. Returns each run's step and evaluation times and losses."""
    g = main_graph(num_nodes)
    ds = Dataset.from_graph(g, name=f"powerlaw-{num_nodes}")
    on_card = device.type == "cuda"
    info = {}
    for label, model, kw in models:
        runs = []
        for n_epochs in (1, epochs):
            sk.reset_launch_counts()
            results = experiment(
                dataset=ds, model=model, wrapper="neighbor_sampling_device",
                fanouts=fanouts, batch_size=batch_size, epochs=n_epochs,
                patience=n_epochs + 1, seed=0, device=str(device), **kw)
            (res,) = next(iter(results.values()))
            counts = _launch_counts()
            expected = _sampled_expected(model, kw.get("aggr"), n_epochs + 1,
                                         on_card)
            if counts != expected:
                raise AssertionError(
                    f"sampled {label} ({n_epochs} epochs) launched {counts}; "
                    f"expected {expected}: none on a train step, the "
                    "full-batch model's on each evaluation")
            if not np.isfinite(res["train_loss"]):
                raise AssertionError(f"sampled {label}: loss not finite: "
                                     f"{res}")
            runs.append(res)
        first, last = runs[0]["train_loss"], runs[1]["train_loss"]
        if not last < first:
            raise AssertionError(f"sampled {label}: the mean loss of epoch "
                                 f"{epochs} ({last}) is not below epoch 1's "
                                 f"({first})")
        res = runs[1]
        info[label] = {
            "train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "losses": [first, last], "epochs": epochs,
            "launches": {k: {",".join(map(str, c)): v for c, v in d.items()}
                         for k, d in counts.items()}}
    print(f"[sampled-main] {json.dumps(info)}")
    return info


def _holed_graph(num_nodes: int, device: torch.device):
    """The powerlaw graph with every ``HOLE_EVERY``-th node's CSR row
    emptied, on ``device``."""
    g = main_graph(num_nodes)
    E, n = g.num_edges, num_nodes
    row, col = g.row[:E].numpy(), g.col[:E].numpy()
    keep = row % HOLE_EVERY != 0
    return from_coo(np.stack([row[keep], col[keep]]), num_nodes=n,
                    x=g.x[:n], y=g.y[:n], train_mask=g.train_mask[:n],
                    meta={"num_classes": NUM_CLASSES}).to(device)


def check_blocks(graph, blocks, frame, seeds: torch.Tensor):
    """What the device sampler promises of one batch, on the batch's device:
    the first B frame rows are the seeds and the rest past the last hop the
    table's sink row; in each block, slot ``e`` of destination ``r`` is
    live exactly when ``frame[r]`` has an edge, a live slot points at its
    own frame row ``n + e`` and ``(frame[r], frame[n + e])`` is an edge of
    the graph, a dead slot points at the frame's sink with weight 0 and its
    frame row repeats ``frame[r]``. Returns the live and dead slot counts."""
    B = seeds.shape[0]
    if not torch.equal(frame[:B], seeds.to(frame.dtype)):
        raise AssertionError("sampled check: the first B frame rows are not "
                             "the seeds")
    E, N = graph.num_edges, graph.n_pad
    keys = torch.sort(graph.row[:E].long() * N + graph.col[:E].long())[0]
    deg = graph.row_ptr[1:] - graph.row_ptr[:-1]
    live = dead = 0
    S = blocks[0].num_nodes
    if not bool((frame[S:] == graph.n_pad - 1).all()):
        raise AssertionError("sampled check: frame padding is not the sink")
    for b in blocks:
        f, n = b.meta_get("fanout"), b.meta_get("frontier")
        e = torch.arange(n * f, device=frame.device)
        u = frame[e // f].long()
        w, c = b.edge_weight[: n * f], b.col[: n * f].long()
        alive = w > 0
        has_edge = deg[u] > 0
        own = frame[n + e].long()
        query = u * N + own
        hit = keys[torch.searchsorted(keys, query).clamp_max(E - 1)] == query
        bad = {
            "live slot without an edge": alive & ~has_edge,
            "dead slot on a destination with an edge": ~alive & has_edge,
            "live slot off its frame row": alive & (c != n + e),
            "sampled pair not an edge": alive & ~hit,
            "dead slot off the sink": ~alive & (c != b.n_pad - 1),
            "dead slot's frame row not its destination": ~alive & (own != u),
            "weight not 0 or 1": (w != 0) & (w != 1),
        }
        for what, m in bad.items():
            if bool(m.any()):
                raise AssertionError(f"sampled check, block of fanout {f}: "
                                     f"{int(m.sum())} x {what}")
        live += int(alive.sum())
        dead += int((~alive).sum())
    return live, dead


def phase_sampled_check(device: torch.device, num_nodes: int = NUM_NODES,
                        batch_size: int = SAMPLED_BATCH,
                        fanouts=SAMPLED_FANOUTS):
    """Blocks drawn on ``device`` at full size from a graph with empty rows
    (:func:`check_blocks`; some dead slots must occur), then the same
    weights of GraphSAGE (each aggregator) and GAT, dropout off, over that
    one block set on ``device`` and on the CPU: logits within rtol 1e-4 /
    atol 1e-4. Returns the slot counts and the largest differences."""
    g = _holed_graph(num_nodes, device)
    sampler = DeviceNeighborSampler(g, fanouts, batch_size=batch_size)
    seeds = torch.from_numpy(sampler.epoch_seeds()[0]).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    blocks, frame = sample_blocks_device(g, seeds, gen, fanouts)
    live, dead = check_blocks(g, blocks, frame, seeds)
    if not dead:
        raise AssertionError("sampled check: no dead slot drawn")
    cpu_blocks = [b.to("cpu") for b in blocks]
    diffs = {}
    for label, model, kw in (
            [(f"sage-{a}", "graphsage", {"hidden_size": HIDDEN, "aggr": a})
             for a in SAGE_AGGREGATORS]
            + [("gat", "gat", {"hidden_size": GAT_HEAD_DIM,
                               "nhead": GAT_HEADS, "attn_drop": 0.0})]):
        net = build_model(model, in_features=FEAT_DIM,
                          out_features=NUM_CLASSES, dropout=0.0, **kw)
        net.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():
            ref = net(cpu_blocks, frame_features(cpu_blocks))
            out = copy.deepcopy(net).to(device)(
                list(blocks), frame_features(blocks)).cpu()
        diffs[label] = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"sampled {label}: {device.type} logits "
                                 f"differ from CPU logits by {diffs[label]}")
    info = {"live_slots": live, "dead_slots": dead, "max_abs_diff": diffs}
    print(f"[sampled-check] {json.dumps(info)}")
    return info


def profile_window(fn, device: torch.device):
    """``torch.profiler``'s view of one call of ``fn`` (which ends in a
    synchronisation): the card's busy time (kernels and copies, overlaps
    counted once), the host clock's window around the call and the idle
    share, ``1 − busy / window``, and the six device operations that took
    longest in all, by name. None, with the reason, where the profiler saw
    no device time (and on the CPU)."""
    if device.type != "cuda":
        return {"busy_ms": None, "note": "no card (rehearsal)"}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device operations only: a user annotation (the optimizer's step) is a
    # span on the device's timeline that covers other operations and gaps
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation]
    if not device_events:
        return {"busy_ms": None,
                "note": "the profiler recorded no device time"}
    by_name = collections.Counter()
    for e in device_events:
        by_name[e.name.split("(")[0][:80]] += e.time_range.elapsed_us() / 1e3
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in device_events]) / 1e3
    return {"busy_ms": busy_ms, "window_ms": window_ms,
            "idle_share": 1.0 - busy_ms / window_ms,
            "device_ops": len(device_events),
            "top_ms": dict(by_name.most_common(6))}


def phase_sampled_bench(device: torch.device, scales=SAMPLED_SCALES,
                        batch_size: int = SAMPLED_BATCH,
                        fanouts=SAMPLED_FANOUTS, steps: int = 10,
                        warmup: int = 3, repeats: int = 2):
    """``bench --sampled`` for GraphSAGE and GAT on each graph of
    ``scales`` (one graph a scale, shared by both models) through
    ``bench.run_sampled``: ``step_ms``, ``value`` (edge slots a second),
    ``seeds_per_sec``, ``setup_s`` (the graph's own build in ``graph_s``)
    and ``peak_hbm_bytes``; no kernel may be launched and the loss must be
    finite. Then, recorded with no limit, ``torch.profiler``'s busy time and
    idle share over ``steps`` further steps (:func:`profile_window`).
    Returns one record per (scale, model)."""
    records = []
    for nodes, avg_degree, products in scales:
        argv = ["--sampled", "--batch-size", str(batch_size), "--fanouts",
                ",".join(map(str, fanouts)), "--steps", str(steps),
                "--warmup", str(warmup), "--repeats", str(repeats),
                "--device", str(device)] + (["--products"] if products else [])
        base = bench.parse_args(argv)
        base.nodes, base.avg_degree = nodes, avg_degree
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        graph = bench.make_sampled_graph(base, device)
        _sync(device)
        graph_s = time.perf_counter() - t0
        for model in ("sage", "gat"):
            args = copy.copy(base)
            args.model = model
            sk.reset_launch_counts()
            payload = bench.run_sampled(args, graph=graph)
            if _launch_counts():
                raise AssertionError(f"sampled bench {model}: launched "
                                     f"{_launch_counts()}; expected none")
            if not np.isfinite(payload["loss"]):
                raise AssertionError(f"sampled bench {model}: loss not "
                                     f"finite: {payload}")
            wrapper, opt, batches = bench.sampled_state(args, graph, device)
            gen = torch.Generator(device=device).manual_seed(1)
            bench.sampled_steps(wrapper, opt, batches[:warmup], gen)
            prof = profile_window(functools.partial(
                bench.sampled_steps, wrapper, opt,
                batches[warmup: warmup + steps], gen), device)
            if prof["busy_ms"] is not None:
                prof["busy_ms_per_step"] = prof["busy_ms"] / steps
            del wrapper, opt, batches
            rec = {"model": model, "nodes": nodes, "avg_degree": avg_degree,
                   "products": products, "edges": graph.num_edges,
                   "graph_s": graph_s, "profile": prof,
                   **{k: payload[k] for k in (
                       "step_ms", "value", "seeds_per_sec", "setup_s",
                       "edge_slots_per_step", "loss", "peak_hbm_bytes")
                      if k in payload}}
            print(f"[sampled-bench] {json.dumps(rec)}")
            records.append(rec)
        del graph
    return records


# ---------------------------------------------------------------------------
# Host-sampled mini-batch training: the port's C++ sampler, the prefetch
# worker (sampling, the blocks' kernel structure, the copy to the card) and
# K1 / K3 over a fresh structure every step
# ---------------------------------------------------------------------------

def _host_sampled_expected(model: str, aggr, steps: int, evals: int,
                           on_card: bool):
    """The launches of a host-sampled run, by counted wrapper and case.
    Train steps over host blocks, which carry ``prepare_spmm``'s structure
    when the model reads it. GraphSAGE ``sum``: the first layer aggregates
    the frame's features, F=100, which need no gradient, so K1 runs over
    the CSR only; the second aggregates the hidden rows, F=128, over the
    CSR forward and over the CSC backward: 2 CSR + 1 CSC a step. GAT: each
    layer's attention runs K3's fwd, and backward dsd (the destination
    scores need a gradient) and dsrc (the source scores and rows do): 2
    each a step, at (8 heads, 16) and (1 head, 47). ``mean`` runs no
    kernel. Each full-batch evaluation adds what the full-batch model
    launches (:func:`_sampled_expected`)."""
    if not on_card:
        return {}
    out = _sampled_expected(model, aggr, evals, on_card)
    if model == "gat":
        per_case = out["gat_pass"]
        for heads, head_dim in GAT_SHAPES:
            per_case[("fwd", heads, head_dim)] += steps
            per_case[("dsd", heads, head_dim)] = steps
            per_case[("dsrc", heads, head_dim)] = steps
    elif aggr == "sum":
        per_case = out["spmm_csr"]
        for f in (FEAT_DIM, HIDDEN):
            per_case[("csr", f)] += steps
        per_case[("csc", HIDDEN)] = steps
    return out


def _host_graph(num_nodes: int, device: torch.device):
    """The host-sampled path's graph: the powerlaw graph's edges with its
    features, labels and masks drawn on ``device`` (``device_features``)."""
    return powerlaw_graph(num_nodes, avg_degree=AVG_DEGREE, feat_dim=FEAT_DIM,
                          num_classes=NUM_CLASSES, seed=0,
                          device_features=True, device=device)


def phase_host_library(device: torch.device, num_nodes: int = NUM_NODES,
                       batch_size: int = SAMPLED_BATCH,
                       fanouts=SAMPLED_FANOUTS, repeats: int = 5):
    """The host sampling library built with g++ on this machine, then
    ``sample_neighbors`` held bit for bit against its numpy replay at 1
    thread and at the machine's OpenMP count, over both hops of a
    full-size batch of the powerlaw graph with every ``HOLE_EVERY``-th row
    emptied (so dead slots occur); every live slot is an edge of the graph,
    every dead slot a seed without one pointing at itself. Returns the
    thread counts, the library's time a call per hop (the median of
    ``repeats`` calls, and the first, which starts the thread team), the
    replay's, and the slot counts. Runs on the host whatever ``device``
    is."""
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    g = _holed_graph(num_nodes, torch.device("cpu"))
    indptr, indices, _ = graph_csr(g)
    indices = indices.astype(np.int64)
    E, N = g.num_edges, g.num_nodes
    keys = np.sort(g.row[:E].numpy().astype(np.int64) * N
                   + g.col[:E].numpy())
    rng = np.random.default_rng(0)
    cur = rng.choice(np.nonzero(g.train_mask[:N].numpy())[0], batch_size,
                     replace=False)
    threads = sorted({1, native.max_threads()})
    hops = []
    for k, f in enumerate(fanouts):
        seed = int(rng.integers(0, 2 ** 62))
        rec = {"hop": k, "seeds": int(cur.size), "fanout": f}
        for t in threads:
            ms = []
            for _ in range(repeats):
                t1 = time.perf_counter()
                src, mask = native.sample_neighbors(indptr, indices, cur, f,
                                                    seed, t)
                ms.append((time.perf_counter() - t1) * 1e3)
            rec[f"ms_{t}_threads"] = float(np.median(ms))
            rec[f"first_ms_{t}_threads"] = ms[0]
            t1 = time.perf_counter()
            ref = native.sample_neighbors_reference(indptr, indices, cur, f,
                                                    seed, t)
            rec[f"replay_s_{t}_threads"] = time.perf_counter() - t1
            if not (np.array_equal(src, ref[0])
                    and np.array_equal(mask, ref[1])):
                raise AssertionError(
                    f"host library, hop {k} at {t} threads: the draws differ "
                    f"from the numpy replay in "
                    f"{int((src != ref[0]).sum())} slots")
        dst = np.repeat(cur, f)
        query = dst[mask] * N + src[mask]
        pos = np.minimum(np.searchsorted(keys, query), keys.size - 1)
        if not np.array_equal(keys[pos], query):
            raise AssertionError(f"host library, hop {k}: "
                                 f"{int((keys[pos] != query).sum())} live "
                                 "slots are not edges of the graph")
        no_edge = (indptr[dst + 1] - indptr[dst]) == 0
        if not (np.array_equal(~mask, no_edge)
                and np.array_equal(src[~mask], dst[~mask])):
            raise AssertionError(f"host library, hop {k}: dead slots are not "
                                 "exactly the seeds without an edge, each "
                                 "pointing at itself")
        rec.update(live=int(mask.sum()), dead=int((~mask).sum()))
        hops.append(rec)
        cur = np.concatenate([cur, src[mask]])
        cur = cur[np.sort(np.unique(cur, return_index=True)[1])]
    if not sum(h["dead"] for h in hops):
        raise AssertionError("host library: no dead slot drawn")
    info = {"library": lib.name, "build_s": build_s,
            "omp_threads": native.max_threads(), "cpus": os.cpu_count(),
            "threads_checked": threads, "hops": hops}
    print(f"[host-library] {json.dumps(info)}")
    return info


def phase_host_sampled_main_path(device: torch.device,
                                 num_nodes: int = NUM_NODES,
                                 epochs: int = SAMPLED_EPOCHS,
                                 batch_size: int = SAMPLED_BATCH,
                                 fanouts=SAMPLED_FANOUTS,
                                 models=SAMPLED_MODELS):
    """Host-sampled training through
    experiment(wrapper="neighbor_sampling", device_features=True) on the
    powerlaw graph at the bench's widths: GraphSAGE ``mean``, GraphSAGE
    ``sum`` and GAT, each for one epoch and then for ``epochs`` from the
    same seed. Checks the exact launch counts of every run
    (:func:`_host_sampled_expected`; a CPU run none), that the losses are
    finite and that the last epoch's mean loss is below the first
    epoch's. Returns each run's step and evaluation times and losses, and
    the launches by case of the ``epochs`` runs."""
    g = _host_graph(num_nodes, device)
    ds = Dataset.from_graph(g, name=f"powerlaw-{num_nodes}")
    steps = -(-int(g.train_mask.sum()) // batch_size)
    on_card = device.type == "cuda"
    info, launches_by = {}, collections.defaultdict(dict)
    for label, model, kw in models:
        runs = []
        for n_epochs in (1, epochs):
            sk.reset_launch_counts()
            results = experiment(
                dataset=ds, model=model, wrapper="neighbor_sampling",
                fanouts=fanouts, batch_size=batch_size, device_features=True,
                epochs=n_epochs, patience=n_epochs + 1, seed=0,
                device=str(device), **kw)
            (res,) = next(iter(results.values()))
            counts = _launch_counts()
            expected = _host_sampled_expected(
                model, kw.get("aggr"), n_epochs * steps, n_epochs + 1,
                on_card)
            if counts != expected:
                raise AssertionError(
                    f"host-sampled {label} ({n_epochs} epochs of {steps} "
                    f"steps) launched {counts}; expected {expected}")
            if not np.isfinite(res["train_loss"]):
                raise AssertionError(f"host-sampled {label}: loss not "
                                     f"finite: {res}")
            runs.append(res)
        for kernel, by_case in counts.items():
            for case, v in by_case.items():
                launches_by[kernel][case] = (
                    launches_by[kernel].get(case, 0) + v)
        first, last = runs[0]["train_loss"], runs[1]["train_loss"]
        if not last < first:
            raise AssertionError(f"host-sampled {label}: the mean loss of "
                                 f"epoch {epochs} ({last}) is not below "
                                 f"epoch 1's ({first})")
        res = runs[1]
        info[label] = {
            "train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "losses": [first, last], "epochs": epochs,
            "steps_per_epoch": steps,
            "launches": {k: {",".join(map(str, c)): v for c, v in d.items()}
                         for k, d in counts.items()}}
    print(f"[host-sampled-main] {json.dumps(info)}")
    info["launches_by"] = dict(launches_by)
    return info


def _host_k1_check(name: str, ex, d: str, feats, gen, device):
    """K1 over one direction of a block's structure against its plain
    version at each width of ``feats``: every element within
    ``KERNEL_ATOL + KERNEL_RTOL·Σ|terms|``, a second call equal bit for
    bit. Returns the largest error over tolerance."""
    ptr, col, w = (ex[f"spmm_{d}_{k}"] for k in ("ptr", "col", "w"))
    sched = stored_schedule(ex, d)
    worst = 0.0
    for feat in feats:
        x = torch.randn(ptr.numel() - 1, feat, generator=gen, device=device)
        out = sk.spmm_csr(ptr, col, w, x, schedule=sched)
        if not torch.equal(out, sk.spmm_csr(ptr, col, w, x, schedule=sched)):
            raise AssertionError(f"{name} [{d},F={feat}]: a second call "
                                 "gave other bits")
        worst = max(worst, scaled_err(
            out, sk.spmm_csr_reference(ptr, col, w, x),
            sk.spmm_csr_reference(ptr, col, w.abs(), x.abs())))
    return worst


def host_profile(wrapper, batches: int, top: int = 10):
    """Where the host's time a batch goes: ``cProfile`` over ``batches``
    batches of the wrapper's batch factory (sampling and, when the model
    reads it, the blocks' structure), run in this thread without the copy;
    the ``top`` functions by their own time, in ms a batch. cProfile adds
    to every Python call, not to the numpy and torch calls that hold the
    time here."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    it = wrapper._epoch_batches()
    prof.enable()
    n = sum(1 for _ in itertools.islice(it, batches))
    prof.disable()
    it.close()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    return {(f"{os.path.basename(fn)}:{line}({name})" if line else name):
            v[2] * 1e3 / n for (fn, line, name), v in rows}


def phase_host_sampled_check(device: torch.device, num_nodes: int = NUM_NODES,
                             batch_size: int = SAMPLED_BATCH,
                             fanouts=SAMPLED_FANOUTS, timing_batches: int = 8):
    """One full-size host-sampled batch, drawn and prepared in the prefetch
    worker and copied to ``device``: over each of its blocks and over a
    block with no live edge (the frame's full height), K1 (CSR at F=100 and
    128, CSC at 128) and K3 (three modes, both GAT shapes, attention dropout
    0 and 0.6, every kernel by name: :func:`gat_single_check`) against
    their plain versions; then GraphSAGE (each aggregator) and GAT with the
    same weights, dropout off, over the batch on ``device`` and on the CPU
    (the CPU takes the plain versions over the same structure): logits
    within rtol 1e-4 / atol 1e-4. Last, the worker's own time a batch,
    sampling and structure, over ``timing_batches`` batches for each model
    of the main path, and :func:`host_profile` of GAT's. Returns the
    errors, the differences and the times."""
    g = add_self_loops(_host_graph(num_nodes, device))
    gat = build_model("gat", in_features=FEAT_DIM, out_features=NUM_CLASSES,
                      hidden_size=GAT_HEAD_DIM, nhead=GAT_HEADS, dropout=0.0,
                      attn_drop=0.0)
    w = SampledNodeClfWrapper(gat, fanouts=fanouts, batch_size=batch_size,
                              device_features=True)
    w.build_sampler(g)
    it = iter(w.train_batches(g))
    blocks = list(next(it))
    it.close()
    S, n_pad = blocks[0].num_nodes, blocks[0].n_pad
    empty = prepare_spmm(from_coo(np.zeros((2, 0), np.int64), num_nodes=S,
                                  n_pad=n_pad, e_pad=blocks[-1].e_pad))
    gen = torch.Generator(device=device).manual_seed(3)
    seed = torch.tensor([2024], dtype=torch.int64, device=device)
    errs = {}
    for label, b in ([(f"block{i}", b) for i, b in enumerate(blocks)]
                     + [("no_live_edge", empty.to(device))]):
        ex = b.extras
        rec = {"edges": b.num_edges, "rows_with_edges": int(
            (ex["spmm_fw_ptr"][1:] > ex["spmm_fw_ptr"][:-1]).sum()),
               "cross_rows": {d: stored_schedule(ex, d).cross.shape[0]
                              for d in ("fw", "bw")}}
        rec["k1"] = max(
            _host_k1_check(label, ex, "fw", (FEAT_DIM, HIDDEN), gen, device),
            _host_k1_check(label, ex, "bw", (HIDDEN,), gen, device))
        k3 = 0.0
        for heads, head_dim in GAT_SHAPES:
            t = _gat_inputs(n_pad, heads, head_dim, gen, device)
            for mode in sk.GAT_MODES:
                d = "bw" if mode == "dsrc" else "fw"
                base = (mode, *(ex[f"spmm_{d}_{k}"]
                                for k in ("ptr", "col", "orig")),
                        t["sd"], t["ss"], t["smax"], t["h2"])
                back = () if mode == "fwd" else (t["dagg"], t["dden"])
                err, *_ = gat_single_check(
                    f"host-sampled {label} gat_pass[{mode},H={heads}]", base,
                    back, stored_schedule(ex, d), seed)
                k3 = max(k3, err)
        rec["k3"] = k3
        errs[label] = rec
        if not max(rec["k1"], rec["k3"]) <= 1.0:
            raise AssertionError(f"host-sampled {label}: K1/K3 disagree with "
                                 f"their plain versions: {rec}")
    cpu_blocks = [b.to("cpu") for b in blocks]
    diffs = {}
    for label, model, kw in (
            [(f"sage-{a}", "graphsage", {"hidden_size": HIDDEN, "aggr": a})
             for a in SAGE_AGGREGATORS]
            + [("gat", "gat", {"hidden_size": GAT_HEAD_DIM,
                               "nhead": GAT_HEADS, "attn_drop": 0.0})]):
        net = build_model(model, in_features=FEAT_DIM,
                          out_features=NUM_CLASSES, dropout=0.0, **kw)
        net.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():
            ref = net(cpu_blocks, frame_features(cpu_blocks))
            out = copy.deepcopy(net).to(device)(
                blocks, frame_features(blocks)).cpu()
        diffs[label] = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"host-sampled {label}: {device.type} logits "
                                 f"differ from CPU logits by {diffs[label]}")
    host_ms = {}
    for label, model, kw in SAMPLED_MODELS:
        net = build_model(model, in_features=FEAT_DIM,
                          out_features=NUM_CLASSES, **kw)
        tw = SampledNodeClfWrapper(net, fanouts=fanouts,
                                   batch_size=batch_size, device_features=True)
        tw.build_sampler(g)
        it = iter(tw.train_batches(g))
        n = sum(1 for _ in itertools.islice(it, timing_batches))
        it.close()
        sample_ms, structure_ms = zip(*tw.host_ms)
        host_ms[label] = {
            "batches": n, "threads": tw._sampler.num_threads,
            "sample_ms": float(np.median(sample_ms)),
            "structure_ms": (None if structure_ms[0] is None
                             else float(np.median(structure_ms)))}
    info = {"frame_rows": n_pad, "frame_nodes": S, "blocks": errs,
            "max_abs_diff": diffs, "host_ms": host_ms,
            "host_profile_ms": host_profile(w, timing_batches)}
    print(f"[host-sampled-check] {json.dumps(info)}")
    return info


def phase_host_sampled_bench(device: torch.device, scales=SAMPLED_SCALES,
                             batch_size: int = SAMPLED_BATCH,
                             fanouts=SAMPLED_FANOUTS, steps: int = 10,
                             warmup: int = 3):
    """``bench --sampled --host-sampler`` (GraphSAGE-mean) on each graph of
    ``scales`` through ``bench.run_host_sampled``: ``step_ms``, ``value``
    (padded block edges a second), ``seeds_per_sec``, ``setup_s``,
    ``peak_hbm_bytes`` and the worker's sampling time a batch; no kernel
    may be launched and the loss must be finite. Then, recorded with no
    limit, ``torch.profiler``'s busy time and idle share over up to
    ``steps`` further steps of a fresh epoch after ``warmup - 1`` steps
    (:func:`profile_window`). Returns one record per scale."""
    records = []
    for nodes, avg_degree, products in scales:
        argv = ["--sampled", "--host-sampler", "--batch-size",
                str(batch_size), "--fanouts", ",".join(map(str, fanouts)),
                "--steps", str(steps), "--warmup", str(warmup),
                "--device", str(device)] + (["--products"] if products else [])
        args = bench.parse_args(argv)
        args.nodes, args.avg_degree = nodes, avg_degree
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        graph = bench.make_sampled_graph(args, device)
        _sync(device)
        graph_s = time.perf_counter() - t0
        sk.reset_launch_counts()
        payload = bench.run_host_sampled(args, graph=graph)
        if _launch_counts():
            raise AssertionError(f"host-sampled bench: launched "
                                 f"{_launch_counts()}; expected none")
        if not np.isfinite(payload["loss"]):
            raise AssertionError(f"host-sampled bench: loss not finite: "
                                 f"{payload}")
        wrapper, opt = bench.host_sampled_state(args, graph, device)
        gen = torch.Generator(device=device).manual_seed(1)
        it = iter(wrapper.train_batches(graph))
        bench.sampled_steps(wrapper, opt, itertools.islice(it, warmup - 1),
                            gen)
        ran = []
        prof = profile_window(lambda: ran.extend(bench.sampled_steps(
            wrapper, opt, itertools.islice(it, steps), gen)), device)
        it.close()
        if prof["busy_ms"] is not None:
            prof["busy_ms_per_step"] = prof["busy_ms"] / len(ran)
        prof["steps"] = len(ran)
        del wrapper, opt
        rec = {"nodes": nodes, "avg_degree": avg_degree,
               "products": products, "edges": graph.num_edges,
               "graph_s": graph_s, "profile": prof,
               **{k: payload[k] for k in (
                   "step_ms", "value", "seeds_per_sec", "setup_s",
                   "edge_slots_per_step", "timed_steps", "loss",
                   "host_threads", "host_sample_ms", "host_structure_ms",
                   "peak_hbm_bytes") if k in payload}}
        print(f"[host-sampled-bench] {json.dumps(rec)}")
        records.append(rec)
        del graph
    return records


# ---------------------------------------------------------------------------
# Subgraph mini-batch training: ClusterGCN and GraphSAINT, K1 over a fresh
# subgraph structure every step
# ---------------------------------------------------------------------------

# the cluster wrapper's defaults: 20 BFS parts, 5 a batch (4 steps an epoch,
# about 25k nodes a batch at 100k)
CLUSTER_KW = {"n_clusters": 20, "cluster_batch": 5}
# GraphSAINT at the bench's widths: architecture 1-1-0 at hidden 128, so its
# second layer's A·h runs at F = 2 x 128 (the first layer concatenates two
# orders); random walks of 4 steps from 2000 roots, 8 batches an epoch, the
# estimator over 40 draws
SAINT_MODEL_KW = {"hidden_size": HIDDEN, "architecture": "1-1-0"}
SAINT_KW = {"sampler": "walk", "walk_roots": 2000, "walk_length": 4,
            "batches_per_epoch": 8, "est_samples": 40}
SAINT_WIDTH = 2 * HIDDEN
SUBGRAPH_EPOCHS = 3


def _subgraph_expected(model: str, steps: int, evals: int, on_card: bool):
    """K1's launches in a cluster or GraphSAINT run, by case. Each train
    step runs over its batch's fresh structure. GCN: each layer's forward
    over the CSR and backward over the CSC, at F=128 and F=47: 4 a step.
    GraphSAINT 1-1-0: layer 0's A·x at F=100 over the CSR only (x takes no
    gradient), layer 1's A·h at F=256 over the CSR and the CSC, layer 2
    (order 0) none: 3 a step. Each full-batch evaluation adds the
    forward's CSR calls."""
    if not on_card:
        return {}
    if model == "gcn":
        fw = bw = (HIDDEN, NUM_CLASSES)
    else:
        fw, bw = (FEAT_DIM, SAINT_WIDTH), (SAINT_WIDTH,)
    expected = {("csr", f): steps + evals for f in fw}
    expected.update({("csc", f): steps for f in bw})
    return {"spmm_csr": expected}


def _subgraph_main(tag: str, device: torch.device, num_nodes: int,
                   runs, saint_kw=None):
    """Each ``(label, model, wrapper, model kwargs, epoch counts)`` of
    ``runs`` through ``experiment()`` on the host-sampled phases' graph,
    once for each epoch count from the same seed: the exact K1 launches
    (:func:`_subgraph_expected`), finite losses and, over more than one
    count, the last epoch's mean loss below the first epoch's. Returns
    each label's times and losses and the launches by case of its last
    run, summed over the labels."""
    g = _host_graph(num_nodes, device)
    ds = Dataset.from_graph(g, name=f"powerlaw-{num_nodes}")
    on_card = device.type == "cuda"
    info, launches_by = {}, collections.defaultdict(dict)
    for label, model, wrapper, model_kw, epoch_counts in runs:
        kw = dict(model_kw, **(CLUSTER_KW if wrapper == "cluster"
                               else saint_kw))
        steps = (-(-CLUSTER_KW["n_clusters"] // CLUSTER_KW["cluster_batch"])
                 if wrapper == "cluster" else saint_kw["batches_per_epoch"])
        losses = []
        for n_epochs in epoch_counts:
            sk.reset_launch_counts()
            results = experiment(
                dataset=ds, model=model, wrapper=wrapper, epochs=n_epochs,
                patience=n_epochs + 1, seed=0, device=str(device), **kw)
            (res,) = next(iter(results.values()))
            counts = _launch_counts()
            expected = _subgraph_expected(model, n_epochs * steps,
                                          n_epochs + 1, on_card)
            if counts != expected:
                raise AssertionError(
                    f"{tag} {label} ({n_epochs} epochs of {steps} steps) "
                    f"launched {counts}; expected {expected}")
            if not np.isfinite(res["train_loss"]):
                raise AssertionError(f"{tag} {label}: loss not finite: {res}")
            losses.append(res["train_loss"])
        if len(losses) > 1 and not losses[-1] < losses[0]:
            raise AssertionError(
                f"{tag} {label}: the mean loss of epoch {epoch_counts[-1]} "
                f"({losses[-1]}) is not below epoch {epoch_counts[0]}'s "
                f"({losses[0]})")
        for kernel, by_case in counts.items():
            for case, v in by_case.items():
                launches_by[kernel][case] = (
                    launches_by[kernel].get(case, 0) + v)
        info[label] = {
            "train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "losses": losses, "epochs": list(epoch_counts),
            "steps_per_epoch": steps,
            "launches": {k: {",".join(map(str, c)): v for c, v in d.items()}
                         for k, d in counts.items()}}
    print(f"[{tag}] {json.dumps(info)}")
    info["launches_by"] = dict(launches_by)
    return info


def phase_cluster_main_path(device: torch.device, num_nodes: int = NUM_NODES,
                            epochs: int = SUBGRAPH_EPOCHS):
    """ClusterGCN: GCN (hidden 128, dropout 0.5) through
    ``experiment(wrapper="cluster")`` with the wrapper's defaults, for 1
    epoch and then for ``epochs`` (:func:`_subgraph_main`)."""
    return _subgraph_main(
        "cluster-main", device, num_nodes,
        [("gcn", "gcn", "cluster", {"hidden_size": HIDDEN}, (1, epochs))])


def phase_saint_main_path(device: torch.device, num_nodes: int = NUM_NODES,
                          epochs: int = SUBGRAPH_EPOCHS, saint_kw=SAINT_KW):
    """GraphSAINT through ``experiment(model="graphsaint")`` and its
    default wrapper (1-1-0 at hidden 128, dropout 0.1, ``saint_kw``) for 1
    epoch and then for ``epochs``, and GCN under ``wrapper="graphsaint"``
    for 1 epoch (:func:`_subgraph_main`)."""
    return _subgraph_main(
        "saint-main", device, num_nodes,
        [("graphsaint", "graphsaint", None, SAINT_MODEL_KW, (1, epochs)),
         ("gcn", "gcn", "graphsaint", {"hidden_size": HIDDEN}, (1,))],
        saint_kw)


def _k1_entry(name: str, ex, d: str, feat: int, gen, device, iters: int):
    """One measurement entry of K1 over one direction of a structure at
    width ``feat``: checked as :func:`_host_k1_check` does, timed with CUDA
    events (``ms``) and with the host held out (``device_ms``), beside its
    plain version, its bound and ``torch.sparse.mm``."""
    ptr, col, w = (ex[f"spmm_{d}_{k}"] for k in ("ptr", "col", "w"))
    sched = stored_schedule(ex, d)
    n, nnz = ptr.numel() - 1, col.numel()
    x = torch.randn(n, feat, generator=gen, device=device)
    err = _host_k1_check(name, ex, d, (feat,), gen, device)
    if not err <= 1.0:
        raise AssertionError(f"{name}: K1 disagrees with its plain version "
                             f"({err:.3g} x tolerance)")

    def run():
        return sk.spmm_csr(ptr, col, w, x, schedule=sched)

    out = run()
    ref = sk.spmm_csr_reference(ptr, col, w, x)
    lib_a = torch.sparse_csr_tensor(ptr, col, w, size=(n, n),
                                    check_invariants=False)
    x_rows = int(torch.unique(col).numel())
    b_ms, b_by = bound_ms(n, nnz, feat, x_rows)
    ms = time_ms(run, device, iters)
    device_ms, host_us = time_device_ms(run, device, iters)
    return {"name": name, "route": "cuda", "source": SPMM_SOURCE,
            "replaces": SPMM_REPLACES, "launches": None,
            "case": ["spmm_csr", "csr" if d == "fw" else "csc", feat],
            "max_abs_err": float((out - ref).abs().max()),
            "err_over_tol": err, "ms": ms, "device_ms": device_ms,
            "host_us_per_call": host_us,
            "plain_ms": time_ms(
                lambda: sk.spmm_csr_reference(ptr, col, w, x), device,
                max(iters // 4, 1)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.sparse.mm(lib_a, x), device,
                                  iters),
            "rows": n, "x_rows": x_rows, "nnz": nnz,
            "share_of_bound": b_ms / device_ms}


def _epoch_profile(wrapper, graph, device):
    """``torch.profiler``'s view (:func:`profile_window`) of one epoch of
    the wrapper's train steps (its prefetch worker included), after one
    epoch of warm-up; the model on ``device``, Adam at 1e-2."""
    wrapper.model.to(device)
    opt = torch.optim.Adam(wrapper.model.parameters(), lr=1e-2)
    gen = torch.Generator(device=device).manual_seed(1)
    bench.sampled_steps(wrapper, opt, wrapper.train_batches(graph), gen)
    ran = []
    prof = profile_window(lambda: ran.extend(bench.sampled_steps(
        wrapper, opt, wrapper.train_batches(graph), gen)), device)
    if prof["busy_ms"] is not None:
        prof["busy_ms_per_step"] = prof["busy_ms"] / len(ran)
        prof["window_ms_per_step"] = prof["window_ms"] / len(ran)
    prof["steps"] = len(ran)
    return prof


def _host_ms(wrapper):
    """The prefetch worker's own time a batch, subgraph and structure, in
    ms: the mean over the batches in ``wrapper.host_ms`` (a cluster epoch
    builds all its subgraphs before its first batch, so its first batch
    holds the epoch's subgraph work) and the largest."""
    sub, structure = zip(*wrapper.host_ms)
    return {"batches": len(sub), "subgraph_ms": float(np.mean(sub)),
            "subgraph_ms_max": float(np.max(sub)),
            "structure_ms": float(np.mean(structure)),
            "structure_ms_max": float(np.max(structure))}


def phase_cluster_saint_check(device: torch.device,
                              num_nodes: int = NUM_NODES, saint_kw=SAINT_KW,
                              iters: int = 20):
    """One full-size cluster batch and one full-size GraphSAINT batch, each
    drawn and prepared by its wrapper's prefetch worker and copied to
    ``device``: K1 over both directions of each batch's structure at every
    width the two paths run (CSR F=100, 128, 47 and 256, CSC F=128, 47 and
    256) against its plain version, a second call equal bit for bit
    (:func:`_host_k1_check`); GCN and GraphSAINT with the same weights,
    dropout off, over each batch on ``device`` and on the CPU: logits
    within rtol 1e-4 / atol 1e-4. Then the times: ``bfs_partition`` at this
    size, ``torch.profiler``'s busy time over one epoch of each wrapper
    (:func:`_epoch_profile`), the worker's own time a batch (subgraph and
    structure, :func:`_host_ms`) over that epoch and its warm-up, and K1
    at F=256 timed over the SAINT
    batch (CSR and CSC) and over the full graph (CSR, the evaluation's):
    three measurement entries, returned with the rest."""
    g = _host_graph(num_nodes, device)
    prepared = sym_norm(add_self_loops(g))
    _sync(device)
    t0 = time.perf_counter()
    bfs_partition(prepared, CLUSTER_KW["n_clusters"], seed=0)
    bfs_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(4)
    models = {
        "gcn": build_model("gcn", in_features=FEAT_DIM,
                           out_features=NUM_CLASSES, hidden_size=HIDDEN,
                           dropout=0.0),
        "graphsaint": build_model("graphsaint", in_features=FEAT_DIM,
                                  out_features=NUM_CLASSES, dropout=0.0,
                                  **SAINT_MODEL_KW)}
    for net in models.values():
        net.reset_parameters(torch.Generator().manual_seed(0))
    wrappers = {
        "cluster": ClusterNodeClfWrapper(copy.deepcopy(models["gcn"]),
                                         **CLUSTER_KW),
        "saint": GraphSAINTWrapper(copy.deepcopy(models["graphsaint"]),
                                   **saint_kw)}
    info = {"bfs_partition_s": bfs_s, "nodes": num_nodes,
            "edges": prepared.num_edges}
    entries = []
    widths = {"fw": (FEAT_DIM, HIDDEN, NUM_CLASSES, SAINT_WIDTH),
              "bw": (HIDDEN, NUM_CLASSES, SAINT_WIDTH)}
    for label, w in wrappers.items():
        t0 = time.perf_counter()
        graph = w.prepare_graph(g)
        _sync(device)
        prepare_s = time.perf_counter() - t0
        it = iter(w.train_batches(graph))
        batch = next(it)
        it.close()
        ex = batch.extras
        rec = {"prepare_graph_s": prepare_s, "nodes": batch.num_nodes,
               "n_pad": batch.n_pad, "edges": batch.num_edges,
               "e_pad": batch.e_pad,
               "cross_rows": {d: stored_schedule(ex, d).cross.shape[0]
                              for d in ("fw", "bw")},
               "k1": max(_host_k1_check(f"{label} batch", ex, d, widths[d],
                                        gen, device) for d in widths)}
        if not rec["k1"] <= 1.0:
            raise AssertionError(f"{label} batch: K1 disagrees with its "
                                 f"plain version: {rec}")
        cpu_batch = batch.to("cpu")
        diffs = {}
        for name, net in models.items():
            with torch.no_grad():
                ref = net(cpu_batch, cpu_batch.x)
                out = copy.deepcopy(net).to(device)(batch, batch.x).cpu()
            diffs[name] = float((out - ref).abs().max())
            if not torch.allclose(out, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(
                    f"{label} batch, {name}: {device.type} logits differ "
                    f"from CPU logits by {diffs[name]}")
        rec["max_abs_diff"] = diffs
        w.host_ms.clear()
        rec["profile"] = _epoch_profile(w, graph, device)
        rec["host_ms"] = _host_ms(w)
        if label == "saint":
            for d in ("fw", "bw"):
                entries.append(_k1_entry(
                    f"spmm_csr[{'csr' if d == 'fw' else 'csc'},"
                    f"F={SAINT_WIDTH}] saint batch", ex, d, SAINT_WIDTH, gen,
                    device, iters))
            # the CPU rehearsal's prepared graph has no structure
            full = graph if device.type == "cuda" else prepare_spmm(graph)
            entries.append(_k1_entry(
                f"spmm_csr[csr,F={SAINT_WIDTH}] full graph", full.extras,
                "fw", SAINT_WIDTH, gen, device, iters))
        info[label] = rec
        del graph, batch, cpu_batch, it
    for e in entries:
        print(f"[kernel] {json.dumps(e)}")
    print(f"[cluster-saint-check] {json.dumps(info)}")
    info["entries"] = entries
    return info


# ---------------------------------------------------------------------------
# The full-batch node-classification zoo (ROADMAP item 12)
# ---------------------------------------------------------------------------

# each model at its BEST_CONFIGS width (gcnii, appnp, mixhop, deepergcn) or
# its default (sgc, mlp, drgcn, drgat), through experiment() with
# use_best_config=True on the main path's graph
ZOO_KW = {
    "gcnii": {"hidden_size": 64, "num_layers": 16},
    "appnp": {"hidden_size": 64, "propagation_steps": 10},
    "mixhop": {"hidden_size": 64, "powers": (0, 1, 2)},
    "sgc": {"order": 2},
    "mlp": {"hidden_size": 64},
    "deepergcn": {"hidden_size": 64, "num_layers": 14},
    "drgcn": {"hidden_size": 64},
    "drgat": {"hidden_size": 8, "nhead": 8},
}
ZOO_EPOCHS = 5
# the widths K1 runs at on this path and no earlier path: GCNII's and
# DrGCN's hidden 64, MixHop's second layer 3 powers x 64
ZOO_FEATS = (64, 192)
# DrGAT's first layer: 8 heads of 8 (its second is GAT's (1, 47))
ZOO_GAT_SHAPES = ((8, 8),)
# Epochs of each model's sbm quality run: 100, but 300 for DeeperGCN, whose
# 14 blocks have not converged at 100 (its test accuracy over seeds 0-7
# spreads 0.785-0.975 in the JAX package and 0.75-0.995 in the port on the
# CPU at 100 epochs, 0.97-0.995 and 0.975-1.0 at 300, so a two-seed mean
# at 100 is a coin toss against any bar)
ZOO_QUALITY_EPOCHS = {"deepergcn": 300}
# The JAX package's own sbm test accuracy, the mean over seeds 0 and 1, on
# the CPU, each from
#   JAX_PLATFORMS=cpu python -c "from cogdl_tpu import experiment; \
#       experiment(dataset='sbm', model=MODEL, epochs=EPOCHS, seed=[0, 1])"
# run from the repo root, EPOCHS from ZOO_QUALITY_EPOCHS; the card's bar is
# each less ZOO_QUALITY_MARGIN
ZOO_JAX_SBM_ACC = {
    "gcnii": 0.9975, "appnp": 0.9950, "mixhop": 0.9975, "sgc": 0.9825,
    "mlp": 1.0000, "deepergcn": 0.9825, "drgcn": 0.9725, "drgat": 0.9825,
}
ZOO_QUALITY_MARGIN = 0.02


def _zoo_expected(model: str, steps: int, evals: int, on_card: bool):
    """K1 and K3 launches of ``model``'s run at :data:`ZOO_KW`, by counted
    wrapper and case. A train step runs each propagation's forward over the
    CSR and, where its input takes a gradient, its backward over the CSC;
    an evaluation runs the forwards. GCNII: 16 layers at F=64. APPNP: 10
    steps at F=47 (the predictor's output). MixHop: 2 powers at F=100 (the
    input features take no gradient: no CSC) and 2 at F=192. SGC: 2 at
    F=100, forward only. DrGCN: F=64 and F=47. DrGAT: K3's fwd, dsd and
    dsrc at (8, 8) and (1, 47). MLP and DeeperGCN: none."""
    if not on_card or model in ("mlp", "deepergcn"):
        return {}
    expected = collections.Counter()
    if model == "drgat":
        for h, d in ZOO_GAT_SHAPES + ((1, NUM_CLASSES),):
            expected.update({(m, h, d): steps for m in sk.GAT_MODES})
            expected[("fwd", h, d)] += evals
        return {"gat_pass": +expected}
    kw = ZOO_KW[model]
    if model == "gcnii":
        props = [(kw["hidden_size"], True)] * kw["num_layers"]
    elif model == "appnp":
        props = [(NUM_CLASSES, True)] * kw["propagation_steps"]
    elif model == "mixhop":
        props = [(FEAT_DIM, False)] * max(kw["powers"]) + [
            (kw["hidden_size"] * len(kw["powers"]), True)] * max(kw["powers"])
    elif model == "sgc":
        props = [(FEAT_DIM, False)] * kw["order"]
    else:
        props = [(kw["hidden_size"], True), (NUM_CLASSES, True)]
    for feat, grad in props:
        expected[("csr", feat)] += steps + evals
        expected[("csc", feat)] += steps if grad else 0
    return {"spmm_csr": +expected}


def phase_zoo_kernel_check(device: torch.device, num_nodes: int = NUM_NODES,
                           iters: int = 20):
    """K1 against its plain version over CSR(A) and CSR(Aᵀ) of the main
    path's graph at the widths the zoo adds (:data:`ZOO_FEATS`), checked
    and timed by :func:`_k1_entry` (within tolerance, a second call
    bit-equal; ``ms``, ``device_ms``, ``bound_ms``, ``torch.sparse.mm``);
    K3 at DrGAT's (8, 8) in all three modes, attention dropout 0 and 0.6
    (:func:`phase_gat_kernel_check`). Returns the measurement entries."""
    g = kernel_graph(num_nodes, device)
    gen = torch.Generator(device=device).manual_seed(5)
    entries = [_k1_entry(f"spmm_csr[{'csr' if d == 'fw' else 'csc'},F={f}]",
                         g.extras, d, f, gen, device, iters)
               for d in ("fw", "bw") for f in ZOO_FEATS]
    for e in entries:
        print(f"[zoo-kernel] {json.dumps(e)}")
    return entries + phase_gat_kernel_check(device, num_nodes, iters,
                                            shapes=ZOO_GAT_SHAPES)


def _step_profile(model: str, kw, graph, device: torch.device,
                  normalised_by_norm: dict, wrapper_cls=NodeClfWrapper):
    """``torch.profiler``'s view (:func:`profile_window`) of one train step
    of ``model`` at ``kw`` over ``graph`` on ``device`` (the wrapper's
    loss on its first train batch, its backward and an Adam step, ending
    in a synchronisation), after two steps of warm-up. The wrapper is
    ``wrapper_cls(net)`` (``NodeClfWrapper``, a subclass, or a factory of
    one), prepared and initialised as the trainer does it. Where its
    ``prepare_graph`` is ``NodeClfWrapper``'s, ``normalised_by_norm``
    keeps the normalised graph on the host by the model's ``adj_norm`` for
    the next call, so that the host rebuild of ``add_self_loops`` runs
    once a normalisation; the card holds only this call's copy, which the
    next run's ``peak_hbm_bytes`` then does not count."""
    net = build_model(model, in_features=graph.x.shape[1],
                      out_features=NUM_CLASSES, **kw)
    wrapper = wrapper_cls(net)
    if type(wrapper).prepare_graph is NodeClfWrapper.prepare_graph:
        norm = getattr(net, "adj_norm", None)
        if norm not in normalised_by_norm:
            normalised_by_norm[norm] = wrapper.normalise(graph.to("cpu"))
        prepared = wrapper.with_structure(normalised_by_norm[norm].to(device))
    else:
        prepared = wrapper.prepare_graph(graph.to(device))
    wrapper.init(torch.Generator().manual_seed(0), prepared)
    net.to(device)
    batch = wrapper.train_batches(prepared)[0]
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    gen = torch.Generator(device=device).manual_seed(1)

    def step():
        opt.zero_grad(set_to_none=True)
        wrapper.loss(batch, gen).backward()
        opt.step()
        _sync(device)

    step()
    step()
    return profile_window(step, device)


def _zoo_runs(tag: str, device: torch.device, num_nodes: int, epochs: int,
              runs, expected_fn):
    """Each ``(label, model, kwargs)`` of ``runs`` through ``experiment()``
    with ``use_best_config=True`` on the main path's graph for ``epochs``
    epochs (an evaluation each): the exact K1 and K3 launches of
    ``expected_fn(model, kwargs, steps, evaluations, on_card)`` and no
    other counted kernel, a finite loss, and ``train_step_ms``, ``eval_ms``
    and the peak of allocated card memory (``peak_hbm_bytes``, on the card
    only), and ``torch.profiler``'s view of one more train step
    (:func:`_step_profile`), and the run's ``seconds``, all of it. Returns
    each run's record and the launches by case summed over the runs."""
    g = main_graph(num_nodes)
    ds = Dataset.from_graph(g, name=f"powerlaw-{num_nodes}")
    on_card = device.type == "cuda"
    info, launches_by = {}, collections.defaultdict(collections.Counter)
    normalised_by_norm = {}
    for label, model, kw in runs:
        t0 = time.perf_counter()
        sk.reset_launch_counts()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        results = experiment(dataset=ds, model=model, use_best_config=True,
                             epochs=epochs, patience=epochs + 1, seed=0,
                             device=str(device), **kw)
        (res,) = next(iter(results.values()))
        counts = _launch_counts()
        expected = expected_fn(model, kw, epochs, epochs + 1, on_card)
        if counts != expected:
            raise AssertionError(f"{tag} {label} ({epochs} steps, "
                                 f"{epochs + 1} evaluations) launched "
                                 f"{counts}; expected {expected}")
        if not np.isfinite(res["train_loss"]):
            raise AssertionError(f"{tag} {label}: loss not finite: {res}")
        for kernel, by_case in counts.items():
            launches_by[kernel].update(by_case)
        info[label] = {
            "train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "peak_hbm_bytes": (torch.cuda.max_memory_allocated(device)
                               if on_card else None),
            "train_loss": res["train_loss"], "epochs": epochs,
            "launches": {k: {",".join(map(str, c)): v for c, v in d.items()}
                         for k, d in counts.items()},
            "profile": _step_profile(model, kw, g, device,
                                     normalised_by_norm)}
        info[label]["seconds"] = time.perf_counter() - t0
    print(f"[{tag}] {json.dumps(info)}")
    info["launches_by"] = {k: dict(v) for k, v in launches_by.items()}
    return info


def phase_zoo_main_path(device: torch.device, num_nodes: int = NUM_NODES,
                        epochs: int = ZOO_EPOCHS, models=tuple(ZOO_KW)):
    """Each model of ``models`` at :data:`ZOO_KW` through
    :func:`_zoo_runs`, then DeeperGCN once more with ``remat=True``, held
    to :func:`_zoo_expected`."""
    runs = [(m, m, ZOO_KW[m]) for m in models]
    if "deepergcn" in models:
        runs.append(("deepergcn-remat", "deepergcn",
                     dict(ZOO_KW["deepergcn"], remat=True)))
    return _zoo_runs("zoo-main", device, num_nodes, epochs, runs,
                     lambda model, kw, steps, evals, on_card: _zoo_expected(
                         model, steps, evals, on_card))


# Depth of a logit parity where the CPU's forward at 20k nodes takes the
# phase's time, all of it in index ops, no kernel of ours: DeeperGCN's 14
# GENConv blocks (about 12 s of the CPU at full depth) and RevGEN's 8
# (about 10 s). Their main paths run at full depth on the card.
PARITY_LAYERS = {"deepergcn": 4, "revgen": 2}


def _parity_kw(model: str, kw):
    """``kw`` with the depth cut of :data:`PARITY_LAYERS`, if any."""
    if model in PARITY_LAYERS:
        return dict(kw, num_layers=PARITY_LAYERS[model])
    return kw


def phase_zoo_parity(device: torch.device, num_nodes: int = GAT_PARITY_NODES,
                     models=tuple(ZOO_KW)):
    """Each model's logits on ``device`` (K1 and K3) against the CPU's, the
    same weights, dropout off (:func:`_logit_parity`), on a 20k-node graph:
    the CPU runs the plain versions at the zoo's widths, at the depth of
    :data:`PARITY_LAYERS`."""
    return {m: _logit_parity("zoo-parity", m, device, num_nodes,
                             **_parity_kw(m, ZOO_KW[m]))
            for m in models}


def phase_zoo_quality(device: torch.device, models=tuple(ZOO_KW),
                      epochs=None):
    """Each model's ``sbm`` test accuracy over seeds 0 and 1 at its
    defaults, for its :data:`ZOO_QUALITY_EPOCHS` (or ``epochs``), held to
    the JAX package's own accuracy at the same settings less
    :data:`ZOO_QUALITY_MARGIN` (:data:`ZOO_JAX_SBM_ACC`)."""
    accs, seconds = {}, {}
    for m in models:
        t0 = time.perf_counter()
        results = experiment(
            dataset="sbm", model=m,
            epochs=epochs or ZOO_QUALITY_EPOCHS.get(m, 100), seed=[0, 1],
            device=str(device))
        seconds[m] = round(time.perf_counter() - t0, 1)
        (runs,) = results.values()
        accs[m] = float(np.mean([r["test_acc"] for r in runs]))
    print(f"[zoo-quality] sbm test_acc {json.dumps(accs)} (JAX package "
          f"{json.dumps(ZOO_JAX_SBM_ACC)}, margin {ZOO_QUALITY_MARGIN}); "
          f"seconds {json.dumps(seconds)}")
    short = {m: a for m, a in accs.items()
             if a < ZOO_JAX_SBM_ACC[m] - ZOO_QUALITY_MARGIN}
    if short:
        raise AssertionError(f"zoo-quality: sbm test_acc below the JAX "
                             f"package's less {ZOO_QUALITY_MARGIN}: {short}")
    return accs


# ---------------------------------------------------------------------------
# The rest of the full-batch zoo (ROADMAP item 12, second part)
# ---------------------------------------------------------------------------

# each model at its BEST_CONFIGS width (sign, dropedge_gcn, revgcn, grand)
# or its default (the rest), through experiment() with use_best_config=True
# on the main path's graph; AutoGNN once more over its GAT backbone
REST_KW = {
    "sign": {"hidden_size": 64, "num_hops": 3},
    "dropedge_gcn": {"hidden_size": 64, "num_layers": 4},
    "revgcn": {"hidden_size": 64, "num_layers": 8},
    "revgat": {"hidden_size": 64, "num_layers": 8, "nhead": 2},
    "revgen": {"hidden_size": 64, "num_layers": 8},
    "grand": {"hidden_size": 32, "order": 8},
    "pprgo": {"hidden_size": 64},
    "moe_gcn": {"hidden_size": 64},
    "robustgcn": {"hidden_size": 64},
    "gnnguard_gcn": {"hidden_size": 64},
    "gdc_gcn": {"hidden_size": 64},
    "actgcn": {"hidden_size": 64},
    "autognn": {"hidden_size": 64},
}
REST_RUNS = tuple((m, m, kw) for m, kw in REST_KW.items()) + (
    ("autognn-gat", "autognn", {"hidden_size": 64, "conv_type": "gat"}),)
# RevGAT's blocks: 2 heads of 32, a shape no earlier path launches
REST_GAT_SHAPES = ((2, 32),)
# K1 under live weights at the hidden width of the models that reweight
# inside their forward (DropEdge-GCN, RobustGCN, GNNGuard-GCN)
REST_LIVE_FEAT = 64
# Seeds of each model's sbm quality run: 0 and 1, but more for each model
# whose test accuracy over seeds 0-7 at 100 epochs on the CPU, in the port
# or the JAX package, reaches below its two-seed bar, so that a two-seed
# mean is a coin toss against it: 0-7 for SIGN (port 0.955-1.0 against a
# bar of 0.98), GDC-GCN (0.975-1.0 against 0.9775) and ActGCN (0.97-1.0
# against 0.975), 0-3 for RevGEN (JAX 0.91-0.985, port 0.955-0.98, against
# 0.96; 6.5 s a seed on the card) and RevGAT (JAX 0.94-1.0, port
# 0.965-1.0, at REST_QUALITY_KW). Each is held to the JAX package's mean
# over the same seeds.
REST_QUALITY_SEEDS = {"sign": 8, "gdc_gcn": 8, "actgcn": 8, "revgen": 4,
                      "revgat": 4}
# Settings of a quality run other than the model's defaults: RevGAT at
# dropout 0, because at its attention dropout of 0.1 it does not train
# stably in either package (its loss grows to 40-125 by epoch 60 in some
# seeds; JAX 0.365-1.0, port 0.40-1.0 over seeds 0-7); under the same
# attention masks its training forward and grads equal the JAX package's
# (tests/test_torch_zoo_more_ops.py), and rest-main trains it at 0.1
REST_QUALITY_KW = {"revgat": {"dropout": 0.0}}
# The JAX package's own sbm test accuracy, the mean over the seeds of
# REST_QUALITY_SEEDS (0 and 1 where it names none), on the CPU, each from
#   JAX_PLATFORMS=cpu python -c "from cogdl_tpu import experiment; \
#       experiment(dataset='sbm', model=MODEL, epochs=100, \
#                  seed=list(range(SEEDS)), **KW)"
# run from the repo root, KW from REST_QUALITY_KW; the card's bar is each
# less ZOO_QUALITY_MARGIN
REST_JAX_SBM_ACC = {
    "sign": 0.999375, "dropedge_gcn": 0.9875, "revgcn": 0.9850,
    "revgat": 0.98875, "revgen": 0.9750, "grand": 0.9750,
    "pprgo": 0.9775, "moe_gcn": 0.9750, "robustgcn": 0.9875,
    "gnnguard_gcn": 1.0000, "gdc_gcn": 0.990625, "actgcn": 0.99375,
    "autognn": 0.9975,
}


def _rest_expected(model: str, kw, steps: int, evals: int, on_card: bool):
    """K1 and K3 launches of ``model``'s run at ``kw``, by counted wrapper
    and case. A train step runs each propagation's forward over the CSR
    and, where its input takes a gradient, its backward over the CSC; an
    evaluation runs the forwards. RevGCN and RevGAT checkpoint each block:
    a train step runs its forwards twice, once more in the backward's
    recompute. SIGN: ``num_hops`` at F=100 and GRAND ``order`` at F=100,
    forward only (the features take no gradient). DropEdge-GCN:
    ``num_layers - 1`` at the hidden width and one at F=47. RevGCN: two a
    block at the hidden width. RevGAT: K3 two a block at ``(nhead,
    hidden / nhead)``. PPRGo: one at F=47. RobustGCN: two at the hidden
    width and two at F=47 (the mean's and the variance's). AutoGNN over a
    GAT backbone: K3 at (8, hidden / 8) and (1, 47). MoE-GCN, GNNGuard-GCN,
    GDC-GCN, ActGCN and AutoGNN: the hidden width and F=47. RevGEN: none."""
    if not on_card or model == "revgen":
        return {}
    expected = collections.Counter()
    hidden = kw.get("hidden_size")
    remat = 2 if model in ("revgcn", "revgat") else 1
    if model == "revgat" or kw.get("conv_type") == "gat":
        if model == "revgat":
            heads = kw["nhead"]
            layers = [(heads, hidden // heads)] * (2 * kw["num_layers"])
        else:
            layers = [(8, max(hidden // 8, 4)), (1, NUM_CLASSES)]
        for h, d in layers:
            expected.update({("dsd", h, d): steps, ("dsrc", h, d): steps,
                             ("fwd", h, d): remat * steps + evals})
        return {"gat_pass": +expected}
    if model == "sign":
        props = [(FEAT_DIM, False)] * kw["num_hops"]
    elif model == "grand":
        props = [(FEAT_DIM, False)] * kw["order"]
    elif model == "dropedge_gcn":
        props = [(hidden, True)] * (kw["num_layers"] - 1) + [
            (NUM_CLASSES, True)]
    elif model == "revgcn":
        props = [(hidden, True)] * (2 * kw["num_layers"])
    elif model == "pprgo":
        props = [(NUM_CLASSES, True)]
    elif model == "robustgcn":
        props = [(hidden, True)] * 2 + [(NUM_CLASSES, True)] * 2
    else:
        props = [(hidden, True), (NUM_CLASSES, True)]
    for feat, grad in props:
        expected[("csr", feat)] += remat * steps + evals
        expected[("csc", feat)] += steps if grad else 0
    return {"spmm_csr": +expected}


def phase_rest_kernel_check(device: torch.device, num_nodes: int = NUM_NODES,
                            iters: int = 20, gat_shapes=REST_GAT_SHAPES):
    """K3 at each of ``gat_shapes`` (RevGAT's (2, 32)) in all three modes,
    attention dropout 0 and 0.6 (:func:`phase_gat_kernel_check`); then K1
    under live weights: the
    main path's prepared graph with its weights replaced twice, the second
    time by weights that take a gradient, through ``spmm`` (one CSR and
    one CSC launch) against ``spmm_coo``'s plain autograd over the same
    weights, the output, ``dx`` and ``dw`` each within ``KERNEL_ATOL +
    LOGIT_RTOL·max|plain|``; the structure's topology the one
    ``prepare_spmm`` built. Times the K1 call over the new weights
    (``ms``, ``device_ms``), the reweight alone (``reweight_ms``, the
    gathers of E floats), ``spmm_coo`` and ``torch.sparse.mm`` over the
    new weights. Returns the measurement entries."""
    entries = phase_gat_kernel_check(device, num_nodes, iters,
                                     shapes=gat_shapes)
    g = kernel_graph(num_nodes, device)
    E, n, feat = g.num_edges, g.n_pad, REST_LIVE_FEAT
    gen = torch.Generator(device=device).manual_seed(6)

    def new_weights():
        w = torch.zeros(g.e_pad, device=device)
        w[:E] = torch.rand(E, generator=gen, device=device) * 2.0 - 0.5
        return w

    w2 = new_weights().requires_grad_(True)
    live = g.replace(edge_weight=new_weights()).replace(edge_weight=w2)
    for d in ("fw", "bw"):
        for k in ("ptr", "col", "orig") + tuple(SCHEDULE_KEYS):
            if live.extras[f"spmm_{d}_{k}"] is not g.extras[f"spmm_{d}_{k}"]:
                raise AssertionError(f"rest-kernel: a reweight rebuilt "
                                     f"spmm_{d}_{k}")
    x0 = torch.randn(n, feat, generator=gen, device=device)
    probe = torch.randn(n, feat, generator=gen, device=device)
    res = {}
    for route in ("kernel", "plain"):
        x = x0.clone().requires_grad_(True)
        if route == "kernel":
            sk.reset_launch_counts()
            w = w2
            out = spmm(live, x)
        else:
            w = w2.detach().clone().requires_grad_(True)
            out = spmm_coo(x, g.row, g.col, w, n)
        # a structure that kept its old weights leaves w out of the graph
        dx, dw = torch.autograd.grad((out * probe).sum(), (x, w),
                                     allow_unused=True)
        dw = torch.zeros_like(w) if dw is None else dw
        if route == "kernel":
            counts = _launch_counts()
        res[route] = (out.detach(), dx, dw[:E])
    want = ({"spmm_csr": {("csr", feat): 1, ("csc", feat): 1}}
            if device.type == "cuda" else {})
    if counts != want:
        raise AssertionError(f"rest-kernel: spmm under live weights launched "
                             f"{counts}; expected {want}")
    errs = {k: float((a - b).abs().max()
                     / (KERNEL_ATOL + LOGIT_RTOL * b.abs().max()))
            for k, a, b in zip(("out", "dx", "dw"), res["kernel"],
                               res["plain"])}
    name = f"spmm_csr[csr,F={feat},live weights]"
    print(f"[rest-kernel] {name} err/tol {json.dumps(errs)}")
    if not max(errs.values()) <= 1.0:
        raise AssertionError(f"{name}: K1 under live weights disagrees with "
                             f"plain autograd: {errs}")
    ex, wd = live.extras, w2.detach()
    ptr, col, fw_w = ex["spmm_fw_ptr"], ex["spmm_fw_col"], ex["spmm_fw_w"]
    fw_w, sched = fw_w.detach(), stored_schedule(ex, "fw")

    def run():
        return sk.spmm_csr(ptr, col, fw_w, x0, schedule=sched)

    lib_a = torch.sparse_csr_tensor(ptr, col, fw_w, size=(n, n),
                                    check_invariants=False)
    x_rows = int(torch.unique(col).numel())
    b_ms, b_by = bound_ms(n, col.numel(), feat, x_rows)
    device_ms, host_us = time_device_ms(run, device, iters)
    entry = {
        "name": name, "route": "cuda", "source": SPMM_SOURCE,
        "replaces": SPMM_REPLACES, "launches": None,
        "case": ["spmm_csr", "csr", feat],
        "max_abs_err": float((res["kernel"][0] - res["plain"][0]).abs().max()),
        "err_over_tol": errs, "ms": time_ms(run, device, iters),
        "device_ms": device_ms, "host_us_per_call": host_us,
        "reweight_ms": time_ms(lambda: g.replace(edge_weight=wd), device,
                               iters),
        "plain_ms": time_ms(lambda: spmm_coo(x0, g.row, g.col, wd, n),
                            device, max(iters // 4, 1)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.sparse.mm(lib_a, x0), device,
                              iters),
        "rows": n, "x_rows": x_rows, "nnz": col.numel(),
        "share_of_bound": b_ms / device_ms}
    print(f"[rest-kernel] {json.dumps(entry)}")
    return entries + [entry]


def phase_rest_main_path(device: torch.device, num_nodes: int = NUM_NODES,
                         epochs: int = ZOO_EPOCHS, runs=REST_RUNS):
    """Each run of :data:`REST_RUNS` through :func:`_zoo_runs`, held to
    :func:`_rest_expected`."""
    return _zoo_runs("rest-main", device, num_nodes, epochs, runs,
                     _rest_expected)


def phase_rest_parity(device: torch.device,
                      num_nodes: int = GAT_PARITY_NODES, runs=REST_RUNS):
    """Each run's logits on ``device`` (K1 and K3, the in-forward reweights
    included) against the CPU's, the same weights, dropout off
    (:func:`_logit_parity`), on a 20k-node graph, at the depth of
    :data:`PARITY_LAYERS`."""
    return {label: _logit_parity("rest-parity", m, device, num_nodes,
                                 **_parity_kw(m, kw))
            for label, m, kw in runs}


def phase_rest_quality(device: torch.device, models=tuple(REST_KW),
                       epochs=None):
    """Each model's mean ``sbm`` test accuracy over its
    :data:`REST_QUALITY_SEEDS` (seeds 0 and 1 where it names none) at its
    defaults but :data:`REST_QUALITY_KW`, for 100 epochs (or ``epochs``),
    held to the JAX package's own accuracy at the same settings less
    :data:`ZOO_QUALITY_MARGIN` (:data:`REST_JAX_SBM_ACC`)."""
    accs, seconds = {}, {}
    for m in models:
        t0 = time.perf_counter()
        results = experiment(
            dataset="sbm", model=m,
            epochs=epochs or 100,
            seed=list(range(REST_QUALITY_SEEDS.get(m, 2))),
            device=str(device), **REST_QUALITY_KW.get(m, {}))
        seconds[m] = round(time.perf_counter() - t0, 1)
        (runs,) = results.values()
        accs[m] = float(np.mean([r["test_acc"] for r in runs]))
    print(f"[rest-quality] sbm test_acc {json.dumps(accs)} (JAX package "
          f"{json.dumps(REST_JAX_SBM_ACC)}, margin {ZOO_QUALITY_MARGIN}); "
          f"seconds {json.dumps(seconds)}")
    short = {m: a for m, a in accs.items()
             if a < REST_JAX_SBM_ACC[m] - ZOO_QUALITY_MARGIN}
    if short:
        raise AssertionError(f"rest-quality: sbm test_acc below the JAX "
                             f"package's less {ZOO_QUALITY_MARGIN}: {short}")
    return accs


# ---------------------------------------------------------------------------
# DisenGCN and SRGCN (the end of ROADMAP item 12), then graph
# classification (item 13): union batches, GIN, SortPool, DiffPool
# ---------------------------------------------------------------------------

# the last two models of item 12 at their defaults (SRGCN: node attention,
# row-uniform normalisation) on the main path's graph; neither launches a
# kernel of ours
LAST_RUNS = (("disengcn", "disengcn", {}), ("srgcn", "srgcn", {}))
# The JAX package's own sbm test accuracy, the mean over seeds 0 and 1 at
# 100 epochs, on the CPU, each from
#   JAX_PLATFORMS=cpu python -c "from cogdl_tpu import experiment; \
#       experiment(dataset='sbm', model=MODEL, epochs=100, seed=[0, 1])"
# run from the repo root; the card's bar is each less ZOO_QUALITY_MARGIN
LAST_JAX_SBM_ACC = {"disengcn": 0.9975, "srgcn": 0.9950}
# An NCI1-scale set (NCI1 of TUDataset, Morris et al. 2020): its 4110
# graphs, its 37 node labels as the feature width, 10-50 nodes a graph
# around its mean of 29.9, two classes
GRAPH_SET = {"num_graphs": 4110, "min_nodes": 10, "max_nodes": 50,
             "feat_dim": 37, "num_classes": 2, "seed": 0}
# one of the GIN paper's two batch sizes
GRAPH_BATCH = 128
GRAPH_EPOCHS = 3
# GIN at its BEST_CONFIGS width and depth, SortPool and DiffPool at their
# defaults
GRAPH_KW = {"gin": {"hidden_size": 32, "num_layers": 5},
            "sortpool": {"hidden_size": 32, "num_layers": 3, "k": 16},
            "diffpool": {"hidden_size": 64, "num_clusters": 8}}
# the widths K1 runs at over union batches: DiffPool's clusters (its
# assignment layer and A·S), GIN's and SortPool's hidden 32, GIN's first
# layer at the input width, DiffPool's embedding
GRAPH_FEATS = (8, 32, 37, 64)
# The quality runs: graph-main's set and batches, 10 epochs, each model
# at its defaults, over seeds 0 to GRAPH_QUALITY_SEEDS - 1. Over seeds 0-7
# the port's test accuracy on the card spreads 0.898-0.928 (GIN) and
# 0.893-0.934 (SortPool), but 0.567-0.780 for DiffPool (the JAX package's
# on the CPU 0.600-0.773), whose pooled adjacency SᵀAS sums unnormalised
# edge weights (a train loss in the thousands at the start): its mean
# needs eight seeds. On the registry's 600-graph default set, two seeds
# at 50 epochs spread as widely (GIN 0.825-0.95) and missed both bars
GRAPH_QUALITY_EPOCHS = 10
GRAPH_QUALITY_SEEDS = {"gin": 4, "sortpool": 4, "diffpool": 8}
# The JAX package's own test accuracy at those settings, the mean over the
# same seeds, on the CPU, each from
#   JAX_PLATFORMS=cpu python -c "from cogdl_tpu.experiments import train; \
#       from cogdl_tpu.datasets import build_dataset; \
#       ds = build_dataset('random-graphs', num_graphs=4110, \
#                          max_nodes=50, feat_dim=37); \
#       print([train(ds, MODEL, seed=s, epochs=10, batch_size=128) \
#              ['test_acc'] for s in range(SEEDS)])"
# run from the repo root; the card's bar is each less ZOO_QUALITY_MARGIN
GRAPH_JAX_ACC = {"gin": 0.917883, "sortpool": 0.904501,
                 "diffpool": 0.680505}


@functools.lru_cache(maxsize=2)
def graph_dataset(items) -> Dataset:
    """The ``random-graphs`` set of ``dict(items)`` on the host, built once
    for the phases that share it."""
    graphs, labels = random_graphs_dataset(**dict(items))
    return Dataset.from_graphs(graphs, labels=labels, name="random-graphs")


def _graph_batches(num_graphs: int, batch_size: int):
    """The wrapper's batches a split at its default ratios (0.7 / 0.1 /
    the rest): ``(train, val, test)``."""
    n_tr, n_va = int(0.7 * num_graphs), int(0.1 * num_graphs)
    return tuple(-(-n // batch_size)
                 for n in (n_tr, n_va, num_graphs - n_tr - n_va))


def _graph_expected(model: str, kw, steps: int, evals: int, on_card: bool,
                    feat: int = GRAPH_SET["feat_dim"]):
    """K1 launches of ``model``'s run at ``kw``, by case, for ``steps``
    train batches and ``evals`` evaluated batches. A train step runs each
    propagation's forward over the CSR and, where its input takes a
    gradient, its backward over the CSC; an evaluation runs the forwards.
    GIN: its first layer sums the input features (F=``feat``, no gradient:
    no CSC), the other ``num_layers - 2`` the hidden width. SortPool:
    ``num_layers`` GCN layers at the hidden width. DiffPool: the embedding
    at the hidden width, the assignment and ``A·S`` at the cluster
    count."""
    if not on_card:
        return {}
    if model == "gin":
        props = [(feat, False)] + [(kw["hidden_size"], True)] * (
            kw["num_layers"] - 2)
    elif model == "sortpool":
        props = [(kw["hidden_size"], True)] * kw["num_layers"]
    else:
        props = [(kw["hidden_size"], True)] + [(kw["num_clusters"], True)] * 2
    expected = collections.Counter()
    for f, grad in props:
        expected[("csr", f)] += steps + evals
        expected[("csc", f)] += steps if grad else 0
    return {"spmm_csr": +expected}


def phase_graph_kernel_check(device: torch.device, graph_set=GRAPH_SET,
                             batch_size: int = GRAPH_BATCH,
                             feats=GRAPH_FEATS, iters: int = 20):
    """K1 over the structure of the main path's first train batch (a union
    of ``batch_size`` graphs, built on the host by the wrapper) in both
    directions at every width of ``feats``, checked and timed by
    :func:`_k1_entry`; then K1 and K2 at the two narrowest of those widths
    on the adversarial structures (:func:`phase_adversarial`). Returns the
    measurement entries."""
    ds = graph_dataset(tuple(sorted(graph_set.items())))
    wrapper = GraphClfWrapper(build_model(
        "gin", in_features=ds.num_features, out_features=ds.num_classes),
        ds, batch_size=batch_size, seed=0)
    wrapper.to_device(device)
    ex = wrapper.train_batches()[0].extras
    gen = torch.Generator(device=device).manual_seed(7)
    entries = [_k1_entry(f"spmm_csr[{'csr' if d == 'fw' else 'csc'},F={f},"
                         f"union batch]", ex, d, f, gen, device, iters)
               for d in ("fw", "bw") for f in feats]
    for e in entries:
        print(f"[graph-kernel] {json.dumps(e)}")
    phase_adversarial(device, feats=(min(feats), graph_set["feat_dim"]),
                      gat_shapes=())
    return entries


def _graph_epoch_profile(model: str, ds, batch_size: int,
                         device: torch.device):
    """:func:`_epoch_profile` of ``model`` at :data:`GRAPH_KW` over the
    graph classification wrapper's batches of ``ds`` on ``device``."""
    net = build_model(model, in_features=ds.num_features,
                      out_features=ds.num_classes, **GRAPH_KW[model])
    net.reset_parameters(torch.Generator().manual_seed(0))
    wrapper = GraphClfWrapper(net, ds, batch_size=batch_size, seed=0)
    wrapper.to_device(device)
    return _epoch_profile(wrapper, None, device)


def phase_graph_main_path(device: torch.device, graph_set=GRAPH_SET,
                          batch_size: int = GRAPH_BATCH,
                          epochs: int = GRAPH_EPOCHS, models=tuple(GRAPH_KW)):
    """Each model of ``models`` at :data:`GRAPH_KW` through
    ``experiment()`` (``use_best_config=True``) on the ``random-graphs``
    set of ``graph_set`` in batches of ``batch_size``, ``epochs`` epochs,
    an evaluation of every batch of the three splits each epoch and once
    more at the end: the exact K1 launches of :func:`_graph_expected`, a
    finite loss, ``train_step_ms`` (a batch), ``eval_ms`` (every batch of
    the splits), the peak of allocated card memory, ``torch.profiler``'s
    view of one more epoch (:func:`_graph_epoch_profile`) and the run's
    seconds. Returns each run's record and the launches by case summed
    over the runs."""
    ds = graph_dataset(tuple(sorted(graph_set.items())))
    n_tr, n_va, n_te = _graph_batches(len(ds), batch_size)
    steps, evals = epochs * n_tr, (epochs + 1) * (n_tr + n_va + n_te)
    on_card = device.type == "cuda"
    info, launches_by = {}, collections.Counter()
    for model in models:
        t0 = time.perf_counter()
        sk.reset_launch_counts()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        results = experiment(dataset=ds, model=model, use_best_config=True,
                             epochs=epochs, patience=epochs + 1, eval_step=1,
                             batch_size=batch_size, seed=0,
                             device=str(device), **GRAPH_KW[model])
        (res,) = next(iter(results.values()))
        counts = _launch_counts()
        expected = _graph_expected(model, GRAPH_KW[model], steps, evals,
                                   on_card, ds.num_features)
        if counts != expected:
            raise AssertionError(f"graph-main {model} ({steps} train "
                                 f"batches, {evals} evaluated batches) "
                                 f"launched {counts}; expected {expected}")
        if not np.isfinite(res["train_loss"]):
            raise AssertionError(f"graph-main {model}: loss not finite: "
                                 f"{res}")
        launches_by.update(counts.get("spmm_csr", {}))
        info[model] = {
            "train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "peak_hbm_bytes": (torch.cuda.max_memory_allocated(device)
                               if on_card else None),
            "train_loss": res["train_loss"], "test_acc": res["test_acc"],
            "epochs": epochs, "train_batches": n_tr,
            "evaluated_batches": n_tr + n_va + n_te,
            "launches": {k: {",".join(map(str, c)): v for c, v in d.items()}
                         for k, d in counts.items()},
            "profile": _graph_epoch_profile(model, ds, batch_size, device)}
        info[model]["seconds"] = time.perf_counter() - t0
    print(f"[graph-main] {json.dumps(info)}")
    info["launches_by"] = {"spmm_csr": dict(launches_by)}
    return info


def phase_last_main_path(device: torch.device, num_nodes: int = NUM_NODES,
                         epochs: int = ZOO_EPOCHS, runs=LAST_RUNS):
    """DisenGCN and SRGCN through :func:`_zoo_runs` on the main path's
    graph: no kernel of ours launched."""
    return _zoo_runs("last-main", device, num_nodes, epochs, runs,
                     lambda model, kw, steps, evals, on_card: {})


def phase_graph_parity(device: torch.device, graph_set=GRAPH_SET,
                       batch_size: int = GRAPH_BATCH,
                       models=tuple(GRAPH_KW),
                       num_nodes: int = GAT_PARITY_NODES, runs=LAST_RUNS):
    """Each graph model's logits on ``device`` (K1) against the CPU's over
    the main path's first test batch, the same weights, dropout off, the
    real graphs only, within ``LOGIT_RTOL`` / ``LOGIT_ATOL``; then DisenGCN
    and SRGCN on a 20k-node graph (:func:`_logit_parity`). Returns the
    largest logit difference a model."""
    ds = graph_dataset(tuple(sorted(graph_set.items())))
    out = {}
    for model in models:
        net = build_model(model, in_features=ds.num_features,
                          out_features=ds.num_classes, dropout=0.0,
                          **GRAPH_KW[model])
        net.reset_parameters(torch.Generator().manual_seed(0))
        logits = {}
        for dev in (torch.device("cpu"), device):
            m = copy.deepcopy(net).to(dev)
            wrapper = GraphClfWrapper(m, ds, batch_size=batch_size, seed=0)
            wrapper.to_device(dev)
            b = wrapper._batches["test"][0]
            with torch.no_grad():
                logits[dev.type] = m(b, b.x, training=False)[
                    b.extras["graph_mask"]].cpu()
        ref, got = logits["cpu"], logits[device.type]
        out[model] = float((got - ref).abs().max())
        worst = float(((got - ref).abs()
                       / (LOGIT_ATOL + LOGIT_RTOL * ref.abs())).max())
        print(f"[graph-parity] {model} max |logits_{device.type} - "
              f"logits_cpu| = {out[model]:.3g}, max |logits_cpu| = "
              f"{float(ref.abs().max()):.3g} ({ref.shape[0]} graphs); "
              f"largest share of an element's bound {worst:.3g}")
        if not torch.allclose(got, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"card {model} logits differ from CPU "
                                 f"logits by {out[model]}")
    for label, m, kw in runs:
        out[label] = _logit_parity("graph-parity", m, device, num_nodes, **kw)
    return out


def phase_graph_quality(device: torch.device, models=tuple(GRAPH_KW),
                        node_models=tuple(LAST_JAX_SBM_ACC), epochs=None,
                        graph_set=GRAPH_SET, batch_size: int = GRAPH_BATCH):
    """Each graph model's mean test accuracy over its
    :data:`GRAPH_QUALITY_SEEDS` on the ``random-graphs`` set of
    ``graph_set`` in batches of ``batch_size``, for
    :data:`GRAPH_QUALITY_EPOCHS` (or ``epochs``), and DisenGCN's and
    SRGCN's on ``sbm`` over seeds 0 and 1 for 100, each held to the JAX
    package's own accuracy at the same settings less
    :data:`ZOO_QUALITY_MARGIN` (:data:`GRAPH_JAX_ACC`,
    :data:`LAST_JAX_SBM_ACC`)."""
    ds = graph_dataset(tuple(sorted(graph_set.items())))
    runs = [(m, ds, GRAPH_QUALITY_SEEDS[m], epochs or GRAPH_QUALITY_EPOCHS,
             {"batch_size": batch_size}, GRAPH_JAX_ACC[m]) for m in models]
    runs += [(m, "sbm", 2, epochs or 100, {}, LAST_JAX_SBM_ACC[m])
             for m in node_models]
    accs, bars, seconds = {}, {}, {}
    for m, dataset, seeds, n_epochs, kw, jax_acc in runs:
        t0 = time.perf_counter()
        results = experiment(dataset=dataset, model=m, epochs=n_epochs,
                             seed=list(range(seeds)), device=str(device),
                             **kw)
        seconds[m] = round(time.perf_counter() - t0, 1)
        (res,) = results.values()
        accs[m] = float(np.mean([r["test_acc"] for r in res]))
        bars[m] = jax_acc - ZOO_QUALITY_MARGIN
    print(f"[graph-quality] test_acc {json.dumps(accs)} (JAX package "
          f"{json.dumps({**GRAPH_JAX_ACC, **LAST_JAX_SBM_ACC})}, margin "
          f"{ZOO_QUALITY_MARGIN}); seconds {json.dumps(seconds)}")
    short = {m: a for m, a in accs.items() if a < bars[m]}
    if short:
        raise AssertionError(f"graph-quality: test_acc below the JAX "
                             f"package's less {ZOO_QUALITY_MARGIN}: {short}")
    return accs


# ---------------------------------------------------------------------------
# The heterogeneous family (ROADMAP item 13b): HAN, GTN, RGCN, CompGCN and
# Simple-HGN on the heterogeneous_gnn wrapper
# ---------------------------------------------------------------------------

# ACM as the HAN paper uses it (Wang et al., "Heterogeneous Graph Attention
# Network", WWW 2019; reference han_data.py): 1,870 features, 3 classes and
# the two metapaths PAP and PLP. 7,500 nodes give about ACM's metapath
# edges (PAP + PLP = 2,240,042): 1,086,268 and 1,086,132 with the self
# loops, rows of at most 194 edges; the union graph 2,157,400 edges
# (n_pad 8,192, e_pad 2,621,440)
HETERO_SET = {"num_nodes": 7500, "num_classes": 3, "feat_dim": 1870,
              "num_metapaths": 2, "seed": 0}
# CompGCN's first layer keeps [e_pad, F_in] tensors over the union graph
# (source rows, relations, messages, weighted messages): 19.6 GB each at
# 7,500 nodes, more than 80 GB with four alive. It runs at ACM's 3,025
# nodes (e_pad 393,216, 2.9 GB each); the other four at HETERO_SET's
HETERO_COMPGCN_NODES = 3025
# each model at its BEST_CONFIGS width (han, gtn, simple_hgn) or its
# default (rgcn, compgcn, with the set's two relations), through
# experiment() with use_best_config=True
HETERO_KW = {
    "han": {"hidden_size": 8, "nhead": 8, "dropout": 0.6},
    "gtn": {"hidden_size": 64, "num_channels": 2, "num_gt_layers": 2},
    "rgcn": {"hidden_size": 64, "num_layers": 2, "num_relations": 2},
    "compgcn": {"hidden_size": 64, "num_relations": 2},
    "simple_hgn": {"hidden_size": 64, "nhead": 8, "edge_dim": 64,
                   "num_layers": 2},
}
HETERO_EPOCHS = 5
# HAN's GAT layers over each metapath graph: 8 heads of 8
HETERO_GAT_SHAPES = ((8, 8),)
HETERO_PARITY_NODES = 1500
# The quality runs: the registry's default hetero-sbm (300 nodes, 16
# features), each model at its defaults (RGCN and CompGCN at the set's two
# relations), 100 epochs, over seeds 0 to HETERO_QUALITY_SEEDS - 1
HETERO_QUALITY_SEEDS = 4
HETERO_QUALITY_EPOCHS = 100
HETERO_QUALITY_KW = {"rgcn": {"num_relations": 2},
                     "compgcn": {"num_relations": 2}}
# The JAX package's own test accuracy at those settings, the mean over the
# same seeds, on the CPU, each from
#   JAX_PLATFORMS=cpu python -c "from cogdl_tpu.experiments import train; \
#       print([train('hetero-sbm', MODEL, seed=s, epochs=100, **KW) \
#              ['test_acc'] for s in range(4)])"
# run from the repo root, KW from HETERO_QUALITY_KW; the card's bar is each
# less ZOO_QUALITY_MARGIN
HETERO_JAX_ACC = {"han": 0.971667, "gtn": 0.981667, "rgcn": 0.995000,
                  "compgcn": 0.996667, "simple_hgn": 0.983333}


@functools.lru_cache(maxsize=2)
def hetero_dataset(items) -> Dataset:
    """The ``hetero-sbm`` set of ``dict(items)`` on the host, built once for
    the phases that share it."""
    return Dataset.from_graph(hetero_sbm_graph(**dict(items)),
                              name="hetero-sbm")


def _hetero_items(hetero_set, num_nodes=None):
    if num_nodes is not None:
        hetero_set = dict(hetero_set, num_nodes=num_nodes)
    return tuple(sorted(hetero_set.items()))


def _hetero_expected(model: str, kw, steps: int, evals: int, on_card: bool,
                     feat: int = HETERO_SET["feat_dim"],
                     metapaths: int = HETERO_SET["num_metapaths"]):
    """K1 and K3 launches of ``model``'s run at ``kw``, by counted wrapper
    and case, over ``metapaths`` metapath graphs. HAN: each layer runs K3's
    fwd, dsd and dsrc at ``(nhead, hidden_size)`` over each metapath graph
    a train step, fwd an evaluation. GTN: each of ``num_channels`` channels
    runs ``num_gt_layers`` mixtures of a K1 over each relation graph at the
    input width ``feat``, forward over the CSR a step and an evaluation;
    the first layer's input (the features) takes no gradient, so only the
    later layers run the CSC on a step. RGCN, CompGCN and Simple-HGN:
    none."""
    if not on_card or model not in ("han", "gtn"):
        return {}
    if model == "han":
        layers = kw.get("num_layers", 1) * metapaths
        shape = (kw["nhead"], kw["hidden_size"])
        expected = collections.Counter(
            {(m,) + shape: layers * steps for m in sk.GAT_MODES})
        expected[("fwd",) + shape] += layers * evals
        return {"gat_pass": +expected}
    channels, gt_layers = kw["num_channels"], kw.get("num_gt_layers", 2)
    return {"spmm_csr": +collections.Counter({
        ("csr", feat): channels * gt_layers * metapaths * (steps + evals),
        ("csc", feat): channels * (gt_layers - 1) * metapaths * steps})}


def phase_hetero_kernel_check(device: torch.device, hetero_set=HETERO_SET,
                              iters: int = 20):
    """K1 over the first metapath graph of the set's structure (as the
    wrapper prepares it) in both directions at the input width, checked and
    timed by :func:`_k1_entry`; K3 at HAN's (8, 8) over the same structure
    in its three modes at attention dropout 0 and 0.6
    (:func:`phase_gat_kernel_check`). Returns the measurement entries."""
    ds = hetero_dataset(_hetero_items(hetero_set))
    g = prepare_spmm(ds.graph.extras["metapath_graphs"][0].to(device))
    gen = torch.Generator(device=device).manual_seed(11)
    feat = hetero_set["feat_dim"]
    entries = [_k1_entry(f"spmm_csr[{'csr' if d == 'fw' else 'csc'},F={feat},"
                         f"metapath]", g.extras, d, feat, gen, device, iters)
               for d in ("fw", "bw")]
    for e, d in zip(entries, ("fw", "bw")):
        ptr = g.extras[f"spmm_{d}_ptr"]
        e["max_row_nnz"] = int((ptr[1:] - ptr[:-1]).max())
        print(f"[hetero-kernel] {json.dumps(e)}")
    return entries + phase_gat_kernel_check(
        device, iters=iters, shapes=HETERO_GAT_SHAPES, graph=g,
        label=",metapath")


def _hetero_step_profile(model: str, ds, device: torch.device):
    """``torch.profiler``'s view (:func:`profile_window`) of one train step
    of ``model`` at :data:`HETERO_KW` on the heterogeneous wrapper over
    ``ds``'s graph on ``device``, after two steps of warm-up."""
    net = build_model(model, in_features=ds.num_features,
                      out_features=ds.num_classes, **HETERO_KW[model])
    wrapper = HeterogeneousGNNWrapper(net)
    wrapper.init(torch.Generator().manual_seed(0), ds.graph)
    net.to(device)
    prepared = wrapper.prepare_graph(ds.graph.to(device))
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    gen = torch.Generator(device=device).manual_seed(1)

    def step():
        opt.zero_grad(set_to_none=True)
        wrapper.loss(prepared, gen).backward()
        opt.step()
        _sync(device)

    step()
    step()
    return profile_window(step, device)


def phase_hetero_main_path(device: torch.device, hetero_set=HETERO_SET,
                           compgcn_nodes: int = HETERO_COMPGCN_NODES,
                           epochs: int = HETERO_EPOCHS,
                           models=tuple(HETERO_KW)):
    """Each model of ``models`` at :data:`HETERO_KW` through
    ``experiment()`` (``use_best_config=True``) on the ``hetero-sbm`` set
    of ``hetero_set`` (CompGCN at ``compgcn_nodes``), ``epochs`` epochs
    with an evaluation each and one more at the end: the exact K1 and K3
    launches of :func:`_hetero_expected` and no other counted kernel, a
    finite loss, ``train_step_ms``, ``eval_ms``, the peak of allocated card
    memory, ``torch.profiler``'s view of one more step
    (:func:`_hetero_step_profile`) and the run's seconds. Returns each
    run's record and the launches by case summed over the runs."""
    on_card = device.type == "cuda"
    info, launches_by = {}, collections.defaultdict(collections.Counter)
    for model in models:
        nodes = (compgcn_nodes if model == "compgcn"
                 else hetero_set["num_nodes"])
        ds = hetero_dataset(_hetero_items(hetero_set, nodes))
        t0 = time.perf_counter()
        sk.reset_launch_counts()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        results = experiment(dataset=ds, model=model, use_best_config=True,
                             epochs=epochs, patience=epochs + 1, eval_step=1,
                             seed=0, device=str(device), **HETERO_KW[model])
        (res,) = next(iter(results.values()))
        counts = _launch_counts()
        expected = _hetero_expected(model, HETERO_KW[model], epochs,
                                    epochs + 1, on_card,
                                    hetero_set["feat_dim"],
                                    hetero_set["num_metapaths"])
        if counts != expected:
            raise AssertionError(f"hetero-main {model} ({epochs} steps, "
                                 f"{epochs + 1} evaluations) launched "
                                 f"{counts}; expected {expected}")
        if not np.isfinite(res["train_loss"]):
            raise AssertionError(f"hetero-main {model}: loss not finite: "
                                 f"{res}")
        for kernel, by_case in counts.items():
            launches_by[kernel].update(by_case)
        info[model] = {
            "nodes": nodes, "edges": ds.graph.num_edges,
            "train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "peak_hbm_bytes": (torch.cuda.max_memory_allocated(device)
                               if on_card else None),
            "train_loss": res["train_loss"], "test_acc": res["test_acc"],
            "epochs": epochs,
            "launches": {k: {",".join(map(str, c)): v for c, v in d.items()}
                         for k, d in counts.items()},
            "profile": _hetero_step_profile(model, ds, device)}
        info[model]["seconds"] = time.perf_counter() - t0
    print(f"[hetero-main] {json.dumps(info)}")
    info["launches_by"] = {k: dict(v) for k, v in launches_by.items()}
    return info


def phase_hetero_parity(device: torch.device, hetero_set=HETERO_SET,
                        num_nodes: int = HETERO_PARITY_NODES,
                        models=tuple(HETERO_KW)):
    """Each model's logits on ``device`` (K1 for GTN, K3 for HAN over the
    metapath graphs the wrapper prepares) against the CPU's (their plain
    versions over bare graphs), the same weights, dropout off, the real
    nodes, on the set at ``num_nodes`` nodes and its full width: the
    largest difference within ``LOGIT_ATOL + LOGIT_RTOL·max|logits|``.
    The bound scales with the largest logit, not each logit's own: GTN
    propagates unnormalised adjacencies twice, so its hidden rows reach
    about 4e4 and its logits 1.6e3, and a logit near 0 carries the
    rounding of those sums (2e-3 apart on the card, where each element's
    own bound would be 1e-4). Returns each model's largest logit
    difference and largest logit magnitude."""
    ds = hetero_dataset(_hetero_items(hetero_set, num_nodes))
    g = ds.graph
    out = {}
    for model in models:
        kw = dict(HETERO_KW[model], dropout=0.0)
        if model == "simple_hgn":
            kw["attn_drop"] = 0.0
        net = build_model(model, in_features=ds.num_features,
                          out_features=ds.num_classes, **kw)
        HeterogeneousGNNWrapper(net).init(torch.Generator().manual_seed(0), g)
        t0 = time.perf_counter()
        logits = []
        for dev in (torch.device("cpu"), device):
            m = copy.deepcopy(net).to(dev)
            prepared = HeterogeneousGNNWrapper(m).prepare_graph(g.to(dev))
            with torch.no_grad():
                logits.append(m(prepared, prepared.x, training=False)[
                    :g.num_nodes].cpu())
        ref, got = logits
        out[model] = {"max_abs_diff": float((got - ref).abs().max()),
                      "max_abs_logit": float(ref.abs().max())}
        print(f"[hetero-parity] {model} max |logits_{device.type} - "
              f"logits_cpu| = {out[model]['max_abs_diff']:.3g}, max "
              f"|logits_cpu| = {out[model]['max_abs_logit']:.3g} "
              f"({g.num_nodes} nodes, {time.perf_counter() - t0:.1f} s)")
        if not (out[model]["max_abs_diff"] <= LOGIT_ATOL + LOGIT_RTOL *
                out[model]["max_abs_logit"]):
            raise AssertionError(f"card {model} logits differ from CPU "
                                 f"logits by {out[model]['max_abs_diff']}, "
                                 f"logits up to "
                                 f"{out[model]['max_abs_logit']}")
    return out


def phase_hetero_quality(device: torch.device, models=tuple(HETERO_KW),
                         seeds: int = HETERO_QUALITY_SEEDS,
                         epochs: int = HETERO_QUALITY_EPOCHS):
    """Each model's mean test accuracy on the default ``hetero-sbm`` over
    seeds 0 to ``seeds - 1`` at its defaults (:data:`HETERO_QUALITY_KW`)
    for ``epochs`` epochs, held to the JAX package's own accuracy at the
    same settings less :data:`ZOO_QUALITY_MARGIN`
    (:data:`HETERO_JAX_ACC`)."""
    accs, seconds = {}, {}
    for m in models:
        t0 = time.perf_counter()
        results = experiment(dataset="hetero-sbm", model=m, epochs=epochs,
                             seed=list(range(seeds)), device=str(device),
                             **HETERO_QUALITY_KW.get(m, {}))
        seconds[m] = round(time.perf_counter() - t0, 1)
        (runs,) = results.values()
        accs[m] = float(np.mean([r["test_acc"] for r in runs]))
    print(f"[hetero-quality] test_acc {json.dumps(accs)} (JAX package "
          f"{json.dumps(HETERO_JAX_ACC)}, margin {ZOO_QUALITY_MARGIN}); "
          f"seconds {json.dumps(seconds)}")
    short = {m: a for m, a in accs.items()
             if a < HETERO_JAX_ACC[m] - ZOO_QUALITY_MARGIN}
    if short:
        raise AssertionError(f"hetero-quality: test_acc below the JAX "
                             f"package's less {ZOO_QUALITY_MARGIN}: {short}")
    return accs


# ---------------------------------------------------------------------------
# The node-classification stragglers (ROADMAP item 13c): Graph U-Net,
# GCNMix, SAGN, M3S, Correct & Smooth and PATCHY-SAN
# ---------------------------------------------------------------------------

# each model at its BEST_CONFIGS width (sagn, gcnmix) or its default (the
# rest; C&S's 50 + 50 steps are the JAX defaults), through experiment()
# with use_best_config=True on the main path's graph
STRAGGLER_KW = {
    "graph_unet": {"hidden_size": 64, "pooling_rates": (0.5, 0.5)},
    "gcnmix": {"hidden_size": 64, "alpha": 1.0},
    "sagn": {"hidden_size": 64, "num_hops": 3},
    "m3s": {"hidden_size": 64},
    "correct_smooth_mlp": {"hidden_size": 64, "num_layers": 3,
                           "correct_steps": 50, "smooth_steps": 50},
}
STRAGGLER_EPOCHS = 5
# the staged wrappers (SAGN, M3S) train this many stages of
# STRAGGLER_EPOCHS each
STRAGGLER_STAGES = 2
STAGED = ("sagn", "m3s")
# SAGN's pseudo-label threshold on the main path's graph: its features and
# labels are random, so after 5 epochs the softmax maximum is about 1/47
# to 0.1 (median 0.057 at 20k nodes on the CPU); 0.06 makes stage 1 take
# labels, where the default 0.9 would take none
STRAGGLER_SAGN_THRESHOLD = 0.06
# the runs of straggler-main: each model, and the alias unet at one epoch
STRAGGLER_RUNS = tuple((m, m, kw) for m, kw in STRAGGLER_KW.items()) + (
    ("unet", "unet", STRAGGLER_KW["graph_unet"]),)
# PATCHY-SAN at its defaults (width 16, k 8, hidden 32) on graph-main's
# NCI1-scale set: one train batch of [2877, 16, 8, 37]
PATCHY_KW = {"hidden_size": 32, "width": 16, "k": 8}
PATCHY_EPOCHS = 3
PATCHY_PARITY_GRAPHS = 512
# The quality runs: each model's mean test accuracy over seeds 0 to
# SEEDS - 1 at its defaults for 100 epochs (each stage of the staged
# wrappers), on sbm (PATCHY-SAN on the default random-graphs). Four seeds,
# but more where a package's accuracy over seeds 0-7 on the CPU spreads
# wider than the margin: 8 for Graph U-Net (port 0.975-1.0), GCNMix (JAX
# 0.975-1.0), SAGN (port 0.955-1.0) and M3S (JAX 0.965-0.995); 16 for
# PATCHY-SAN, whose 60 default graphs leave 12 in the test split (JAX
# 0.33-0.75 over seeds 0-15, port 0.42-0.92 over 0-7). On sbm every node
# is in a split, so SAGN's and M3S's second stage adds no label there
STRAGGLER_QUALITY_SEEDS = {"graph_unet": 8, "gcnmix": 8, "sagn": 8,
                           "m3s": 8, "correct_smooth_mlp": 4,
                           "patchy_san": 16}
# The JAX package's own test accuracy at those settings, the mean over the
# same seeds, on the CPU, each from
#   JAX_PLATFORMS=cpu python -c "from cogdl_tpu import experiment; \
#       experiment(dataset=DATASET, model=MODEL, epochs=100, \
#                  seed=list(range(SEEDS)))"
# run from the repo root, DATASET sbm (random-graphs for patchy_san); the
# card's bar is each less ZOO_QUALITY_MARGIN
STRAGGLER_JAX_ACC = {"graph_unet": 0.98875, "gcnmix": 0.9925,
                     "sagn": 0.998125, "m3s": 0.985,
                     "correct_smooth_mlp": 0.9975, "patchy_san": 0.53125}


def held_out_split(g, seed: int = 0):
    """``g`` with the real nodes outside its train split cut in three by a
    seeded permutation: a third val, a third test, a third in no split.
    The main path's graph puts every node in a split (val and test are
    both the rest), which leaves SAGN's pseudo-labels and M3S's expansion
    no node to label; a Planetoid split leaves most of Cora in none."""
    rest = torch.nonzero(~g.train_mask & g.node_mask()).flatten().cpu()
    rest = rest[torch.from_numpy(
        np.random.default_rng(seed).permutation(rest.numel()))]
    third = rest.numel() // 3
    val = torch.zeros_like(g.train_mask)
    test = torch.zeros_like(g.train_mask)
    val[rest[:third].to(val.device)] = True
    test[rest[third: 2 * third].to(test.device)] = True
    return g.replace(val_mask=val, test_mask=test)


def _straggler_expected(model: str, kw, steps: int, evals: int,
                        on_card: bool, stages: int = 1):
    """K1 launches of ``model``'s run at ``kw``, by case, for ``steps``
    train steps, ``evals`` evaluations and ``stages`` stages. A train step
    runs each propagation's forward over the CSR and, where its input takes
    a gradient, its backward over the CSC; an evaluation runs the
    forwards. Graph U-Net: ``in_gcn``, a down and an up layer a level, all
    at the hidden width. GCNMix: the hidden width and F=47. SAGN:
    ``num_hops`` at F=100, forward only (the features take no gradient),
    and once more at each later stage's ``pre_stage``. M3S: the hidden
    width and F=47, and ``embed``'s first layer at each later stage. C&S:
    none a step, ``correct_steps + smooth_steps`` at F=47 an evaluation.
    PATCHY-SAN: none."""
    if not on_card or model == "patchy_san":
        return {}
    hidden = kw.get("hidden_size", 64)
    later = stages - 1
    expected = collections.Counter()
    if model == "correct_smooth_mlp":
        expected[("csr", NUM_CLASSES)] = evals * (
            kw.get("correct_steps", 50) + kw.get("smooth_steps", 50))
        props = []
    elif model in ("graph_unet", "unet"):
        levels = len(kw.get("pooling_rates", (0.5, 0.5)))
        props = [(hidden, True, 0)] * (1 + 2 * levels)
    elif model == "gcnmix":
        props = [(hidden, True, 0), (NUM_CLASSES, True, 0)]
    elif model == "sagn":
        props = [(FEAT_DIM, False, later)] * kw.get("num_hops", 3)
    else:
        props = [(hidden, True, later), (NUM_CLASSES, True, 0)]
    for feat, grad, extra in props:
        expected[("csr", feat)] += steps + evals + extra
        expected[("csc", feat)] += steps if grad else 0
    return {"spmm_csr": +expected} if +expected else {}


def _unet_kept(graph, device: torch.device, kw, normalised_by_norm):
    """The kept count at each of Graph U-Net's levels, from seeded weights
    over the normalised ``graph`` (cached by :func:`_step_profile`) with
    its structure on ``device``."""
    net = build_model("graph_unet", in_features=FEAT_DIM,
                      out_features=NUM_CLASSES, **kw)
    net.reset_parameters(torch.Generator().manual_seed(0))
    wrapper = NodeClfWrapper(net.to(device))
    if "sym" not in normalised_by_norm:
        normalised_by_norm["sym"] = wrapper.normalise(graph.to("cpu"))
    prepared = wrapper.with_structure(normalised_by_norm["sym"].to(device))
    with torch.no_grad():
        _, levels = net(prepared, return_levels=True)
    return [int(keep.sum()) for _, _, keep in levels]


def phase_straggler_main(device: torch.device, num_nodes: int = NUM_NODES,
                         epochs: int = STRAGGLER_EPOCHS,
                         runs=STRAGGLER_RUNS, graph_set=GRAPH_SET,
                         patchy_epochs: int = PATCHY_EPOCHS,
                         iters: int = 20):
    """Each run of :data:`STRAGGLER_RUNS` through ``experiment()``
    (``use_best_config=True``) on the main path's graph for ``epochs``
    epochs (``unet`` for one), an evaluation each and one at the end; SAGN
    and M3S for :data:`STRAGGLER_STAGES` stages over the graph with a third
    of its non-train nodes in no split (:func:`held_out_split`), SAGN at
    :data:`STRAGGLER_SAGN_THRESHOLD`: the exact K1 launches of
    :func:`_straggler_expected` and no other counted kernel, a finite loss,
    ``train_step_ms``, ``eval_ms``, the peak of allocated card memory,
    the labels a later stage added (at least one) and M3S's KMeans time,
    ``torch.profiler``'s view of one more train step
    (:func:`_step_profile`, on the model's own wrapper; C&S's evaluation
    too), Graph U-Net's kept count a level, and the run's seconds. Then
    PATCHY-SAN at :data:`PATCHY_KW` on graph-main's set for
    ``patchy_epochs`` epochs: no kernel launched, a profiled epoch. Last,
    K1 over the main path's CSR at F=100 (SAGN's hops, a width no earlier
    entry has) measured by :func:`_k1_entry`. Returns each run's record,
    the launches by case summed over the runs and the entry."""
    g = main_graph(num_nodes)
    datasets = {False: Dataset.from_graph(g, name=f"powerlaw-{num_nodes}"),
                True: Dataset.from_graph(held_out_split(g),
                                         name=f"powerlaw-{num_nodes}")}
    on_card = device.type == "cuda"
    info, launches_by = {}, collections.defaultdict(collections.Counter)
    normalised_by_norm = {}
    for label, model, kw in runs:
        staged = model in STAGED
        stages = STRAGGLER_STAGES if staged else 1
        n_epochs = 1 if label == "unet" else epochs
        extra = ({"num_stages": stages} if staged else {})
        if model == "sagn":
            extra["threshold"] = STRAGGLER_SAGN_THRESHOLD
        t0 = time.perf_counter()
        sk.reset_launch_counts()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        results = experiment(dataset=datasets[staged], model=model,
                             use_best_config=True, epochs=n_epochs,
                             patience=n_epochs + 1, eval_step=1, seed=0,
                             device=str(device), **kw, **extra)
        (res,) = next(iter(results.values()))
        counts = _launch_counts()
        steps = n_epochs * stages
        expected = _straggler_expected(model, kw, steps, steps + 1, on_card,
                                       stages)
        if counts != expected:
            raise AssertionError(f"straggler-main {label} ({steps} steps, "
                                 f"{steps + 1} evaluations, {stages} "
                                 f"stages) launched {counts}; expected "
                                 f"{expected}")
        if not np.isfinite(res["train_loss"]):
            raise AssertionError(f"straggler-main {label}: loss not finite: "
                                 f"{res}")
        record = res.get("stages", {})
        added = [r.get("pseudo_labels", r.get("new_labels", 0))
                 for r in record.values()]
        if staged and (len(added) != stages - 1 or not all(added)):
            raise AssertionError(f"straggler-main {label}: a later stage "
                                 f"added no label: {record}")
        for kernel, by_case in counts.items():
            launches_by[kernel].update(by_case)
        wrapper_cls = fetch_wrapper(default_wrapper_for(model))
        info[label] = {
            "train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "peak_hbm_bytes": (torch.cuda.max_memory_allocated(device)
                               if on_card else None),
            "train_loss": res["train_loss"], "epochs": n_epochs,
            "stages": stages, "stage_record": record,
            "launches": {k: {",".join(map(str, c)): v for c, v in d.items()}
                         for k, d in counts.items()},
            "profile": _step_profile(model, kw, g, device,
                                     normalised_by_norm, wrapper_cls)}
        if model in ("graph_unet", "unet"):
            info[label]["kept"] = _unet_kept(g, device, kw,
                                              normalised_by_norm)
        if model == "correct_smooth_mlp":
            info[label]["eval_launches"] = (
                kw["correct_steps"] + kw["smooth_steps"] if on_card else 0)
            info[label]["eval_profile"] = _eval_profile(
                model, kw, device, normalised_by_norm, wrapper_cls)
        info[label]["seconds"] = time.perf_counter() - t0
    info["patchy_san"] = _patchy_main(device, graph_set, patchy_epochs)
    print(f"[straggler-main] {json.dumps(info)}")
    kg = kernel_graph(num_nodes, device)
    entry = _k1_entry(f"spmm_csr[csr,F={FEAT_DIM}]", kg.extras, "fw",
                      FEAT_DIM, torch.Generator(device=device).manual_seed(8),
                      device, iters)
    print(f"[straggler-main] {json.dumps(entry)}")
    info["launches_by"] = {k: dict(v) for k, v in launches_by.items()}
    info["entries"] = [entry]
    return info


def _eval_profile(model: str, kw, device: torch.device, normalised_by_norm,
                  wrapper_cls):
    """``torch.profiler``'s view of one evaluation of ``model`` on its
    wrapper over the normalised graph that :func:`_step_profile` cached,
    after one of warm-up."""
    net = build_model(model, in_features=FEAT_DIM, out_features=NUM_CLASSES,
                      **kw)
    net.reset_parameters(torch.Generator().manual_seed(0))
    wrapper = wrapper_cls(net.to(device))
    prepared = wrapper.with_structure(normalised_by_norm["sym"].to(device))

    def evaluate():
        float(wrapper.evaluate(prepared)["val_acc"])

    evaluate()
    return profile_window(evaluate, device)


def _patchy_main(device: torch.device, graph_set, epochs: int):
    """PATCHY-SAN through ``experiment()`` on the set of ``graph_set``:
    no counted kernel, a finite loss, the times, the peak of card memory,
    and ``torch.profiler``'s view of one more epoch of its one train
    batch (:func:`_epoch_profile`)."""
    ds = graph_dataset(tuple(sorted(graph_set.items())))
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    sk.reset_launch_counts()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    results = experiment(dataset=ds, model="patchy_san", epochs=epochs,
                         patience=epochs + 1, eval_step=1, seed=0,
                         device=str(device), **PATCHY_KW)
    (res,) = next(iter(results.values()))
    counts = _launch_counts()
    if counts:
        raise AssertionError(f"straggler-main patchy_san launched {counts}; "
                             "expected no kernel of ours")
    if not np.isfinite(res["train_loss"]):
        raise AssertionError(f"straggler-main patchy_san: loss not finite: "
                             f"{res}")
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    net = build_model("patchy_san", in_features=ds.num_features,
                      out_features=ds.num_classes, **PATCHY_KW)
    wrapper = PatchySANWrapper(net, ds, seed=0)
    wrapper.init(torch.Generator().manual_seed(0))
    wrapper.to_device(device)
    X, _ = wrapper.train_batches()[0]
    return {"train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
            "peak_hbm_bytes": peak, "train_loss": res["train_loss"],
            "test_acc": res["test_acc"], "epochs": epochs,
            "train_batch": list(X.shape), "launches": {},
            "profile": _epoch_profile(wrapper, None, device),
            "seconds": time.perf_counter() - t0}


def _straggler_forward(net, model: str, g, device: torch.device):
    """``net``'s output over ``g`` on ``device`` with dropout off, through
    its wrapper's preparation: logits, C&S's after ``postprocess``, and
    Graph U-Net's levels (score, thresh, keep) on the host."""
    m = copy.deepcopy(net).to(device)
    prepared = NodeClfWrapper(m).prepare_graph(g.to(device))
    levels = []
    with torch.no_grad():
        if model == "graph_unet":
            out, levels = m(prepared, return_levels=True)
            levels = [(s.cpu(), float(t), k[:, 0].cpu()) for s, t, k in levels]
        else:
            out = m(prepared, training=False)
        if model == "correct_smooth_mlp":
            out = m.postprocess(prepared, out)
    return out[: g.num_nodes].cpu(), levels


def _keep_margin(score: torch.Tensor, thresh: float, n: int) -> float:
    """How far the kept set is from a flip: the k-th score less the largest
    real score below it (inf where none lies below)."""
    below = score[:n][score[:n] < thresh]
    return float(thresh - below.max()) if below.numel() else float("inf")


def phase_straggler_parity(device: torch.device,
                           num_nodes: int = GAT_PARITY_NODES,
                           models=tuple(STRAGGLER_KW), graph_set=GRAPH_SET,
                           patchy_graphs: int = PATCHY_PARITY_GRAPHS):
    """Each model's output on ``device`` (K1) against the CPU's (its plain
    version), the same seeded weights, dropout off, on a 20k-node graph:
    C&S's after ``postprocess``; the largest difference within
    ``LOGIT_ATOL + LOGIT_RTOL·max|out|``, printed beside that magnitude.
    For Graph U-Net also each level's keep masks (equal or not), the
    smallest margin of its threshold (:func:`_keep_margin`, the CPU's) and
    the largest card-against-CPU score difference among the real nodes of
    its mask. Then PATCHY-SAN over the first ``patchy_graphs`` graphs of
    graph-main's set. Returns each model's record."""
    g = parity_graph(num_nodes)
    out = {}
    for model in models:
        net = build_model(model, in_features=FEAT_DIM,
                          out_features=NUM_CLASSES, dropout=0.0,
                          **STRAGGLER_KW[model])
        net.reset_parameters(torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        (ref, ref_levels), (got, got_levels) = (
            _straggler_forward(net, model, g, dev)
            for dev in (torch.device("cpu"), device))
        rec = {"max_abs_diff": float((got - ref).abs().max()),
               "max_abs_out": float(ref.abs().max())}
        if model == "graph_unet":
            rec["keep_equal"] = [bool(torch.equal(a[2], b[2]))
                                 for a, b in zip(ref_levels, got_levels)]
            rec["kept"] = [int(a[2].sum()) for a in ref_levels]
            rec["min_margin"] = min(_keep_margin(s, t, num_nodes)
                                    for s, t, _ in ref_levels)
            rec["max_score_diff"] = max(
                float((a[0][:num_nodes] - b[0][:num_nodes])[
                    a[2][:num_nodes] > 0].abs().max())
                for a, b in zip(ref_levels, got_levels))
        rec["seconds"] = time.perf_counter() - t0
        out[model] = rec
        print(f"[straggler-parity] {model} {json.dumps(rec)}")
    ds = graph_dataset(tuple(sorted(graph_set.items())))
    graphs = ds.graphs[:patchy_graphs]
    fields = assemble_fields(graphs, width=PATCHY_KW["width"],
                             k=PATCHY_KW["k"])
    feats = torch.from_numpy(np.stack(
        [gr.x.numpy()[f] for gr, f in zip(graphs, fields)]))
    net = build_model("patchy_san", in_features=ds.num_features,
                      out_features=ds.num_classes, dropout=0.0, **PATCHY_KW)
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = net(feats)
        got = copy.deepcopy(net).to(device)(feats.to(device)).cpu()
    out["patchy_san"] = {"max_abs_diff": float((got - ref).abs().max()),
                         "max_abs_out": float(ref.abs().max()),
                         "graphs": len(graphs)}
    print(f"[straggler-parity] patchy_san {json.dumps(out['patchy_san'])}")
    bad = {m: r for m, r in out.items()
           if not r["max_abs_diff"] <= LOGIT_ATOL + LOGIT_RTOL *
           r["max_abs_out"]}
    if bad:
        raise AssertionError(f"straggler-parity: {device.type} outputs "
                             f"differ from CPU outputs beyond LOGIT_ATOL + "
                             f"LOGIT_RTOL·max|out|: {bad}")
    return out


def phase_straggler_quality(device: torch.device,
                            models=tuple(STRAGGLER_QUALITY_SEEDS),
                            epochs=None, seeds=None):
    """Each model's mean test accuracy over its
    :data:`STRAGGLER_QUALITY_SEEDS` (or ``seeds``) at its defaults for 100
    epochs (or ``epochs``) on ``sbm`` (PATCHY-SAN on the default
    ``random-graphs``), held to the JAX package's own accuracy at the same
    settings less :data:`ZOO_QUALITY_MARGIN` (:data:`STRAGGLER_JAX_ACC`).
    M3S clusters with the port's KMeans: no scikit-learn."""
    accs, per_seed, seconds = {}, {}, {}
    for m in models:
        t0 = time.perf_counter()
        results = experiment(
            dataset="random-graphs" if m == "patchy_san" else "sbm",
            model=m, epochs=epochs or 100,
            seed=list(range(seeds or STRAGGLER_QUALITY_SEEDS[m])),
            device=str(device))
        seconds[m] = round(time.perf_counter() - t0, 1)
        (runs,) = results.values()
        per_seed[m] = [r["test_acc"] for r in runs]
        accs[m] = float(np.mean(per_seed[m]))
    print(f"[straggler-quality] test_acc {json.dumps(accs)} (JAX package "
          f"{json.dumps(STRAGGLER_JAX_ACC)}, margin {ZOO_QUALITY_MARGIN}); "
          f"by seed {json.dumps(per_seed)}; seconds {json.dumps(seconds)}")
    short = {m: a for m, a in accs.items()
             if a < STRAGGLER_JAX_ACC[m] - ZOO_QUALITY_MARGIN}
    if short:
        raise AssertionError(f"straggler-quality: test_acc below the JAX "
                             f"package's less {ZOO_QUALITY_MARGIN}: {short}")
    return accs


# ---------------------------------------------------------------------------
# Self-supervised learning (ROADMAP item 13d)
# ---------------------------------------------------------------------------

# (label, model, model and wrapper kwargs): each name through experiment()
# with use_best_config=True on the main path's graph at its BEST_CONFIGS
# width (dgi, graphmae2, bgrl) or default (mvgrl, graphmae,
# unsup_graphsage), and GCN at BEST_CONFIGS under the self-auxiliary
# wrapper with its edge-mask task
SSL_RUNS = (
    ("dgi", "dgi", {"hidden_size": 512}),
    ("mvgrl", "mvgrl", {"hidden_size": 512}),
    ("graphmae", "graphmae", {"hidden_size": 256}),
    ("graphmae2", "graphmae2", {"hidden_size": 256}),
    ("bgrl", "bgrl", {"hidden_size": 256}),
    ("unsup_graphsage", "unsup_graphsage", {"hidden_size": 64}),
    ("self_auxiliary", "gcn", {"hidden_size": 64,
                               "wrapper": "self_auxiliary",
                               "auxiliary_task": "edgemask"}),
)
# GRACE at Pubmed's scale (19,717 nodes) and its BEST_CONFIGS width: its
# four [N, N] fp32 similarity matrices take 1.6 GB each at 20k nodes and
# would take 40 GB each at 100k
SSL_GRACE_NODES = GAT_PARITY_NODES
SSL_GRACE_KW = {"hidden_size": 128}
# InfoGraph at its defaults on graph-main's NCI1-scale set and batches
SSL_INFOGRAPH_KW = {"hidden_size": 32, "num_layers": 3}
SSL_EPOCHS = 5
# card against CPU: the probe's split accuracies (its LBFGS fit on
# embeddings that differ in the last bits)
SSL_PROBE_ACC_TOL = 0.002
# K1 over the main path's graph at the widths this path runs and no
# earlier entry measured there: DGI's and MVGRL's 512 both ways, and the
# backward at GraphMAE's, GraphMAE2's and BGRL's 256
SSL_K1_CASES = (("fw", 512), ("bw", 512), ("bw", 256))
# The quality runs: each name on sbm (InfoGraph on the default
# random-graphs) at its defaults for SSL_QUALITY_EPOCHS epochs over seeds 0
# to SSL_QUALITY_SEEDS - 1: two where every seed of the JAX package's 0-7
# reaches 0.995-1.0 (DGI, MVGRL, GRACE, GraphMAE, GraphMAE2, BGRL), four
# for the self-auxiliary tasks (0.965-1.0), eight for unsupervised
# GraphSAGE (0.745-0.97) and InfoGraph (0.78-0.87, a fold of its 60 graphs
# is 20). Ten epochs: on sbm every name's best validation epoch lies
# within them, and the JAX package's means at 20 differ only for
# unsupervised GraphSAGE (0.88125) and InfoGraph (0.827083). The JAX
# package's own test accuracy at the same settings, the mean over the same
# seeds, on the CPU, each from
#   JAX_PLATFORMS=cpu python -c "from cogdl_tpu import experiment; \
#       experiment(dataset=DATASET, model=MODEL, epochs=10, \
#                  seed=list(range(SEEDS)), **KW)"
# run from the repo root (the self-auxiliary runs: MODEL gcn, KW
# wrapper='self_auxiliary', auxiliary_task=TASK); the card's bar is each
# less ZOO_QUALITY_MARGIN
SSL_QUALITY_EPOCHS = 10
SSL_QUALITY_SEEDS = {"dgi": 2, "mvgrl": 2, "grace": 2, "graphmae": 2,
                     "graphmae2": 2, "bgrl": 2, "unsup_graphsage": 8,
                     "self_auxiliary-edgemask": 4,
                     "self_auxiliary-attributemask": 4,
                     "self_auxiliary-pairwise-distance": 4, "infograph": 8}
SSL_QUALITY_RUNS = {
    "dgi": ("dgi", {}), "mvgrl": ("mvgrl", {}), "grace": ("grace", {}),
    "graphmae": ("graphmae", {}), "graphmae2": ("graphmae2", {}),
    "bgrl": ("bgrl", {}), "unsup_graphsage": ("unsup_graphsage", {}),
    "self_auxiliary-edgemask": ("gcn", {"wrapper": "self_auxiliary",
                                        "auxiliary_task": "edgemask"}),
    "self_auxiliary-attributemask": (
        "gcn", {"wrapper": "self_auxiliary",
                "auxiliary_task": "attributemask"}),
    "self_auxiliary-pairwise-distance": (
        "gcn", {"wrapper": "self_auxiliary",
                "auxiliary_task": "pairwise-distance"}),
    "infograph": ("infograph", {}),
}
SSL_JAX_ACC = {"dgi": 1.0, "mvgrl": 1.0, "grace": 1.0, "graphmae": 1.0,
               "graphmae2": 1.0, "bgrl": 1.0, "unsup_graphsage": 0.875625,
               "self_auxiliary-edgemask": 0.99375,
               "self_auxiliary-attributemask": 0.985,
               "self_auxiliary-pairwise-distance": 0.985,
               "infograph": 0.822917}


def _ssl_expected(model: str, kw, steps: int, evals: int, on_card: bool,
                  feat: int = FEAT_DIM):
    """K1 launches of ``model``'s run at ``kw``, by case, for ``steps``
    train steps and ``evals`` evaluations (InfoGraph: train batches and
    evaluated batches). A propagation runs over the CSR, and over the CSC
    in the backward where its input takes a gradient. DGI: its encoder on
    the features and on the permuted ones, an evaluation once. MVGRL: both
    encoders on both. GRACE: two layers a view. GraphMAE: two encoder
    layers and the decoder at the input width. GraphMAE2: the encoder, the
    teacher's encoder (no backward) and three decodes at the input width.
    BGRL: two layers for each view's student and, without a backward, its
    teacher. GCN under the self-auxiliary wrapper: the supervised forward
    and ``embed``'s first layer again. InfoGraph: each GIN layer's
    neighbour sum, the first at the input width without a gradient.
    Unsupervised GraphSAGE (``mean``): none."""
    if not on_card or model == "unsup_graphsage":
        return {}
    h = kw.get("hidden_size")
    # (width, CSR a step, CSC a step, CSR an evaluation)
    props = {
        "dgi": [(h, 2, 2, 1)],
        "mvgrl": [(h, 4, 4, 2)],
        "grace": [(h, 4, 4, 2)],
        "graphmae": [(h, 2, 2, 2), (feat, 1, 1, 0)],
        "graphmae2": [(h, 4, 2, 2), (feat, 3, 3, 0)],
        "bgrl": [(h, 8, 4, 2)],
        "gcn": [(h, 2, 2, 1), (NUM_CLASSES, 1, 1, 1)],
        "infograph": [(feat, 1, 0, 1)] + [(h, 1, 1, 1)] * (
            kw.get("num_layers", 3) - 1),
    }[model]
    expected = collections.Counter()
    for f, csr, csc, ev in props:
        expected[("csr", f)] += csr * steps + ev * evals
        expected[("csc", f)] += csc * steps
    return {"spmm_csr": +expected}


def _ssl_wrapper(model: str, kw, net):
    """``net`` in the wrapper of run kwargs ``kw`` (the model's default
    unless ``kw`` names one), with the wrapper's own kwargs."""
    wrapper_cls = fetch_wrapper(kw.get("wrapper") or default_wrapper_for(
        model))
    extra = {k: v for k, v in kw.items() if k == "auxiliary_task"}
    return wrapper_cls(net, **extra)


def _ssl_model_kw(kw):
    return {k: v for k, v in kw.items()
            if k not in ("wrapper", "auxiliary_task")}


def _ssl_run(tag: str, label: str, model: str, kw, ds, device, epochs: int,
             expected_args, profile):
    """One run through ``experiment()`` (``use_best_config=True``) for
    ``epochs`` epochs, an evaluation each and one at the end: the exact K1
    launches of :func:`_ssl_expected` at ``expected_args`` ``(steps,
    evaluations, feat)`` and no other counted kernel, a finite loss, the
    times (the final probe's own ``probe_ms``, its LBFGS iterations), the
    peak of allocated card memory, ``profile()`` and the seconds."""
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    sk.reset_launch_counts()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    results = experiment(dataset=ds, model=model, use_best_config=True,
                         epochs=epochs, patience=epochs + 1, eval_step=1,
                         seed=0, device=str(device), **kw)
    (res,) = next(iter(results.values()))
    counts = _launch_counts()
    steps, evals, feat = expected_args
    expected = _ssl_expected(model, _ssl_model_kw(kw), steps, evals, on_card,
                             feat)
    if counts != expected:
        raise AssertionError(f"{tag} {label} ({steps} steps, {evals} "
                             f"evaluations) launched {counts}; expected "
                             f"{expected}")
    if not np.isfinite(res["train_loss"]):
        raise AssertionError(f"{tag} {label}: loss not finite: {res}")
    rec = {"train_step_ms": res["train_step_ms"], "eval_ms": res["eval_ms"],
           "probe_ms": res.get("probe_ms"),
           "probe_iters": res.get("probe_iters"),
           "peak_hbm_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else None),
           "train_loss": res["train_loss"], "test_acc": res["test_acc"],
           "epochs": epochs,
           "launches": {k: {",".join(map(str, c)): v for c, v in d.items()}
                        for k, d in counts.items()},
           "profile": profile()}
    rec["seconds"] = time.perf_counter() - t0
    return rec, counts


def phase_ssl_main(device: torch.device, num_nodes: int = NUM_NODES,
                   epochs: int = SSL_EPOCHS, runs=SSL_RUNS,
                   grace_nodes: int = SSL_GRACE_NODES, graph_set=GRAPH_SET,
                   batch_size: int = GRAPH_BATCH,
                   graph_epochs: int = GRAPH_EPOCHS, iters: int = 20):
    """Each run of :data:`SSL_RUNS` on the main path's graph, GRACE on a
    ``grace_nodes`` graph and InfoGraph on graph-main's set (its SVC over
    every graph's embedding) through :func:`_ssl_run`, with
    ``torch.profiler``'s view of one more step (:func:`_step_profile`;
    InfoGraph's of an epoch), and the profiler's view of one probe fit
    (:func:`_probe_profile`). Last, K1 over the main path's graph at
    :data:`SSL_K1_CASES` measured by :func:`_k1_entry`. Returns each run's
    record, the probe's profile, the launches by case summed over the runs
    and the entries."""
    on_card = device.type == "cuda"
    graphs = {n: main_graph(n) for n in (num_nodes, grace_nodes)}
    info, launches_by = {}, collections.Counter()
    normalised = {n: {} for n in graphs}
    node_runs = tuple(runs) + (("grace", "grace", SSL_GRACE_KW),)
    for label, model, kw in node_runs:
        g = graphs[grace_nodes if model == "grace" else num_nodes]
        ds = Dataset.from_graph(g, name=f"powerlaw-{g.num_nodes}")
        info[label], counts = _ssl_run(
            "ssl-main", label, model, kw, ds, device, epochs,
            (epochs, epochs + 1, FEAT_DIM),
            lambda: _step_profile(
                model, _ssl_model_kw(kw), g, device,
                normalised[g.num_nodes],
                functools.partial(_ssl_wrapper, model, kw)))
        launches_by.update(counts.get("spmm_csr", {}))
    ds = graph_dataset(tuple(sorted(graph_set.items())))
    n_tr, n_va, n_te = _graph_batches(len(ds), batch_size)

    def infograph_profile():
        net = build_model("infograph", in_features=ds.num_features,
                          **SSL_INFOGRAPH_KW)
        net.reset_parameters(torch.Generator().manual_seed(0))
        wrapper = InfoGraphWrapper(net, ds, batch_size=batch_size, seed=0)
        wrapper.to_device(device)
        return _epoch_profile(wrapper, None, device)

    info["infograph"], counts = _ssl_run(
        "ssl-main", "infograph", "infograph",
        dict(SSL_INFOGRAPH_KW, batch_size=batch_size), ds, device,
        graph_epochs, (graph_epochs * n_tr,
                       (graph_epochs + 1) * (n_tr + n_va + n_te),
                       ds.num_features), infograph_profile)
    info["infograph"]["graphs"] = len(ds)
    launches_by.update(counts.get("spmm_csr", {}))
    info["probe_profile"] = _probe_profile(graphs[num_nodes], device)
    print(f"[ssl-main] {json.dumps(info)}")
    kg = kernel_graph(num_nodes, device)
    gen = torch.Generator(device=device).manual_seed(9)
    entries = [_k1_entry(f"spmm_csr[{'csr' if d == 'fw' else 'csc'},F={f}]",
                         kg.extras, d, f, gen, device, iters)
               for d, f in SSL_K1_CASES]
    for e in entries:
        print(f"[ssl-main] {json.dumps(e)}")
    info["launches_by"] = {"spmm_csr": dict(launches_by)}
    info["entries"] = entries
    return info


def _probe_profile(graph, device: torch.device, hidden: int = 512):
    """``torch.profiler``'s view (:func:`profile_window`) of one fit of the
    logistic-regression probe (``utils/probe.py``) on the embeddings of a
    DGI encoder of width ``hidden`` with seeded weights over ``graph``:
    whether the card or the host sets the fit's time. With the fit's
    iterations and its own ``probe_ms`` (under the profiler)."""
    net = build_model("dgi", in_features=graph.x.shape[1],
                      hidden_size=hidden)
    wrapper = _ssl_wrapper("dgi", {}, net)
    prepared = wrapper.prepare_graph(graph.to(device))
    wrapper.init(torch.Generator().manual_seed(0), prepared)
    net.to(device)
    with torch.no_grad():
        emb = net.embed(prepared)
    fit = {}

    def probe():
        fit.update(logreg_probe(emb, prepared))
        _sync(device)

    probe()
    rec = profile_window(probe, device)
    rec.update(probe_iters=fit["probe_iters"], probe_ms=fit["probe_ms"],
               width=hidden)
    return rec


def _ssl_views(model: str, kw, net, g, device: torch.device):
    """On ``device``, a copy of ``net`` over ``g`` in its wrapper: the
    embeddings the probe reads, one step's loss at draws made on the host
    from a seeded generator (the same on every device), and the probe's
    split accuracies."""
    m = copy.deepcopy(net)
    wrapper = _ssl_wrapper(model, kw, m)
    m.to(device)
    prepared = wrapper.prepare_graph(g.to(device))
    batch = wrapper.train_batches(prepared)[0]
    with torch.no_grad():
        emb = m.embed(prepared)
        if model != "unsup_graphsage" and not kw.get("wrapper"):
            draws = wrapper.draws(prepared.to("cpu"),
                                  torch.Generator().manual_seed(2))

            def to(d):
                if isinstance(d, (tuple, list)):
                    return type(d)(to(x) for x in d)
                return d.to(device)

            loss = wrapper.loss_at(prepared, to(draws), False)
        else:
            loss = wrapper.loss(batch, None, training=False)
    probe = wrapper.evaluate(prepared)
    return emb[: g.num_nodes].cpu(), float(loss), probe


def phase_ssl_parity(device: torch.device,
                     num_nodes: int = GAT_PARITY_NODES, runs=SSL_RUNS,
                     graph_set=GRAPH_SET, batch_size: int = GRAPH_BATCH):
    """Each node-level run of :data:`SSL_RUNS` and GRACE on a
    ``num_nodes`` graph, the same seeded weights on the card and on the
    CPU: the embeddings and one step's loss (training off, the same draws)
    within ``LOGIT_ATOL + LOGIT_RTOL·max|·|``, the probe's split
    accuracies within :data:`SSL_PROBE_ACC_TOL`. Then InfoGraph on
    graph-main's set: the graph embeddings within the same bound and the
    SVC's fold accuracies within two graphs of a fold."""
    g = parity_graph(num_nodes)
    out, bad = {}, {}
    for label, model, kw in tuple(runs) + (("grace", "grace",
                                            SSL_GRACE_KW),):
        t0 = time.perf_counter()
        net = build_model(model, in_features=FEAT_DIM,
                          out_features=NUM_CLASSES, **_ssl_model_kw(kw))
        gen0 = torch.Generator().manual_seed(0)
        net.reset_parameters(gen0)
        if kw.get("wrapper") == "self_auxiliary":
            w = _ssl_wrapper(model, kw, net)
            w.init(gen0, w.prepare_graph(g))
        (e_ref, l_ref, p_ref), (e_got, l_got, p_got) = (
            _ssl_views(model, kw, net, g, dev)
            for dev in (torch.device("cpu"), device))
        rec = {"max_abs_diff": float((e_got - e_ref).abs().max()),
               "max_abs_emb": float(e_ref.abs().max()),
               "loss": l_ref, "loss_diff": abs(l_got - l_ref),
               "acc_diff": max(abs(float(p_got[k]) - float(p_ref[k]))
                               for k in p_ref if k.endswith("_acc")),
               "probe_iters": [p_ref.get("probe_iters"),
                               p_got.get("probe_iters")],
               "probe_ms": [p_ref.get("probe_ms"), p_got.get("probe_ms")]}
        rec["seconds"] = time.perf_counter() - t0
        out[label] = rec
        print(f"[ssl-parity] {label} {json.dumps(rec)}")
        if not (rec["max_abs_diff"] <= LOGIT_ATOL + LOGIT_RTOL
                * rec["max_abs_emb"]
                and rec["loss_diff"] <= LOGIT_ATOL + LOGIT_RTOL
                * abs(rec["loss"])
                and rec["acc_diff"] <= SSL_PROBE_ACC_TOL):
            bad[label] = rec
    t0 = time.perf_counter()
    ds = graph_dataset(tuple(sorted(graph_set.items())))
    net = build_model("infograph", in_features=ds.num_features,
                      **SSL_INFOGRAPH_KW)
    net.reset_parameters(torch.Generator().manual_seed(0))
    embs, folds = {}, {}
    for dev in (torch.device("cpu"), device):
        wrapper = InfoGraphWrapper(copy.deepcopy(net).to(dev), ds,
                                   batch_size=batch_size, seed=0)
        wrapper.to_device(dev)
        X, y = wrapper.embeddings()
        embs[dev.type] = X
        folds[dev.type] = cross_val_accuracy(wrapper.standardize(X), y, 3)
    ref, got = embs["cpu"], embs[device.type]
    fold_size = np.bincount(stratified_kfold(y, 3))
    rec = {"max_abs_diff": float(np.abs(got - ref).max()),
           "max_abs_emb": float(np.abs(ref).max()),
           "fold_acc": [folds["cpu"].tolist(), folds[device.type].tolist()],
           "fold_size": fold_size.tolist(),
           "seconds": time.perf_counter() - t0}
    out["infograph"] = rec
    print(f"[ssl-parity] infograph {json.dumps(rec)}")
    if not (rec["max_abs_diff"] <= LOGIT_ATOL + LOGIT_RTOL
            * rec["max_abs_emb"] and np.all(
                np.abs(folds[device.type] - folds["cpu"])
                <= 2.0 / fold_size)):
        bad["infograph"] = rec
    if bad:
        raise AssertionError(f"ssl-parity: {device.type} differs from the "
                             f"CPU beyond its bounds: {bad}")
    return out


def phase_ssl_quality(device: torch.device, runs=tuple(SSL_QUALITY_RUNS),
                      epochs: int = SSL_QUALITY_EPOCHS, seeds=None):
    """Each run of :data:`SSL_QUALITY_RUNS`' mean test accuracy over its
    :data:`SSL_QUALITY_SEEDS` (or ``seeds``) at its defaults for ``epochs``
    epochs, on ``sbm``
    (InfoGraph on the default ``random-graphs``), held to the JAX
    package's own at the same settings less :data:`ZOO_QUALITY_MARGIN`
    (:data:`SSL_JAX_ACC`). The probes use no scikit-learn."""
    accs, per_seed, seconds = {}, {}, {}
    for label in runs:
        model, kw = SSL_QUALITY_RUNS[label]
        t0 = time.perf_counter()
        results = experiment(
            dataset="random-graphs" if model == "infograph" else "sbm",
            model=model, epochs=epochs,
            seed=list(range(seeds or SSL_QUALITY_SEEDS[label])),
            device=str(device), **kw)
        seconds[label] = round(time.perf_counter() - t0, 1)
        (rs,) = results.values()
        per_seed[label] = [r["test_acc"] for r in rs]
        accs[label] = float(np.mean(per_seed[label]))
    print(f"[ssl-quality] test_acc {json.dumps(accs)} (JAX package "
          f"{json.dumps(SSL_JAX_ACC)}, margin {ZOO_QUALITY_MARGIN}); by "
          f"seed {json.dumps(per_seed)}; seconds {json.dumps(seconds)}")
    short = {m: a for m, a in accs.items()
             if a < SSL_JAX_ACC[m] - ZOO_QUALITY_MARGIN}
    if short:
        raise AssertionError(f"ssl-quality: test_acc below the JAX "
                             f"package's less {ZOO_QUALITY_MARGIN}: {short}")
    return accs


def timed(phase, *args, **kw):
    """Run one phase and print how long it took."""
    t0 = time.perf_counter()
    out = phase(*args, **kw)
    print(f"[time] {phase.__name__} {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    args = argparse.ArgumentParser(
        "chip_smoke.py", description="Smoke run of cogdl_tpu_torch on one "
        "NVIDIA card (every phase without arguments).")
    args.add_argument("--gather-only", action="store_true",
                      help="build, then only the gather probes' kernel check "
                      "(K4-K6 against their plain versions, timed), in a "
                      "process that runs nothing before it")
    args = args.parse_args(argv)
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
    smi = timed(phase_device)
    timed(phase_build)
    if args.gather_only:
        entries = timed(phase_gather_kernel_check, device)
        print(f"[done] {time.perf_counter() - t0:.1f} s; gather phase only "
              f"on {smi}")
        print(smi)
        print(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "gather_only": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    entries = timed(phase_kernel_check, device)
    timed(phase_adversarial, device)
    timed(phase_chunk_sweep, device)
    main_info = timed(phase_main_path, device)
    timed(phase_parity, device)
    timed(phase_quality, device)
    entries += timed(phase_gat_kernel_check, device)
    timed(phase_gat_autograd, device)
    gat_info = timed(phase_gat_main_path, device)
    timed(phase_gat_parity, device)
    timed(phase_gat_quality, device)
    launches_by = {"spmm_csr": main_info["launches_by"],
                   "gat_pass": gat_info["launches_by"]}
    for e in entries:
        kernel, *case = e["case"]
        e["launches"] = launches_by[kernel].get(tuple(case), 0)
    # the products-scale slice
    timed(phase_accum_kernel_check, device)
    timed(phase_panel_autograd, device)
    timed(phase_gat_accum_check, device)
    timed(phase_gat_autograd, device, n_panels=CHECK_PANELS)
    timed(phase_panel_parity, device)
    kernel_graph.cache_clear()
    sweep = timed(phase_panel_sweep, device)
    gat_sweep = timed(phase_gat_panel_sweep, device)
    gcn_info, gcn_entries = timed(phase_products, device, "gcn")
    gat_prod_info, gat_entries = timed(phase_products, device, "gat")
    entries += gcn_entries + gat_entries
    tail_report(entries)
    # the gather probes and full-batch GraphSAGE
    gather_entries = timed(phase_gather_kernel_check, device)
    timed(phase_gather_adversarial, device)
    timed(phase_gather_sweep, device)
    gather_info = timed(phase_gather_path, device)
    for e in gather_entries:
        e["launches"] = gather_info["launches"][e.pop("stage")]
    entries += gather_entries
    sage_info = timed(phase_sage_main_path, device)
    timed(phase_sage_parity, device)
    timed(phase_sage_quality, device)
    # sampled mini-batch training
    sampled_info = timed(phase_sampled_main_path, device)
    timed(phase_sampled_check, device)
    sampled_bench = timed(phase_sampled_bench, device)
    # host-sampled mini-batch training
    timed(phase_host_library, device)
    host_info = timed(phase_host_sampled_main_path, device)
    timed(phase_host_sampled_check, device)
    host_bench = timed(phase_host_sampled_bench, device)
    # cluster and GraphSAINT mini-batch training
    cluster_info = timed(phase_cluster_main_path, device)
    saint_info = timed(phase_saint_main_path, device)
    check_info = timed(phase_cluster_saint_check, device)
    for e in check_info["entries"]:
        kernel, *case = e["case"]
        e["launches"] = saint_info["launches_by"].get(kernel, {}).get(
            tuple(case), 0)
    entries += check_info["entries"]
    # the full-batch node-classification zoo
    zoo_entries = timed(phase_zoo_kernel_check, device)
    kernel_graph.cache_clear()
    zoo_info = timed(phase_zoo_main_path, device)
    timed(phase_zoo_parity, device)
    zoo_acc = timed(phase_zoo_quality, device)
    for e in zoo_entries:
        kernel, *case = e["case"]
        e["launches"] = zoo_info["launches_by"].get(kernel, {}).get(
            tuple(case), 0)
    entries += zoo_entries
    # the rest of the zoo
    rest_entries = timed(phase_rest_kernel_check, device)
    kernel_graph.cache_clear()
    rest_info = timed(phase_rest_main_path, device)
    timed(phase_rest_parity, device)
    rest_acc = timed(phase_rest_quality, device)
    for e in rest_entries:
        kernel, *case = e["case"]
        e["launches"] = rest_info["launches_by"].get(kernel, {}).get(
            tuple(case), 0)
    entries += rest_entries
    # DisenGCN and SRGCN, then graph classification
    graph_entries = timed(phase_graph_kernel_check, device)
    kernel_graph.cache_clear()
    graph_info = timed(phase_graph_main_path, device)
    last_info = timed(phase_last_main_path, device)
    timed(phase_graph_parity, device)
    graph_acc = timed(phase_graph_quality, device)
    for e in graph_entries:
        kernel, *case = e["case"]
        e["launches"] = graph_info["launches_by"].get(kernel, {}).get(
            tuple(case), 0)
    entries += graph_entries
    # the heterogeneous family
    hetero_entries = timed(phase_hetero_kernel_check, device)
    hetero_info = timed(phase_hetero_main_path, device)
    timed(phase_hetero_parity, device)
    hetero_acc = timed(phase_hetero_quality, device)
    for e in hetero_entries:
        kernel, *case = e["case"]
        e["launches"] = hetero_info["launches_by"].get(kernel, {}).get(
            tuple(case), 0)
    entries += hetero_entries
    # the node-classification stragglers
    straggler_info = timed(phase_straggler_main, device)
    timed(phase_straggler_parity, device)
    straggler_acc = timed(phase_straggler_quality, device)
    for e in straggler_info["entries"]:
        kernel, *case = e["case"]
        e["launches"] = straggler_info["launches_by"].get(kernel, {}).get(
            tuple(case), 0)
    entries += straggler_info["entries"]
    # self-supervised learning
    kernel_graph.cache_clear()
    ssl_info = timed(phase_ssl_main, device)
    timed(phase_ssl_parity, device)
    ssl_acc = timed(phase_ssl_quality, device)
    for e in ssl_info["entries"]:
        kernel, *case = e["case"]
        e["launches"] = ssl_info["launches_by"].get(kernel, {}).get(
            tuple(case), 0)
    entries += ssl_info["entries"]
    for e in entries:
        kernel, *case = e.pop("case", [None])
        for key, run in (("launches_host_sampled", host_info),
                         ("launches_cluster", cluster_info),
                         ("launches_saint", saint_info),
                         ("launches_zoo", zoo_info),
                         ("launches_rest_zoo", rest_info),
                         ("launches_graph", graph_info),
                         ("launches_hetero", hetero_info),
                         ("launches_stragglers", straggler_info),
                         ("launches_ssl", ssl_info)):
            e[key] = run["launches_by"].get(kernel, {}).get(tuple(case), 0)
    print(f"[done] {time.perf_counter() - t0:.1f} s; GCN main path "
          f"train_step_ms={main_info['train_step_ms']:.3f} "
          f"eval_ms={main_info['eval_ms']:.3f}; GAT main path "
          f"train_step_ms={gat_info['train_step_ms']:.3f} "
          f"eval_ms={gat_info['eval_ms']:.3f}; products GCN step_ms="
          f"{gcn_info['cached_step_ms']:.1f} (no cache "
          f"{gcn_info['uncached_step_ms']:.1f}), GAT step_ms="
          f"{gat_prod_info['step_ms']:.1f} over "
          f"{gcn_info['panels']} and {gat_prod_info['panels']} panels; "
          f"sweep best "
          f"{min(sweep, key=lambda r: r['step_ms_no_cache'])['panels']} "
          f"panels (GAT "
          f"{min(gat_sweep, key=lambda r: r['step_ms'])['panels']}); GraphSAGE main path (mean) train_step_ms="
          f"{sage_info['mean']['train_step_ms']:.3f} "
          f"eval_ms={sage_info['mean']['eval_ms']:.3f}, (sum) "
          f"train_step_ms={sage_info['sum']['train_step_ms']:.3f}; sampled "
          f"train_step_ms "
          + ", ".join(f"{k} {v['train_step_ms']:.3f}"
                      for k, v in sampled_info.items())
          + "; sampled bench step_ms "
          + ", ".join(f"{r['model']}@{r['nodes']} {r['step_ms']:.3f}"
                      for r in sampled_bench)
          + "; host-sampled train_step_ms "
          + ", ".join(f"{k} {v['train_step_ms']:.3f}"
                      for k, v in host_info.items() if k != "launches_by")
          + "; host-sampled bench step_ms "
          + ", ".join(f"sage@{r['nodes']} {r['step_ms']:.3f}"
                      for r in host_bench)
          + "; cluster / GraphSAINT train_step_ms (eval_ms) "
          + ", ".join(f"{tag} {k} {v['train_step_ms']:.3f} "
                      f"({v['eval_ms']:.3f})"
                      for tag, run in (("cluster", cluster_info),
                                       ("saint", saint_info))
                      for k, v in run.items() if k != "launches_by")
          + f"; bfs_partition {check_info['bfs_partition_s']:.2f} s"
          + "; zoo train_step_ms (eval_ms, peak GB) "
          + ", ".join(f"{k} {v['train_step_ms']:.3f} ({v['eval_ms']:.3f}, "
                      f"{v['peak_hbm_bytes'] / 1e9:.2f})"
                      for k, v in zoo_info.items() if k != "launches_by")
          + "; zoo sbm test_acc "
          + ", ".join(f"{k} {v:.4f}" for k, v in zoo_acc.items())
          + "; rest-of-zoo train_step_ms (eval_ms, peak GB) "
          + ", ".join(f"{k} {v['train_step_ms']:.3f} ({v['eval_ms']:.3f}, "
                      f"{v['peak_hbm_bytes'] / 1e9:.2f})"
                      for k, v in rest_info.items() if k != "launches_by")
          + "; rest-of-zoo sbm test_acc "
          + ", ".join(f"{k} {v:.4f}" for k, v in rest_acc.items())
          + "; DisenGCN / SRGCN train_step_ms (eval_ms, peak GB) "
          + ", ".join(f"{k} {v['train_step_ms']:.3f} ({v['eval_ms']:.3f}, "
                      f"{v['peak_hbm_bytes'] / 1e9:.2f})"
                      for k, v in last_info.items() if k != "launches_by")
          + "; graph classification train_step_ms (eval_ms, peak GB) "
          + ", ".join(f"{k} {v['train_step_ms']:.3f} ({v['eval_ms']:.3f}, "
                      f"{v['peak_hbm_bytes'] / 1e9:.2f})"
                      for k, v in graph_info.items() if k != "launches_by")
          + "; graph-quality test_acc "
          + ", ".join(f"{k} {v:.4f}" for k, v in graph_acc.items())
          + "; heterogeneous train_step_ms (eval_ms, peak GB) "
          + ", ".join(f"{k} {v['train_step_ms']:.3f} ({v['eval_ms']:.3f}, "
                      f"{v['peak_hbm_bytes'] / 1e9:.2f})"
                      for k, v in hetero_info.items() if k != "launches_by")
          + "; hetero-quality test_acc "
          + ", ".join(f"{k} {v:.4f}" for k, v in hetero_acc.items())
          + "; stragglers train_step_ms (eval_ms, peak GB) "
          + ", ".join(f"{k} {v['train_step_ms']:.3f} ({v['eval_ms']:.3f}, "
                      f"{v['peak_hbm_bytes'] / 1e9:.2f})"
                      for k, v in straggler_info.items()
                      if k not in ("launches_by", "entries"))
          + "; straggler-quality test_acc "
          + ", ".join(f"{k} {v:.4f}" for k, v in straggler_acc.items())
          + "; self-supervised train_step_ms (eval_ms, probe_ms, peak GB) "
          + ", ".join(f"{k} {v['train_step_ms']:.3f} ({v['eval_ms']:.3f}, "
                      f"{v['probe_ms'] or 0.0:.3f}, "
                      f"{v['peak_hbm_bytes'] / 1e9:.2f})"
                      for k, v in ssl_info.items()
                      if k not in ("launches_by", "entries", "probe_profile"))
          + "; probe fit (profiled) "
          + (f"{ssl_info['probe_profile']['busy_ms']:.1f} ms busy of "
             f"{ssl_info['probe_profile']['window_ms']:.1f}"
             if ssl_info["probe_profile"].get("busy_ms") is not None
             else ssl_info["probe_profile"].get("note", ""))
          + "; ssl-quality test_acc "
          + ", ".join(f"{k} {v:.4f}" for k, v in ssl_acc.items())
          + f" on {smi}")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
