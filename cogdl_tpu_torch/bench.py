"""Benchmark: train-step throughput on a power-law graph — the port of the
full-batch part of the JAX package's ``bench.py`` and of its on-device
sampled route (``bench_sampled_device``).

    python -m cogdl_tpu_torch.bench [--model gcn|gat] [--products] [--device cpu]
    python -m cogdl_tpu_torch.bench --sampled [--model sage|gat] [--products]
        [--batch-size 1024] [--fanouts 15,10] [--device cpu]
    python -m cogdl_tpu_torch.bench --sampled --host-sampler [--products]
        [--batch-size 1024] [--fanouts 15,10] [--device cpu]

Measures the whole train step (forward, backward, Adam) on one NVIDIA card
(``--device cpu`` runs the kernels' plain versions, for rehearsal only) and
prints one JSON line: ``{"metric": ..., "value": ..., "unit": "edges/sec",
"step_ms": ..., ...}``. Steps run in a plain loop; the device is
synchronised before each clock read; the fastest of ``--repeats`` counts.

``--products`` is the ogbn-products-scale configuration (2.45 M nodes,
average degree 50, about 125 M edges with self loops). It and ``--blocked``
generate the graph on the device (``powerlaw_graph_device``), build the
kernels' source-panel structure there (``prepare_spmm_device``, one
structure for both directions since the graph is undirected) and free the
raw edge arrays; the aggregation then runs K2 (GCN) or K3's accumulating
form (GAT) once per panel. Without them the graph comes from the host
generator and takes the single-shot kernels K1 and K3.

``--sampled`` is mini-batch neighbor-sampled training with the device
sampler (``data/device_sampling.py``): the graph's CSR and features stay on
the device and a step costs the host one ``[B]`` seed row; sampling, the
frame's feature gather and the train step (GraphSAGE, or GAT over 8 heads
at attention dropout 0, over the sampled blocks; Adam 1e-2) run there. The
graph is ``powerlaw_graph(..., device_features=True)`` with self loops, or
under ``--products`` ``powerlaw_graph_device``. ``value`` counts edge slots
a second, ``Σ_k sizes[k]·fanouts[k]`` a step (``plan_sizes``), beside
``step_ms`` and ``seeds_per_sec``. No sampled step runs a hand-written
kernel.

``--sampled --host-sampler`` is the JAX script's host pipeline
(``bench_sampled``): the ``neighbor_sampling`` wrapper's C++ sampler on the
host, in a prefetch worker that copies each batch to the card, feeding
GraphSAGE (mean, as the JAX script; ``--model gat`` raises) at dropout 0,
Adam 1e-2, over the same graph as the device route with the features kept
on the device (``device_features``). After ``--warmup`` steps it times up
to ``--steps`` further steps of the same epoch's iterator (one iterator, as
the JAX script; fewer when the epoch ends first, ``timed_steps``).
``value`` counts padded block edges, ``Σ e_pad`` a step. The line adds the
worker's own time a batch (medians): sampling (``host_sample_ms``) and the
blocks' kernel structure (``host_structure_ms``, null for GraphSAGE-mean,
which reads none).

Not ported from the JAX script: ``--bf16``, ``--act-compress``, ``--remat``,
``--reorder*``, and the flags that only switch TPU layouts. The result line
leaves out ``vs_baseline`` and ``vs_gather_floor``, which compare with
rates of other hardware.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .data.device_sampling import DeviceNeighborSampler, plan_sizes
from .data.graph import Graph, add_self_loops, sym_norm
from .datasets.synthetic import powerlaw_graph, powerlaw_graph_device
from .models import build_model
from .ops import cache_propagation
from .ops.cuda import prepare_spmm, prepare_spmm_device
from .trainer.trainer import resolve_device
from .utils.evaluator import masked_cross_entropy
from .wrappers.sampled_node_classification import (
    DeviceSampledNodeClfWrapper,
    SampledNodeClfWrapper,
)

PRODUCTS_NODES, PRODUCTS_AVG_DEGREE = 2_450_000, 50


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("cogdl_tpu_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--model", default="gcn", choices=("gcn", "gat", "sage"),
                    help="gcn | gat full batch; sage | gat under --sampled "
                    "(where gcn means sage, as in the JAX script)")
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--avg-degree", type=int, default=30)
    ap.add_argument("--feat-dim", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=2,
                    help="report the fastest of N timed repeats")
    ap.add_argument("--attn-drop", type=float, default=0.0,
                    help="GAT attention dropout (runs the in-kernel hash)")
    ap.add_argument("--products", action="store_true",
                    help="ogbn-products scale: 2.45M nodes, average degree "
                    "50; implies the device-built panel structure")
    ap.add_argument("--blocked", action="store_true",
                    help="the device-built source-panel structure (the "
                    "--products path) at any scale")
    ap.add_argument("--panel-rows", type=int, default=None,
                    help="source-panel height for --products/--blocked "
                    "(default: two panels, for GCN and GAT alike; 0: no "
                    "panels)")
    ap.add_argument("--no-prop-cache", action="store_true",
                    help="GCN: do not cache the first layer's propagation")
    ap.add_argument("--sampled", action="store_true",
                    help="mini-batch neighbor-sampled training with the "
                    "on-device sampler")
    ap.add_argument("--host-sampler", action="store_true",
                    help="--sampled with the host sampler and prefetch "
                    "pipeline (GraphSAGE only)")
    ap.add_argument("--batch-size", type=int, default=1024,
                    help="--sampled: seed nodes a step")
    ap.add_argument("--fanouts", default="15,10",
                    help="--sampled: fanout of each hop, seeds outward")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result line to this file")
    return ap


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = get_parser()
    args = ap.parse_args(argv)
    if args.products:
        args.nodes, args.avg_degree = PRODUCTS_NODES, PRODUCTS_AVG_DEGREE
    if args.sampled and args.model == "gcn":
        args.model = "sage"
    elif not args.sampled and args.model == "sage":
        ap.error("--model sage runs only under --sampled")
    return args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_graph(args: argparse.Namespace, device: torch.device) -> Graph:
    """The benchmark graph on ``device`` with the kernels' structure: under
    ``--products``/``--blocked`` generated and prepared on the device, the
    raw edge arrays freed afterwards (the kernel routes read only the
    structure); else the host generator's graph with self loops and the
    symmetric normalisation, prepared by ``prepare_spmm``."""
    if not (args.products or args.blocked):
        g = powerlaw_graph(args.nodes, avg_degree=args.avg_degree,
                           feat_dim=args.feat_dim)
        return prepare_spmm(sym_norm(add_self_loops(g)).to(device))
    g = powerlaw_graph_device(args.nodes, avg_degree=args.avg_degree,
                              feat_dim=args.feat_dim, device=device)
    g = prepare_spmm_device(g, symmetric=True, with_orig=args.model == "gat",
                            panel_rows=args.panel_rows)
    z = torch.zeros(1, dtype=torch.int32, device=device)
    # frees the edge arrays; the structure, passed as it is, keeps its weights
    return g.replace(row=z, col=z, edge_weight=torch.zeros(1, device=device),
                     extras=g.extras)


def make_model(args: argparse.Namespace, graph: Graph, device: torch.device
               ) -> Tuple[torch.nn.Module, torch.optim.Optimizer]:
    """The benchmark model (dropout 0; GAT 8 heads of ``hidden // 8``) with
    weights from seed 0, and Adam at 1e-2."""
    kw = dict(in_features=args.feat_dim, out_features=graph.num_classes,
              hidden_size=args.hidden, dropout=0.0)
    if args.model == "gat":
        kw.update(nhead=8, hidden_size=args.hidden // 8,
                  attn_drop=args.attn_drop)
    model = build_model(args.model, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    return model, torch.optim.Adam(model.parameters(), lr=1e-2)


def train_steps(model, optimizer, graph: Graph, steps: int,
                generator: torch.Generator) -> List[float]:
    """``steps`` train steps (forward, masked cross-entropy on the train
    nodes, backward, Adam); returns each step's loss, read after one
    synchronisation at the end."""
    mask = graph.train_mask & graph.node_mask()
    losses = []
    for _ in range(steps):
        optimizer.zero_grad(set_to_none=True)
        logits = model(graph, graph.x, training=True, generator=generator)
        loss = masked_cross_entropy(logits, graph.y, mask)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    _sync(graph.device)
    return [float(x) for x in losses]


def time_steps(model, optimizer, graph: Graph, args: argparse.Namespace,
               generator: torch.Generator) -> float:
    """Seconds per step: ``--warmup`` steps, then the fastest of
    ``--repeats`` timed runs of ``--steps`` steps."""
    train_steps(model, optimizer, graph, args.warmup, generator)
    best = float("inf")
    for _ in range(max(args.repeats, 1)):
        t0 = time.perf_counter()
        train_steps(model, optimizer, graph, args.steps, generator)
        best = min(best, time.perf_counter() - t0)
    return best / args.steps


def make_sampled_graph(args: argparse.Namespace,
                       device: torch.device) -> Graph:
    """The sampled benchmark's graph on ``device``: under ``--products``
    generated there by ``powerlaw_graph_device``, else the host generator's
    edges with features, labels and masks drawn on the device, plus self
    loops. The sampler reads its ``row_ptr``/``col`` and the resident
    ``x``, ``y`` and ``train_mask``."""
    if args.products:
        return powerlaw_graph_device(args.nodes, avg_degree=args.avg_degree,
                                     feat_dim=args.feat_dim, device=device)
    return add_self_loops(powerlaw_graph(
        args.nodes, avg_degree=args.avg_degree, feat_dim=args.feat_dim,
        device_features=True, device=device))


def fanouts_of(args: argparse.Namespace) -> Tuple[int, ...]:
    return tuple(int(f) for f in args.fanouts.split(","))


def sampled_state(args: argparse.Namespace, graph: Graph,
                  device: torch.device):
    """``(wrapper, optimizer, batches)``: the model of ``make_model`` in
    the device-sampled wrapper whose loss a step takes, and one batch per
    shuffled seed row of enough epochs for ``--warmup`` + ``--steps``
    steps, the rows ``int32[B]`` on the device."""
    fanouts = fanouts_of(args)
    model, optimizer = make_model(args, graph, device)
    wrapper = DeviceSampledNodeClfWrapper(model, fanouts=fanouts,
                                          batch_size=args.batch_size)
    sampler = DeviceNeighborSampler(graph, fanouts,
                                    batch_size=args.batch_size)
    rows = [sampler.epoch_seeds()]
    while sum(r.shape[0] for r in rows) < args.warmup + args.steps:
        rows.append(sampler.epoch_seeds())   # span epochs if the split is small
    seed_rows = torch.from_numpy(np.concatenate(rows)).to(device)
    return wrapper, optimizer, [wrapper.make_batch(graph, s)
                                for s in seed_rows]


def sampled_steps(wrapper, optimizer, batches,
                  generator: torch.Generator) -> List[float]:
    """One train step per batch of ``batches``, the wrapper's own (a seed
    row's for the device sampler, a block tuple for the host sampler):
    the wrapper's loss (the device sampler samples inside it), backward,
    Adam; returns each step's loss, read after one synchronisation at the
    end."""
    losses = []
    for batch in batches:
        optimizer.zero_grad(set_to_none=True)
        loss = wrapper.loss(batch, generator)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    if losses:
        _sync(losses[0].device)
    return [float(x) for x in losses]


def run_sampled(args: argparse.Namespace, graph: Optional[Graph] = None
                ) -> Dict[str, Any]:
    """``--sampled``: build the graph (unless given one on the device) and
    the model, run ``--warmup`` steps, then the fastest of ``--repeats``
    timed loops over the same ``--steps`` seed rows, synced at the end;
    returns the result line's payload."""
    if args.host_sampler:
        return run_host_sampled(args, graph)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if graph is None:
        graph = make_sampled_graph(args, device)
    wrapper, optimizer, batches = sampled_state(args, graph, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    generator = torch.Generator(device=device).manual_seed(1)
    sampled_steps(wrapper, optimizer, batches[: args.warmup], generator)
    timed = batches[args.warmup: args.warmup + args.steps]
    dt = float("inf")
    for _ in range(max(args.repeats, 1)):
        t0 = time.perf_counter()
        losses = sampled_steps(wrapper, optimizer, timed, generator)
        dt = min(dt, time.perf_counter() - t0)
    B, fanouts = args.batch_size, fanouts_of(args)
    sizes = plan_sizes(B, fanouts)
    slots = sum(sizes[k] * f for k, f in enumerate(fanouts))
    payload = {
        "metric": f"{args.model.upper()} sampled-train edge-slots/sec (1 "
                  f"device, on-device sampler, powerlaw {args.nodes}n "
                  f"x{args.avg_degree}, fanouts {args.fanouts}, B={B})",
        "value": round(slots * args.steps / dt),
        "unit": "edges/sec",
        "step_ms": 1000 * dt / args.steps,
        "seeds_per_sec": round(B * args.steps / dt),
        "edge_slots_per_step": slots,
        "loss": losses[-1],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "setup_s": setup_s,
    }
    if device.type == "cuda":
        payload["peak_hbm_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return payload


def host_sampled_state(args: argparse.Namespace, graph: Graph,
                       device: torch.device):
    """``(wrapper, optimizer)``: the model of ``make_model`` in the
    ``neighbor_sampling`` wrapper over ``graph`` (features on the device),
    its sampler built and the shape-defining batch drawn, as the JAX
    script's ``wrapper.init``."""
    model, optimizer = make_model(args, graph, device)
    wrapper = SampledNodeClfWrapper(model, fanouts=fanouts_of(args),
                                    batch_size=args.batch_size,
                                    device_features=True)
    wrapper.build_sampler(graph)
    wrapper.draw_init_batch()
    return wrapper, optimizer


def _median(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return float(np.median(values)) if values else None


def run_host_sampled(args: argparse.Namespace, graph: Optional[Graph] = None
                     ) -> Dict[str, Any]:
    """``--sampled --host-sampler``: build the graph (unless given one on
    the device), the wrapper and its sampler, then one epoch's iterator:
    ``--warmup`` steps, then up to ``--steps`` timed steps, synced at the
    end; returns the result line's payload."""
    if args.model != "sage":
        raise ValueError(
            "bench --host-sampler runs GraphSAGE (mean) only, as the JAX "
            f"script's host-sampled bench does; got --model {args.model}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if graph is None:
        graph = make_sampled_graph(args, device)
    wrapper, optimizer = host_sampled_state(args, graph, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    generator = torch.Generator(device=device).manual_seed(1)
    it = iter(wrapper.train_batches(graph))
    try:
        first = next(it)
        edge_slots = sum(b.e_pad for b in first)
        warm = sampled_steps(wrapper, optimizer, itertools.islice(
            itertools.chain([first], it), args.warmup), generator)
        if len(warm) < args.warmup:
            raise SystemExit("--host-sampler: the epoch is shorter than "
                             "--warmup; lower --batch-size or --warmup")
        t0 = time.perf_counter()
        losses = sampled_steps(wrapper, optimizer,
                               itertools.islice(it, args.steps), generator)
        dt = time.perf_counter() - t0
    finally:
        it.close()
    n = len(losses)
    if n == 0:
        raise SystemExit("--host-sampler: no timed steps left in the epoch; "
                         "lower --batch-size/--warmup or raise --nodes")
    sample_ms, structure_ms = zip(*wrapper.host_ms)
    B = args.batch_size
    payload = {
        "metric": f"SAGE sampled-train edge-slots/sec (1 device, host "
                  f"sampler, powerlaw {args.nodes}n x{args.avg_degree}, "
                  f"fanouts {args.fanouts}, B={B})",
        "value": round(edge_slots * n / dt),
        "unit": "edges/sec",
        "step_ms": 1000 * dt / n,
        "seeds_per_sec": round(B * n / dt),
        "edge_slots_per_step": edge_slots,
        "timed_steps": n,
        "loss": losses[-1],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "setup_s": setup_s,
        "host_threads": wrapper._sampler.num_threads,
        "host_sample_ms": _median(sample_ms),
        "host_structure_ms": _median(structure_ms),
    }
    if device.type == "cuda":
        payload["peak_hbm_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return payload


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Build the graph and model and measure; returns the result line's
    payload."""
    if args.sampled:
        return run_sampled(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    graph = make_graph(args, device)
    graph_uncached = None
    if args.model == "gcn" and not args.no_prop_cache:
        # exact first-layer folding (dropout is 0 here): P = ÂX and s = Â1
        # do not change between steps, so layer 1 needs no SpMM
        graph_uncached, graph = graph, cache_propagation(graph)
    _sync(device)
    setup_s = time.perf_counter() - t0
    model, optimizer = make_model(args, graph, device)
    generator = torch.Generator(device=device).manual_seed(0)
    dt = time_steps(model, optimizer, graph, args, generator)
    payload = {
        "metric": f"{args.model.upper()} train-step edges/sec (1 device, "
                  f"powerlaw {args.nodes}n x{args.avg_degree}, "
                  f"F={args.feat_dim})",
        "value": round(graph.num_edges / dt),
        "unit": "edges/sec",
        "step_ms": round(1000 * dt, 2),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "blocked_layout": bool(args.products or args.blocked),
        "prop_cache": graph_uncached is not None,
        "panel_rows": int(graph.meta_get("spmm_panel_rows", 0)),
        "setup_s": round(setup_s, 2),
    }
    if graph_uncached is not None:
        # the cache holds only with zero input dropout: also report the
        # step of the same weights on the uncached graph
        dt2 = time_steps(model, optimizer, graph_uncached, args, generator)
        payload["step_ms_no_cache"] = round(1000 * dt2, 2)
        payload["edges_per_sec_no_cache"] = round(graph.num_edges / dt2)
    if device.type == "cuda":
        payload["peak_hbm_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return payload


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Entry point for ``python -m cogdl_tpu_torch.bench``."""
    args = parse_args(argv)
    payload = run(args)
    line = json.dumps(payload)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return payload


if __name__ == "__main__":
    main()
