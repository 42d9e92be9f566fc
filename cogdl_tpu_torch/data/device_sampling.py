"""On-device neighbor sampling — the port of
``cogdl_tpu/data/device_sampling.py``: fanout sampling over the CSR that
stays on the device, so a mini-batch costs the host one ``[B]`` seed row.

The design is the JAX package's:

* **No frontier dedup.** Frontiers grow as exact concatenations
  ``cur_{k+1} = [cur_k, src_k]``, so every size is known from ``B`` and the
  fanouts alone (``plan_sizes``) and no step waits for the device to learn
  a size.
* **Sampling with replacement**: one ``uniform [n, fanout]`` draw per hop.
  A destination with no edge expands around itself; its slots point at
  the frame's sink row with weight 0.
* **Blocks come outermost-first**: ``blocks[i]`` is read by layer ``i``,
  and ``fanouts[k]`` is the fanout of expansion hop ``k`` (seeds outward).
* **The block structure is fixed** by ``(B, fanouts)``: every destination
  owns exactly ``fanout`` dst-major slots, so ``row`` / ``row_ptr`` are
  ramps, built once per ``(B, fanouts, device)`` and cached (there is no
  jit to fold them); only the frame, the slots' liveness and the gathers
  depend on the draws.

Draws come from an explicit ``torch.Generator`` on the graph's device. The
arithmetic of one hop from its draws (``hop_sources``) is the JAX
package's, bit for bit; ``jax.random`` and ``torch`` give other draws.
Nothing here reads a device value on the host.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .graph import Graph, _bucket

__all__ = ["plan_sizes", "hop_sources", "sample_blocks_device",
           "sample_blocks_from_draws", "frame_features",
           "DeviceNeighborSampler"]


def plan_sizes(batch_size: int, fanouts: Sequence[int]) -> List[int]:
    """Exact frontier size after each expansion hop (no dedup):
    ``sizes[k+1] = sizes[k] * (fanouts[k] + 1)``."""
    sizes = [int(batch_size)]
    for f in fanouts:
        sizes.append(sizes[-1] * (int(f) + 1))
    return sizes


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along the first axis with indices clamped into range,
    as ``jnp.take(..., mode="clip")`` reads (``index_select`` raises
    instead)."""
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))


def hop_sources(row_ptr: torch.Tensor, col: torch.Tensor, cur: torch.Tensor,
                u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One expansion hop from its draws: ``cur`` ``int32[n]`` destination
    ids, ``u`` ``float32[n, f]`` uniforms in ``[0, 1)``. Slot ``j`` of
    destination ``i`` takes edge ``ptr + min(trunc(u·deg), max(deg − 1,
    0))`` of its CSR row (``pos`` capped at the last edge); a destination
    with no edge takes itself. Returns ``(src int32[n, f], alive bool[n])``
    (reference ``cogdl_tpu/data/device_sampling.py:92-103``)."""
    ptr = _take(row_ptr, cur)
    deg = _take(row_ptr, cur + 1) - ptr
    off = torch.minimum((u * deg[:, None].float()).to(torch.int32),
                        (deg[:, None] - 1).clamp_min(0))
    pos = torch.clamp_max(ptr[:, None] + off, col.shape[0] - 1)
    src = _take(col, pos.reshape(-1)).reshape(u.shape)
    alive = deg > 0
    return torch.where(alive[:, None], src, cur[:, None]), alive


@functools.lru_cache(maxsize=16)
def _block_structure(batch_size: int, fanouts: Tuple[int, ...],
                     device: torch.device):
    """The draw-independent part of every block, outermost-first: ``(n, f,
    e_real, row, row_ptr, base_cols)`` on ``device``. Rows past the frontier
    and pad edges sit in the sink row ``n_pad − 1`` (the ``from_coo``
    contract). Cached: the tensors are shared by every batch and never
    written."""
    sizes = plan_sizes(batch_size, fanouts)
    n_pad = _bucket(sizes[-1] + 1)
    sink = n_pad - 1
    out = []
    for k in reversed(range(len(fanouts))):
        f, n = fanouts[k], sizes[k]
        e_real = n * f
        e_pad = _bucket(e_real)
        rows = np.full(e_pad, sink, np.int32)
        rows[:e_real] = np.repeat(np.arange(n, dtype=np.int32), f)
        rp = (np.minimum(np.arange(n_pad + 1, dtype=np.int64), n) * f
              ).astype(np.int32)
        rp[-1] = e_pad
        base_cols = n + np.arange(e_real, dtype=np.int32)
        out.append((n, f, e_real, torch.from_numpy(rows).to(device),
                    torch.from_numpy(rp).to(device),
                    torch.from_numpy(base_cols).to(device)))
    return n_pad, tuple(out)


def sample_blocks_from_draws(graph: Graph, seeds: torch.Tensor,
                             draws: Sequence[torch.Tensor]
                             ) -> Tuple[Tuple[Graph, ...], torch.Tensor]:
    """Multi-hop fanout sampling from given draws: ``draws[k]`` is hop
    ``k``'s ``float32[sizes[k], fanouts[k]]`` uniforms. Returns ``(blocks,
    frame)``: ``blocks`` are bipartite Graphs over one node frame,
    outermost-first, one per layer; ``frame`` is the ``int32[n_pad]`` global
    ids whose first ``len(seeds)`` rows are the seeds, padded with the
    feature table's sink row ``graph.n_pad − 1``. ``blocks[0].extras``
    holds ``frame``, the table ``x_table`` and the seed rows' ``seed_y`` and
    ``seed_train_mask``; each block's ``meta`` carries ``fanout``,
    ``frontier`` and the graph's ``num_classes``."""
    fanouts = tuple(int(u.shape[1]) for u in draws)
    B = int(seeds.shape[0])
    n_pad, structure = _block_structure(B, fanouts, graph.device)
    S = plan_sizes(B, fanouts)[-1]
    sink = n_pad - 1
    cur = seeds.to(torch.int32)
    alive_per_hop = []
    for u in draws:
        src, alive = hop_sources(graph.row_ptr, graph.col, cur, u)
        alive_per_hop.append(alive)
        cur = torch.cat([cur, src.reshape(-1)])
    frame = torch.cat([cur, cur.new_full((n_pad - S,), graph.n_pad - 1)])

    # labels and mask only for the seed rows: the loss reads no deeper row
    seed_ids = frame[:B]
    seed_y = None if graph.y is None else _take(graph.y, seed_ids)
    seed_tm = (None if graph.train_mask is None
               else _take(graph.train_mask, seed_ids))

    blocks = []
    for (n, f, e_real, rows, rp, base_cols), alive in zip(
            structure, reversed(alive_per_hop)):
        alive_e = alive[:, None].expand(n, f).reshape(-1)
        pad = rows.shape[0] - e_real
        cols = torch.cat([torch.where(alive_e, base_cols,
                                      base_cols.new_full((), sink)),
                          base_cols.new_full((pad,), sink)])
        w = torch.cat([alive_e.float(),
                       alive_e.new_zeros(pad, dtype=torch.float32)])
        meta = {"fanout": f, "frontier": n}
        if graph.num_classes is not None:
            meta["num_classes"] = graph.num_classes
        blocks.append(Graph(row_ptr=rp, row=rows, col=cols, edge_weight=w,
                            num_nodes=S, num_edges=e_real,
                            meta=tuple(sorted(meta.items()))))
    blocks[0] = blocks[0].replace(extras={
        "frame": frame, "x_table": graph.x, "seed_y": seed_y,
        "seed_train_mask": seed_tm})
    return tuple(blocks), frame


def sample_blocks_device(graph: Graph, seeds: torch.Tensor,
                         generator: Optional[torch.Generator],
                         fanouts: Sequence[int]
                         ) -> Tuple[Tuple[Graph, ...], torch.Tensor]:
    """Multi-hop fanout sampling over the graph's resident CSR
    (``graph.row_ptr`` / ``graph.col``, destination-major): each hop's
    uniforms drawn from ``generator`` on the graph's device, then
    :func:`sample_blocks_from_draws`."""
    sizes = plan_sizes(int(seeds.shape[0]), fanouts)
    draws = [torch.rand((sizes[k], int(f)), generator=generator,
                        device=graph.device)
             for k, f in enumerate(fanouts)]
    return sample_blocks_from_draws(graph, seeds, draws)


def frame_features(blocks: Sequence[Graph]) -> torch.Tensor:
    """The frame's feature rows ``x_table[frame]`` (indices clamped)."""
    ex = blocks[0].extras
    return _take(ex["x_table"], ex["frame"])


class DeviceNeighborSampler:
    """The device sampler's seed rows, epoch by epoch: shuffles the train
    ids on the host (numpy, as the JAX package does, so both give the same
    seed rows) and yields ``[B]`` seed rows; the rest happens on the device.
    The JAX sampler's ``node_idx`` (seeds other than the train ids) has no
    caller and is not ported."""

    def __init__(self, graph: Graph, fanouts: Sequence[int],
                 batch_size: int = 512, seed: int = 0):
        self.graph = graph
        self.fanouts = tuple(int(f) for f in fanouts)
        self.batch_size = int(batch_size)
        self.rng = np.random.default_rng(seed)
        # the train ids, read off the device once
        self.node_idx = np.nonzero(
            graph.train_mask[: graph.num_nodes].cpu().numpy())[0].astype(
                np.int32)
        if self.node_idx.size == 0:
            raise ValueError(
                "DeviceNeighborSampler: no seed nodes (empty train mask)")

    def __len__(self):
        return (len(self.node_idx) + self.batch_size - 1) // self.batch_size

    def epoch_seeds(self, shuffle: bool = True) -> np.ndarray:
        """``[n_batches, B]`` int32 seed matrix (wrap-padded last batch)."""
        idx = self.node_idx.copy()
        if shuffle:
            self.rng.shuffle(idx)
        B = self.batch_size
        out = np.empty((len(self), B), np.int32)
        for i in range(len(self)):
            chunk = idx[i * B: (i + 1) * B]
            if chunk.shape[0] < B:
                # tile-pad: works even when B > len(idx) (tiny train splits)
                chunk = np.concatenate(
                    [chunk, np.resize(idx, B - chunk.shape[0])])
            out[i] = chunk
        return out
