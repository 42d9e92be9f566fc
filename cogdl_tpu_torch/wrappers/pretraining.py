"""GCC pretraining — the port of ``cogdl_tpu/wrappers/pretraining.py``
(reference gcc_dw.py, gcc_mw.py, memory_moco.py): MoCo contrastive
training of GCC's encoder over pairs of random-walk-with-restart
subgraphs, and a frozen logistic-regression probe.

Each train step is one union graph of ``2·batch_size`` subgraphs, the
query views then the key views of ``batch_size`` seed nodes, sampled on
the host: the walks with restart by the port's C++ library
(``native.random_walk``, ``num_threads`` threads), each subgraph by
``native.induced_subgraph`` with the seed as local node 0, its features
the top eigenvectors of its normalised adjacency (``np.linalg.eigh``: at
most 32 × 32, and the eigenvectors' signs are the JAX package's), a seed
flag and the normalised degree; the union gets K1's structure on the host
(``prepare_spmm``), as graph classification's batches do, and is copied
to the device. A new set of pairs each epoch, drawn from
``default_rng(seed + 1000·epoch)``.

MoCo runs inside the loss, as the self-supervised teachers do: the key
encoder's weights and the queue of negatives are model buffers
(``model.moco``), which the trainer's snapshots carry and no optimizer
sees. The key encoder runs in eval mode on the query encoder's running
batch statistics, as they are before the step's query forward (the JAX
wrapper hands the key parameters the query's ``batch_stats``); the keys go
into the ring queue at ``ptr``, and the key weights move toward the
query's **pre-step** weights, ``k ← m·k + (1 − m)·q``.

The probe embeds ``probe_nodes`` nodes drawn by ``default_rng(seed)``
(all of them on a smaller graph), in unions of ``2·batch_size``, and fits
``logreg_probe`` on the split restricted to them. A graph with labels
but no split raises a ``ValueError`` naming the missing masks (the JAX
wrapper fails inside numpy there)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .. import native
from ..data.graph import Graph, from_coo
from ..data.sampling import graph_csr
from ..models import build_model
from ..ops.cuda import prepare_spmm
from ..utils.probe import logreg_probe
from .sampled_node_classification import reads_kernel_structure


def _eigen_pe(row: np.ndarray, col: np.ndarray, n: int, k: int,
              size: int) -> np.ndarray:
    """The top ``min(k, max(n − 2, 1), size)`` eigenvectors of the
    symmetrised, normalised adjacency ``D^-½ A D^-½`` (float64 ``eigh``),
    rows L2-normalised, zero-padded to ``[n, size]`` float32 (reference
    gcc_dw.py:196-217)."""
    k = min(k, max(n - 2, 1), size)
    a = np.zeros((n, n), np.float64)
    a[row, col] = 1.0
    a[col, row] = 1.0
    deg = a.sum(1)
    inv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    _, vecs = np.linalg.eigh(a * inv[:, None] * inv[None, :])
    u = vecs[:, -k:]
    u = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
    out = np.zeros((n, size), np.float32)
    out[:, :u.shape[1]] = u
    return out


class MoCoState(nn.Module):
    """The MoCo state as buffers: ``key``, the key encoder's weights (a
    copy of each parameter of ``model``, at the parameter's name under
    ``key``), ``queue [K, D]`` and ``ptr``."""

    def __init__(self, model: nn.Module, queue: torch.Tensor):
        super().__init__()
        self.key = nn.Module()
        for name, p in model.named_parameters():
            *path, leaf = name.split(".")
            mod = self.key
            for part in path:
                if part not in mod._modules:
                    mod.add_module(part, nn.Module())
                mod = mod._modules[part]
            mod.register_buffer(leaf, p.detach().clone())
        self.register_buffer("queue", queue)
        self.register_buffer("ptr", torch.zeros((), dtype=torch.int64))


class GCCWrapper:
    eval_metric = "val_acc"
    eval_mode = "max"
    refresh_per_epoch = True        # new subgraph pairs every epoch

    def __init__(self, model, dataset=None, batch_size: int = 32,
                 rw_hops: int = 64, subgraph_size: int = 32,
                 restart_prob: float = 0.8,
                 positional_embedding_size: int = 16,
                 queue_size: int = 512, momentum: float = 0.999,
                 temperature: float = 0.07, batches_per_epoch: int = 4,
                 probe_nodes: int = 512, seed: int = 0,
                 num_threads: Optional[int] = None):
        self.batch_size = batch_size
        self.rw_hops = rw_hops
        self.subgraph_size = subgraph_size
        self.restart_prob = restart_prob
        self.pe_size = positional_embedding_size
        self.queue_size = (max(queue_size, batch_size)
                           // batch_size) * batch_size
        self.momentum = momentum
        self.temperature = temperature
        self.batches_per_epoch = batches_per_epoch
        self.probe_nodes = probe_nodes
        self.seed = seed
        self.num_threads = num_threads
        self._epoch = 0
        in_feats = positional_embedding_size + 2   # pe | seed flag | degree
        if getattr(model, "in_features", in_feats) != in_feats:
            # the encoder reads the subgraphs' features, not the graph's
            model = build_model(model.registry_name, **dict(
                model.build_kwargs, in_features=in_feats))
        self.model = model
        self.out_dim = getattr(model, "out_features", 64)

    # -- sampling -------------------------------------------------------
    def prepare_graph(self, graph: Graph) -> Graph:
        self._graph = graph
        # int64 and contiguous once, as the library takes them: a
        # conversion a call would copy every edge for each subgraph
        self._csr = tuple(np.ascontiguousarray(a, np.int64)
                          for a in graph_csr(graph)[:2])
        return graph

    def _rwr_nodes(self, seeds: np.ndarray, seed: int) -> List[np.ndarray]:
        """One node set a seed: its walk with restart of ``rw_hops`` steps,
        the seed first, then the other nodes visited, ascending, to at most
        ``subgraph_size`` in all."""
        threads = (native.max_threads() if self.num_threads is None
                   else self.num_threads)
        traces = native.random_walk(self._csr[0], self._csr[1], seeds,
                                    self.rw_hops, seed=seed,
                                    num_threads=threads,
                                    restart_prob=self.restart_prob)
        out = []
        for s, tr in zip(seeds, traces):
            uniq = np.unique(tr)
            uniq = uniq[uniq != s][: self.subgraph_size - 1]
            out.append(np.concatenate([[s], uniq]))
        return out

    def _subgraph_arrays(self, nodes: np.ndarray):
        """``(row, col, x)`` of the subgraph ``nodes`` induce, relabelled
        in their order (the seed, first, is local node 0); ``x`` its
        features: the eigenvector embedding, the seed flag and the degree
        over the largest. An isolated seed keeps a self loop."""
        n = len(nodes)
        # the library numbers the nodes in ascending order; position p of
        # that order is node ``order[p]`` of ``nodes``. (The JAX wrapper's
        # library branch maps them through the inverse permutation, which
        # moves the seed off node 0; its numpy branch, which this follows,
        # keeps it there.)
        order = np.argsort(nodes, kind="stable")
        row, col = native.induced_subgraph(self._csr[0], self._csr[1],
                                           nodes[order])
        row, col = order[row], order[col]
        pe = _eigen_pe(row, col, n, self.pe_size, self.pe_size)
        deg = np.bincount(row, minlength=n).astype(np.float32)
        x = np.concatenate(
            [pe, np.eye(1, n, 0, np.float32).T,
             (deg / max(deg.max(), 1.0))[:, None]], axis=1)
        if len(row) == 0:
            row = col = np.zeros(1, np.int64)
        return row, col, x

    def _union(self, node_sets: List[np.ndarray]) -> Graph:
        """The union of the subgraphs of ``node_sets``, laid out as
        ``union_batch`` lays out their Graphs, at the padded sizes every
        step shares: ``2·batch_size·subgraph_size + 8`` nodes, the edges
        rounded up to a power of two (at least 1024), ``2·batch_size + 1``
        graphs; with K1's structure when the model reads it, on the
        graph's device. Built from the subgraphs' arrays at once, without
        a Graph for each."""
        parts = [self._subgraph_arrays(nd) for nd in node_sets]
        sizes = np.array([len(nd) for nd in node_sets], np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        row = np.concatenate([r + o for (r, _, _), o in zip(parts, offsets)])
        col = np.concatenate([c + o for (_, c, _), o in zip(parts, offsets)])
        B2 = 2 * self.batch_size
        n_pad = B2 * self.subgraph_size + 8
        e_pad = max(1024, 1 << int(np.ceil(np.log2(max(row.size, 1)))))
        G = len(node_sets)
        batch = from_coo(np.stack([row, col]), num_nodes=int(sizes.sum()),
                         x=np.concatenate([x for _, _, x in parts]),
                         n_pad=n_pad, e_pad=e_pad,
                         meta={"num_graphs": B2 + 1, "num_classes": None})
        gid = np.full(batch.n_pad, B2, np.int32)
        gid[: sizes.sum()] = np.repeat(np.arange(G, dtype=np.int32), sizes)
        mask = np.zeros(B2 + 1, bool)
        mask[:G] = True
        batch = batch.replace(extras={
            "graph_id": torch.from_numpy(gid),
            "graph_mask": torch.from_numpy(mask),
            "graph_y": torch.zeros(B2 + 1, dtype=torch.int32)})
        if reads_kernel_structure(self.model):
            batch = prepare_spmm(batch)
        return batch.to(self._graph.device)

    def train_batches(self, graph: Graph) -> List[Graph]:
        rng = np.random.default_rng(self.seed + 1000 * self._epoch)
        self._epoch += 1
        batches = []
        for _ in range(self.batches_per_epoch):
            seeds = rng.integers(0, graph.num_nodes, self.batch_size)
            q_nodes = self._rwr_nodes(seeds, int(rng.integers(1 << 30)))
            k_nodes = self._rwr_nodes(seeds, int(rng.integers(1 << 30)))
            batches.append(self._union(q_nodes + k_nodes))
        return batches

    # -- MoCo ------------------------------------------------------------
    def init(self, generator: torch.Generator, graph: Graph):
        """The encoder from ``generator``, then the key weights as a copy
        of its parameters and the queue, ``queue_size`` rows drawn normal from ``generator``
        and row-normalised."""
        m = self.model
        if "moco" in m._modules:
            del m.moco
        m.reset_parameters(generator)
        queue = torch.randn(self.queue_size, self.out_dim,
                            generator=generator)
        queue = queue / queue.norm(dim=1, keepdim=True)
        m.moco = MoCoState(m, queue)

    def key_forward(self, batch: Graph) -> torch.Tensor:
        """The key encoder's output: the query encoder run in eval mode
        with the key weights in place of its parameters (its batch-norm
        buffers, the running statistics, the query encoder's own)."""
        m = self.model
        key = {n: m.moco.key.get_buffer(n) for n, _ in m.named_parameters()}
        with torch.no_grad():
            return torch.func.functional_call(m, key, (batch, batch.x),
                                              {"training": False})

    def loss(self, batch: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        B, m = self.batch_size, self.model
        moco = m.moco
        # first: the key encoder reads the statistics the query's forward
        # in training mode is about to update
        k = self.key_forward(batch)[B: 2 * B]
        q = m(batch, batch.x, training=training, generator=generator)[:B]
        l_pos = (q * k).sum(1, keepdim=True)
        # a copy: the backward reads the queue as it was, after the
        # enqueue below has written into it
        l_neg = q @ moco.queue.clone().T
        logits = torch.cat([l_pos, l_neg], 1) / self.temperature
        loss = (torch.logsumexp(logits, 1) - logits[:, 0]).mean()
        with torch.no_grad():
            slots = moco.ptr + torch.arange(B, device=k.device)
            moco.queue.index_copy_(0, slots, k)
            moco.ptr.copy_((moco.ptr + B) % self.queue_size)
            names, params = zip(*m.named_parameters())
            keys = [moco.key.get_buffer(n) for n in names]
            torch._foreach_mul_(keys, self.momentum)
            torch._foreach_add_(keys, [p.detach() for p in params],
                                alpha=1.0 - self.momentum)
        return loss

    # -- frozen linear probe (gcc_mw "freeze" mode) -----------------------
    @torch.no_grad()
    def embed_nodes(self, nodes: np.ndarray, rng) -> torch.Tensor:
        """``[n_pad, out_dim]``: the encoder's output for each node of
        ``nodes`` (its RWR subgraph's embedding), zeros elsewhere; unions
        of ``2·batch_size`` subgraphs, the last padded with node 0, each
        walked with one more draw of ``rng``."""
        g = self._graph
        embs = torch.zeros(g.n_pad, self.out_dim, device=g.device)
        B2 = 2 * self.batch_size
        for i in range(0, len(nodes), B2):
            chunk = nodes[i: i + B2]
            seeds = np.concatenate([chunk, np.zeros(B2 - len(chunk),
                                                    np.int64)])
            batch = self._union(self._rwr_nodes(seeds,
                                                int(rng.integers(1 << 30))))
            out = self.model(batch, batch.x, training=False)
            embs[torch.from_numpy(chunk).to(g.device)] = out[: len(chunk)]
        return embs

    def evaluate(self, graph: Graph) -> Dict[str, float]:
        if graph.y is None:
            return {"val_acc": 0.0, "test_acc": 0.0}
        missing = [k for k in ("train_mask", "val_mask", "test_mask")
                   if getattr(graph, k) is None]
        if missing:
            raise ValueError(f"GCC's probe needs the graph's split; it has "
                             f"no {', '.join(missing)}")
        rng = np.random.default_rng(self.seed)
        n = graph.num_nodes
        nodes = (np.arange(n) if n <= self.probe_nodes
                 else rng.choice(n, self.probe_nodes, replace=False))
        embs = self.embed_nodes(nodes, rng)
        sub = graph
        if len(nodes) < n:      # restrict the probe to embedded nodes
            keep = torch.zeros(graph.n_pad, dtype=torch.bool,
                               device=graph.device)
            keep[torch.from_numpy(nodes).to(graph.device)] = True
            sub = graph.replace(train_mask=graph.train_mask & keep,
                                val_mask=graph.val_mask & keep,
                                test_mask=graph.test_mask & keep)
        return logreg_probe(embs, sub)
