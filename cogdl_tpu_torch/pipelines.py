"""Pipelines — the port of ``cogdl_tpu/pipelines.py``: ``pipeline(app)``,
the application entry point beside ``experiment()``.

* ``dataset-stats`` (``stats``): node, edge, feature and class counts of
  datasets, one row each (graph sets: counts and mean sizes);
* ``dataset-visual``: the breadth-first ego network of ``depth`` hops
  around a node, expanded on the device; it returns the outermost
  frontier (in ascending order) and saves a plot where matplotlib is
  installed (without it the plot is skipped, nothing else);
* ``generate-emb``: a network embedding model (ProNE by default) over an
  edge list or a dataset, returned on the device;
* ``recommendation``: LightGCN trained on a user-item dataset through the
  trainer on the device; the pipeline returns ``recommend(users)``, the
  ``topk`` items of each user by ``torch.topk`` over the full graph's
  embeddings (ties may come in another order than the JAX package's
  ``np.argsort``), with the run's metrics as ``recommend.metrics`` and the
  trained model as ``recommend.model``.

The ``oagbert`` app waits for the port of ``oag/``. A pipeline runs on
``device`` (default ``cuda``; none visible raises, and ``device="cpu"``
asks for the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from .datasets import build_dataset
from .datasets.dataset import Dataset
from .trainer.trainer import resolve_device


class Pipeline:
    def __init__(self, app: str, device=None, **kwargs):
        self.app = app
        self.device = resolve_device(device)
        self.kwargs = kwargs

    def __call__(self, *args, **kw):
        raise NotImplementedError


def _dataset(ds) -> Dataset:
    return build_dataset(ds) if isinstance(ds, str) else ds


class DatasetStatsPipeline(Pipeline):
    """A row of counts a dataset, printed and returned: a graph's nodes,
    edges, feature width and classes; a graph set's graph count and mean
    node and edge counts."""

    def __call__(self, datasets: Union[str, Dataset, Sequence, None] = None,
                 **kw):
        datasets = datasets or self.kwargs.get("dataset", "sbm")
        if isinstance(datasets, (str, Dataset)):
            datasets = [datasets]
        rows = []
        for name in datasets:
            ds = _dataset(name)
            if ds.graph is not None:
                g = ds.graph
                rows.append({
                    "dataset": ds.name, "nodes": g.num_nodes,
                    "edges": g.num_edges,
                    "features": 0 if g.x is None else g.num_features,
                    "classes": ds.num_classes,
                })
            elif ds.graphs is not None:
                rows.append({
                    "dataset": ds.name, "graphs": len(ds.graphs),
                    "avg_nodes": float(np.mean([g.num_nodes
                                                for g in ds.graphs])),
                    "avg_edges": float(np.mean([g.num_edges
                                                for g in ds.graphs])),
                })
        for r in rows:
            print("  ".join(f"{k}={v}" for k, v in r.items()))
        return rows


class GenerateEmbeddingPipeline(Pipeline):
    """A network embedding model's ``[num_nodes, dim]`` embedding of an
    edge list (``(2, E)``) or a dataset's graph, on the device."""

    def __call__(self, edge_index=None, dataset=None, model: str = "prone",
                 **model_kwargs):
        from .data.graph import from_coo
        from .models import build_model

        model = self.kwargs.get("model", model)
        model_kwargs = {**self.kwargs.get("model_kwargs", {}), **model_kwargs}
        if dataset is not None:
            graph = _dataset(dataset).graph
        else:
            graph = from_coo(np.asarray(edge_index))
        m = build_model(model, **model_kwargs)
        return m.train_embeddings(graph, self.device)


class RecommendationPipeline(Pipeline):
    """LightGCN (``hidden_size`` 64, ``num_layers`` 2) trained for
    ``epochs`` with the BPR loss and no weight decay on ``dataset``'s
    user-item graph; returns ``recommend(users)``."""

    def __call__(self, dataset="rec-synthetic", topk: int = 10,
                 epochs: int = 30, **kw):
        from .models import build_model
        from .trainer.trainer import Trainer, TrainerConfig
        from .wrappers.node_classification import (
            NodeClfWrapper,
            apply_adj_norm,
        )
        from .wrappers.recommendation import RecommendationWrapper

        ds = _dataset(dataset)
        model = build_model("lightgcn", hidden_size=kw.get("hidden_size", 64),
                            num_layers=kw.get("num_layers", 2))
        w = RecommendationWrapper(model, ds)
        res = Trainer(TrainerConfig(epochs=epochs, weight_decay=0.0,
                                    seed=kw.get("seed", 0),
                                    device=str(self.device))).run(w, ds.graph)
        res.pop("_variables")
        res.pop("_graph")
        num_users = ds.graph.meta_get("num_users")
        full = {}

        @torch.no_grad()
        def recommend(users: Sequence[int]) -> np.ndarray:
            """The ``topk`` items (graph ids, best first) of each user of
            ``users`` by ``u · item`` over the full dataset graph."""
            if "graph" not in full:
                full["graph"] = NodeClfWrapper.with_structure(
                    apply_adj_norm(model, ds.graph.to(self.device)))
            emb = model(full["graph"], training=False)
            u = emb[torch.as_tensor(np.asarray(users, np.int64),
                                    device=self.device)]
            scores = u @ emb[num_users: ds.graph.num_nodes].T
            top = torch.topk(scores, topk, dim=1).indices
            return top.cpu().numpy() + num_users

        recommend.metrics = res
        recommend.model = model
        return recommend


class DatasetVisualPipeline(Pipeline):
    """The ego network of ``depth`` hops around ``seed`` (``-1``: a node
    with an edge drawn by a numpy generator seeded 0, as the reference
    picks it), each edge taken both ways; returns the nodes first reached
    at hop ``depth`` in ascending order, and saves ``out_file`` (default
    ``<name>.png``), the nodes colored by hop, where matplotlib is
    installed."""

    def __call__(self, dataset: Union[str, Dataset, None] = None,
                 seed: int = -1, depth: int = 3, out_file: str = None, **kw):
        ds = _dataset(dataset or self.kwargs.get("dataset", "sbm"))
        g = ds.graph.to(self.device)
        E = g.num_edges
        row, col = g.row[:E].long(), g.col[:E].long()
        # both directions of every edge, as the reference's neighbour sets
        src = torch.cat([row, col])
        dst = torch.cat([col, row])
        rng = np.random.default_rng(0)
        if seed == -1:
            nodes = torch.unique(src).cpu().numpy()
            seed = int(rng.choice(nodes))
        hop = torch.full((g.n_pad,), -1, dtype=torch.long, device=self.device)
        hop[seed] = 0
        frontier = torch.zeros(g.n_pad, dtype=torch.bool, device=self.device)
        frontier[seed] = True
        for d in range(depth):
            reached = torch.zeros_like(frontier)
            reached[dst[frontier[src]]] = True
            frontier = reached & (hop < 0)
            hop[frontier] = d + 1
        q = torch.nonzero(frontier).flatten().cpu().tolist()
        try:
            self._plot(ds.name, hop.cpu().numpy(), src.cpu().numpy(),
                       dst.cpu().numpy(), rng, out_file)
        except ImportError:
            print("matplotlib unavailable; returning BFS frontier only")
        return q

    @staticmethod
    def _plot(name, hop, src, dst, rng, out_file):
        """The reference's radial layout: a ring a hop, nodes spread round
        it from a random angle, sized by closeness; edges in grey."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.cm as cm
        import matplotlib.pyplot as plt

        seen = np.nonzero(hop >= 0)[0]
        max_hop = int(hop[seen].max()) + 1
        cmap = cm.rainbow(np.linspace(0.0, 1.0, max_hop))
        plt.figure(figsize=(6, 6))
        by_hop: Dict[int, List[int]] = {}
        for n in seen.tolist():
            by_hop.setdefault(int(hop[n]), []).append(n)
        pos = {}
        for h, nodes in by_hop.items():
            ang = np.linspace(0, 2 * np.pi, len(nodes), endpoint=False)
            ang += rng.uniform(0, 2 * np.pi)
            for a, n in zip(ang, nodes):
                pos[n] = (h * np.cos(a), h * np.sin(a))
        inside = (hop[src] >= 0) & (hop[dst] >= 0)
        for u, v in zip(src[inside].tolist(), dst[inside].tolist()):
            plt.plot([pos[u][0], pos[v][0]], [pos[u][1], pos[v][1]],
                     color="0.8", lw=0.5, zorder=1)
        for h, nodes in by_hop.items():
            plt.scatter([pos[n][0] for n in nodes],
                        [pos[n][1] for n in nodes], s=(max_hop - h) * 50,
                        color=cmap[h], zorder=2, label=f"hop {h}")
        plt.legend()
        plt.axis("off")
        out_file = out_file or f"{name}.png"
        plt.savefig(out_file)
        plt.close()
        print(f"Sampled ego network saved to {out_file}")


SUPPORTED_APPS = {
    "stats": DatasetStatsPipeline,
    "dataset-stats": DatasetStatsPipeline,
    "dataset-visual": DatasetVisualPipeline,
    "generate-emb": GenerateEmbeddingPipeline,
    "recommendation": RecommendationPipeline,
    "oagbert": None,
}


def pipeline(app: str, **kwargs) -> Pipeline:
    """The pipeline of ``app`` (:data:`SUPPORTED_APPS`), on ``device``
    (default ``cuda``)."""
    try:
        cls = SUPPORTED_APPS[app]
    except KeyError:
        raise ValueError(f"unknown app {app!r}; known: "
                         f"{sorted(SUPPORTED_APPS)}") from None
    if cls is None:
        raise NotImplementedError(
            f"the {app!r} pipeline is not yet ported to cogdl_tpu_torch: it "
            "needs the port of oag/ (ROADMAP.md, item 17)")
    return cls(app, **kwargs)
