"""Traffic forecasting — the port of
``cogdl_tpu/wrappers/traffic_prediction.py`` (``TrafficPredictionWrapper``):
sliding windows of ``window`` steps of the graph's series, each to predict
the step ``horizon`` after its end; a 70 / 15 / 15 split in time order;
the masked MSE over the real nodes to train, MAE and RMSE over the
validation and test windows.

The series goes to the device with the graph, once; a batch is the start
indices of its windows there, and the windows are sliced out of the series
on the device, the values the JAX wrapper's numpy windows hold. The
training batches are one permutation of the training windows from
``numpy.random.default_rng(seed)``, drawn once a run (the trainers read
``train_batches`` once), whole batches only, as in the JAX wrapper; the
evaluation takes whole batches in order too. So only ``batch_size · T``
slices ever reach a spatial step, and ``prepare_graph`` builds the models'
unions of the road graph for those counts, with their kernel structure on
the card (``TrafficModel.prepare_unions``): no step builds one.

A step draws nothing: given the JAX package's initial weights
(``models.load_jax_params``) and the same seed, the port trains on the
JAX wrapper's batches in its order, as the tests hold it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.graph import Graph
from .node_classification import apply_adj_norm


class TrafficPredictionWrapper:
    eval_metric = "val_mae"
    eval_mode = "min"

    def __init__(self, model, dataset=None, window: int = 12,
                 horizon: int = 3, batch_size: int = 16, seed: int = 0):
        self.model = model
        self.dataset = dataset
        self.window = window
        self.horizon = horizon
        self.batch_size = batch_size
        self.seed = seed

    # -- data ---------------------------------------------------------------
    def prepare_graph(self, graph: Graph) -> Graph:
        """The windows' split and the series on ``graph``'s device, then
        the graph under the model's normalisation with the model's unions
        for batches of ``batch_size``."""
        self.series = graph.extras["series"]             # [T, n_pad, C]
        n = self.series.shape[0] - self.window - self.horizon + 1
        if n < 1:
            raise ValueError(f"a series of {self.series.shape[0]} steps has "
                             f"no window of {self.window} + {self.horizon}")
        n_tr, n_va = int(0.7 * n), int(0.15 * n)
        self.splits = {"train": (0, n_tr), "val": (n_tr, n_tr + n_va),
                       "test": (n_tr + n_va, n)}
        self._rng = np.random.default_rng(self.seed)
        graph = apply_adj_norm(self.model, graph)
        if hasattr(self.model, "prepare_unions"):
            graph = self.model.prepare_unions(graph, self.batch_size,
                                              self.window)
        return graph

    def windows(self, starts: torch.Tensor):
        """``x`` ``[b, window, n_pad, C]`` and ``y`` ``[b, n_pad, C]`` of the
        windows that start at ``starts``."""
        steps = starts[:, None] + torch.arange(self.window,
                                               device=starts.device)
        return (self.series[steps],
                self.series[starts + self.window + self.horizon - 1])

    def train_batches(self, graph: Graph) -> List:
        """``(graph, starts)`` for each whole batch of one permutation of
        the training windows (all of them when there are fewer than a
        batch)."""
        n_tr = self.splits["train"][1]
        idx = self._rng.permutation(n_tr)
        B = self.batch_size
        cuts = [idx[s: s + B] for s in range(0, len(idx) - B + 1, B)]
        cuts = cuts or [np.arange(min(B, n_tr))]
        return [(graph, torch.from_numpy(c).to(graph.device)) for c in cuts]

    def init(self, generator: torch.Generator, graph: Graph):
        """The model sized for the wrapper's windows, drawn from
        ``generator``."""
        self.model.reset_parameters(generator, window=self.window)

    # -- steps --------------------------------------------------------------
    def loss(self, batch, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        """The MSE over the real nodes of the batch's windows."""
        graph, starts = batch
        x, y = self.windows(starts)
        pred = self.model(graph, x, training=training, generator=generator)
        node_m = graph.node_mask().to(pred.dtype)[None, :, None]
        err = (pred - y) ** 2 * node_m
        return err.sum() / node_m.expand(err.shape).sum().clamp_min(1.0)

    @torch.no_grad()
    def evaluate(self, graph: Graph) -> Dict[str, float]:
        """MAE and RMSE over the real nodes of every whole batch of each
        split, the batches' sums added on the host in float64 in order."""
        out = {}
        B = self.batch_size
        m = graph.node_mask().float()[None, :, None]
        for split in ("val", "test"):
            lo, hi = self.splits[split]
            sums = []
            for s in range(lo, hi - B + 1, B):
                x, y = self.windows(torch.arange(s, s + B,
                                                 device=graph.device))
                e = self.model(graph, x, training=False) - y
                sums.append(torch.stack([(e.abs() * m).sum(),
                                         ((e * m) ** 2).sum(),
                                         m.expand(y.shape).sum()]))
            abs_err = sq_err = cnt = 0.0
            for a, q, c in (torch.stack(sums).tolist() if sums else ()):
                abs_err, sq_err, cnt = abs_err + a, sq_err + q, cnt + c
            out[f"{split}_mae"] = abs_err / max(cnt, 1.0)
            out[f"{split}_rmse"] = (sq_err / max(cnt, 1.0)) ** 0.5
        return out
