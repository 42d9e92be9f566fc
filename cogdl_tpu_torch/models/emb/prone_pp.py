"""ProNE++ — the port of ``cogdl_tpu/models/emb/prone_pp.py``: six random
``(μ, θ)`` Chebyshev filters over one ProNE factorisation (the draws stay
numpy's ``default_rng(seed)``: they are the search), each scored by a
probe, the best kept. Every filter runs its eleven K1 products over the
one structure. The probe is 3-fold stratified accuracy of the port's
logistic regression for 1-D labels, else ``-var(emb)``."""

from __future__ import annotations

import numpy as np
import torch

from ...data.graph import Graph
from ...trainer.trainer import resolve_device
from ...utils.probe import logreg_fit, standardize
from ...utils.svm import stratified_kfold
from .base import EmbeddingModel, graph_to_scipy
from .prone import ProNE, propagation_graphs


class ProNEpp(EmbeddingModel):
    def __init__(self, hidden_size: int = 128, max_evals: int = 6,
                 seed: int = 0, **kw):
        super().__init__(hidden_size, seed)
        self.max_evals = max_evals

    def train_embeddings(self, graph: Graph, device=None) -> torch.Tensor:
        device = resolve_device(device)
        self.stats = {}
        rng = np.random.default_rng(self.seed)
        A = graph_to_scipy(graph)
        with self.stage("factorize", device):
            emb0 = ProNE(self.hidden_size, seed=self.seed)._factorize(
                A, device)
        graphs = propagation_graphs(A, device)
        y = None if graph.y is None else graph.y[: graph.num_nodes]
        best_emb, best_score = emb0, -np.inf
        for _ in range(self.max_evals):
            mu = float(rng.uniform(0.0, 0.5))
            theta = float(rng.uniform(0.2, 1.5))
            with self.stage("propagate", device):
                p = ProNE(self.hidden_size, mu=mu, theta=theta,
                          seed=self.seed)
                emb = p._chebyshev(graphs, emb0)
            for key in ("spmm_da", "spmm_a"):
                self.stats[key] = self.stats.get(key, 0) + p.stats[key]
            with self.stage("probe", device):
                score = self._probe(emb, y)
            if score > best_score:
                best_emb, best_score = emb, score
        return best_emb

    @staticmethod
    def _probe(emb: torch.Tensor, y) -> float:
        """Mean accuracy over ``StratifiedKFold(3)`` of the logistic
        regression on the standardised embedding; ``-var(emb)`` when the
        labels are not one per node; ``-inf`` where a fold cannot fit."""
        if y is None or y.ndim != 1:
            return -float(emb.var(unbiased=False))
        X = standardize(emb)[: y.shape[0]]
        y = y.to(X.device)
        try:
            folds = torch.from_numpy(stratified_kfold(y.cpu().numpy(), 3))
            accs = []
            for k in range(3):
                test = (folds == k).to(X.device)
                clf = logreg_fit(X[~test], y[~test])
                accs.append(float((clf.predict(X[test]) == y[test]).double()
                                  .mean()))
            return float(np.mean(accs))
        except ValueError:
            return -np.inf
