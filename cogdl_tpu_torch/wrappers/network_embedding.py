"""Network embedding — the port of
``cogdl_tpu/wrappers/network_embedding.py``: a shallow embedding model
trains itself on the whole graph on the device, and the embedding goes
from there to the probe: the logistic regression over the graph's splits
(one label a node and a train mask; the embedding zero-padded to the
graph's padded rows, as the JAX wrapper pads it) or the shuffled micro /
macro-F1 protocol (``f1_label_probe``, ``test_acc`` its micro-F1). The
wrapper owns the whole loop (``run_embedding``); no trainer runs."""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..models import build_model
from ..trainer.trainer import resolve_device
from ..utils.probe import f1_label_probe, logreg_probe


class NetworkEmbeddingWrapper:
    def __init__(self, model_name: str, dataset, seed: int = 0,
                 training_percents=(0.9,), **model_kwargs):
        self.model = build_model(model_name, seed=seed, **model_kwargs)
        self.dataset = dataset
        self.seed = seed
        self.training_percents = training_percents

    def run_embedding(self, device=None) -> Dict[str, float]:
        """Train on ``device`` (``cuda`` unless the caller names another;
        raises without a card), then probe. The result also carries
        ``embed_s`` (training, the card synchronised) and the model's
        ``stats``: its stages' seconds, steps and products."""
        device = resolve_device(device)
        graph = self.dataset.graph
        t0 = time.perf_counter()
        emb = self.model.train_embeddings(graph, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        embed_s = time.perf_counter() - t0
        y = graph.y[: graph.num_nodes]
        if graph.train_mask is not None and y.ndim == 1:
            pad = emb.new_zeros(graph.n_pad - emb.shape[0], emb.shape[1])
            out = logreg_probe(torch.cat([emb, pad]), graph.to(device))
        else:
            out = f1_label_probe(emb, y, train_ratio=self.training_percents[0],
                                 seed=self.seed)
            out["test_acc"] = out["test_micro_f1"]
        out["val_acc"] = out.get("val_acc", out.get("test_acc", 0.0))
        out["embed_s"] = embed_s
        out["stats"] = dict(self.model.stats)
        return out
