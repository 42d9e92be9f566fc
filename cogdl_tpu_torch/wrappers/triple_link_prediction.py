"""KG triple link prediction — the port of
``cogdl_tpu/wrappers/triple_link_prediction.py``: a TransE-family model
(``models/emb/knowledge_base.py``) trains itself on the triples and reports
filtered MRR and hits@k on the valid and test triples. The wrapper owns the
whole loop (``run_embedding``); no trainer runs, so the trainer's keys of
``experiment()`` (``epochs``, ``lr``) never reach the model, as in the JAX
package."""

from __future__ import annotations

from typing import Dict

from ..models import build_model
from ..trainer.trainer import resolve_device


class TripleLinkPredictionWrapper:
    def __init__(self, model_name: str, dataset, seed: int = 0,
                 **model_kwargs):
        triples = dataset.triples
        model_kwargs.setdefault("num_entities", triples["num_entities"])
        model_kwargs.setdefault("num_relations", triples["num_relations"])
        self.model = build_model(model_name, seed=seed, **model_kwargs)
        self.dataset = dataset

    def run_embedding(self, device=None) -> Dict[str, float]:
        """Train on ``device`` (``cuda`` unless the caller names another;
        raises without a card), then evaluate."""
        triples = self.dataset.triples
        self.model.train_triples(triples, device=resolve_device(device))
        val = self.model.evaluate(triples, "valid")
        test = self.model.evaluate(triples, "test")
        out = {f"val_{k}": v for k, v in val.items()}
        out.update({f"test_{k}": v for k, v in test.items()})
        out["val_acc"] = out["val_mrr"]
        out["test_acc"] = out["test_mrr"]
        return out
