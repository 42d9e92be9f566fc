"""How far a KG triple embedding's test MRR on ``random-kg`` spreads over
seeds, and how much of it the initial tables set.

    python -m cogdl_tpu_torch.scripts.kge_seeds \\
        [--models distmult,rotate,complex] [--seeds 16] [--epochs 300] \\
        [--lr 0.01] [--init jax|torch] [--device cpu]

Each model trains through ``TripleLinkPredictionWrapper`` at seeds 0 to
``--seeds`` - 1 and reports the filtered test MRR. ``--init jax`` (the
default) starts from the model's own tables, the JAX package's at
``PRNGKey(seed)``; ``--init torch`` draws them from a ``torch.Generator``
seeded with the seed, uniform in the same range. The batches and
negatives are the seed's either way. One JSON line a model: the MRR of
each seed, their mean, least and most, and the seconds a seed.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..datasets import build_dataset
from ..trainer.trainer import resolve_device
from ..wrappers.triple_link_prediction import TripleLinkPredictionWrapper


def torch_tables(model, seed: int) -> Dict[str, torch.Tensor]:
    """``model``'s tables, uniform in ``±gamma / dim`` from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    scale = model.gamma / model.dim
    return {k: (torch.rand(rows, cols, generator=gen) * 2.0 - 1.0) * scale
            for k, rows, cols in (
                ("ent", model.num_entities, model.entity_dim()),
                ("rel", model.num_relations, model.relation_dim()))}


def spread(name: str, seeds: int, epochs: int, lr: float, init: str,
           device) -> Dict:
    ds = build_dataset("random-kg")
    t = ds.triples
    mrr = []
    t0 = time.perf_counter()
    for seed in range(seeds):
        m = TripleLinkPredictionWrapper(name, ds, seed=seed, epochs=epochs,
                                        lr=lr).model
        m.train_triples(t, device=device, init=(
            torch_tables(m, seed) if init == "torch" else None))
        mrr.append(m.evaluate(t, "test")["mrr"])
    return {"model": name, "init": init, "epochs": epochs, "lr": lr,
            "mrr": mrr, "mean": float(np.mean(mrr)), "min": min(mrr),
            "max": max(mrr),
            "s_per_seed": (time.perf_counter() - t0) / seeds}


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(
        "kge_seeds", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--models", default="distmult,rotate,complex")
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--init", choices=("jax", "torch"), default="jax")
    ap.add_argument("--device", default=None,
                    help="cuda unless named (cpu to rehearse)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = []
    for name in args.models.split(","):
        rec = spread(name, args.seeds, args.epochs, args.lr, args.init,
                     device)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
