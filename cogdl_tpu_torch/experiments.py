"""Experiment API — the port of ``cogdl_tpu/experiments.py``.

``experiment(dataset, model, seed=[...], device=None, **hyperparams)`` runs
the variant grid dataset × model × seed, trains each with the wrapper
matched to the model and prints a results table. ``device`` defaults to
``cuda``; with no card visible the call raises unless it asks for
``device="cpu"``.
"""

from __future__ import annotations

import inspect
import itertools
from collections import defaultdict
from dataclasses import fields as dc_fields
from typing import Dict, List, Sequence, Union

import numpy as np

from .configs import BEST_CONFIGS
from .datasets import build_dataset
from .datasets.dataset import Dataset
from .models import build_model
from .trainer.trainer import Trainer, TrainerConfig, resolve_device
from .wrappers import default_wrapper_for, fetch_wrapper

TRAINER_KEYS = {f.name for f in dc_fields(TrainerConfig)}


def _as_list(x) -> List:
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def gen_variants(datasets, models, seeds):
    """Cartesian variant grid."""
    return list(itertools.product(_as_list(datasets), _as_list(models),
                                  _as_list(seeds)))


def set_best_config(model: str, dataset: str, kwargs: Dict) -> Dict:
    """Overlay per-(model, dataset) tuned hyper-parameters under the user's
    kwargs. Precedence: defaults < best-config < user kwargs."""
    merged = {}
    merged.update(BEST_CONFIGS.get(model, {}).get("general", {}))
    merged.update(BEST_CONFIGS.get(model, {}).get(dataset, {}))
    merged.update(kwargs)
    return merged


def _setup_variant(ds, model, seed, wrapper, kwargs):
    """Split kwargs by consumer and build ``(wrapper, model,
    trainer_kwargs)``; for a wrapper that owns its whole loop
    (``run_embedding``: the KG triple embeddings) ``model`` is None and the
    wrapper builds its model from the kwargs no trainer takes."""
    wrapper_cls = fetch_wrapper(wrapper or default_wrapper_for(model))
    wrapper_keys = set(inspect.signature(wrapper_cls.__init__).parameters) - {
        "self", "model", "dataset", "kwargs"}
    trainer_kwargs = {k: v for k, v in kwargs.items() if k in TRAINER_KEYS}
    wrapper_kwargs = {k: v for k, v in kwargs.items()
                      if k in wrapper_keys and k not in TRAINER_KEYS}
    model_kwargs = {k: v for k, v in kwargs.items()
                    if k not in TRAINER_KEYS and k not in wrapper_keys}
    trainer_kwargs["seed"] = seed
    if "seed" in wrapper_keys:
        wrapper_kwargs.setdefault("seed", seed)
    if hasattr(wrapper_cls, "run_embedding"):
        return (wrapper_cls(model_name=model, dataset=ds, **wrapper_kwargs,
                            **model_kwargs), None, trainer_kwargs)
    out_features = ds.num_classes
    if out_features is None:
        out_features = model_kwargs.get("hidden_size", 64)
    mdl = build_model(model, in_features=_in_features(ds),
                      out_features=out_features, **model_kwargs)
    return wrapper_cls(mdl, dataset=ds, **wrapper_kwargs), mdl, trainer_kwargs


def _in_features(ds) -> int:
    """A model's input width: a traffic series' channels (flax infers
    them from the window; the port's convolutions are built for them),
    else the node features' (0 for a graph without any, the
    recommendation graph)."""
    g = ds.graph
    if g is not None and g.extras and "series" in g.extras:
        return int(g.extras["series"].shape[-1])
    return ds.num_features


def _check_unported(kwargs):
    for key in ("export_path", "vmap_seeds", "search_space"):
        if kwargs.get(key):
            raise NotImplementedError(
                f"{key} is not yet ported to cogdl_tpu_torch (ROADMAP.md §1)")


def train(
    dataset: Union[str, Dataset],
    model: str,
    seed: int = 0,
    wrapper=None,
    use_best_config: bool = False,
    **kwargs,
) -> Dict[str, float]:
    """Train one variant end to end."""
    _check_unported(kwargs)
    resolve_device(kwargs.get("device"))
    ds = build_dataset(dataset) if isinstance(dataset, str) else dataset
    if use_best_config:
        kwargs = set_best_config(model, ds.name, kwargs)
    w, mdl, trainer_kwargs = _setup_variant(ds, model, seed, wrapper, kwargs)
    if mdl is None:
        return w.run_embedding(trainer_kwargs.get("device"))
    result = Trainer(TrainerConfig(**trainer_kwargs)).run(w, ds.graph)
    result.pop("_variables", None)
    result.pop("_graph", None)
    return result


def raw_experiment(datasets, models, seeds=(1,), **kwargs) -> Dict[tuple, List[Dict]]:
    """Run the variant grid; returns ``(dataset, model)`` → per-seed results.
    Each named dataset is built once and shared by its model × seed
    variants, so training never writes into a dataset's graph."""
    _check_unported(kwargs)
    resolve_device(kwargs.get("device"))  # fail before building any data
    built: Dict = {}

    def resolve(ds):
        key = ds if isinstance(ds, str) else id(ds)
        if key not in built:
            built[key] = build_dataset(ds) if isinstance(ds, str) else ds
        return built[key]

    results = defaultdict(list)
    for ds, mdl, seed in gen_variants(datasets, models, seeds):
        res = train(resolve(ds), mdl, seed=seed, **kwargs)
        key = (ds if isinstance(ds, str) else getattr(ds, "name", "dataset"), mdl)
        results[key].append(res)
    return dict(results)


def output_results(results: Dict, metrics: Sequence[str] = ("test_acc", "val_acc")):
    """Tabulated mean±std per variant."""
    col_names = ["Variant"] + list(metrics)
    rows = []
    for (ds, mdl), runs in results.items():
        row = [f"({ds!r}, {mdl!r})"]
        for m in metrics:
            vals = [r[m] for r in runs if m in r]
            row.append(f"{np.mean(vals):.4f}±{np.std(vals):.4f}" if vals else "—")
        rows.append(row)
    widths = [max(len(str(r[i])) for r in rows + [col_names])
              for i in range(len(col_names))]
    lines = ["  ".join(str(c).ljust(w) for c, w in zip(col_names, widths))]
    lines += ["  ".join(str(c).ljust(w) for c, w in zip(r, widths)) for r in rows]
    table = "\n".join(lines)
    print(table)
    return table


def experiment(dataset, model, seed: Union[int, Sequence[int]] = 1,
               seeds: Union[None, int, Sequence[int]] = None, **kwargs):
    """The one-call API.

    >>> experiment(dataset="sbm", model="gcn", epochs=50)        # on the card
    >>> experiment(dataset="sbm", model="gcn", device="cpu")

    ``seeds`` is an alias for ``seed``.
    """
    if seeds is not None:
        seed = seeds
    results = raw_experiment(dataset, model, seeds=_as_list(seed), **kwargs)
    output_results(results)
    return results
