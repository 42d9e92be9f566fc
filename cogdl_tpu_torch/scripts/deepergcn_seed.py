"""Where DeeperGCN's test accuracy at one seed comes from on the card: the
readings of ``chip_smoke.py``'s zoo-quality run (``sbm``, the model's
defaults, 64 wide and 14 blocks, 300 epochs, seed 0) taken several times
on the card, once on the CPU and under
``torch.use_deterministic_algorithms``, and the card's logits against the
CPU's over the first epochs of one run from the same weights and the same
dropout masks.

    python -m cogdl_tpu_torch.scripts.deepergcn_seed [--runs 4] \\
        [--epochs 300] [--seed 0] [--weights JAX.npz] [--no-cpu] \\
        [--deterministic] [--trajectory 10] [--only-trajectory]

A reading is ``experiments.train`` as zoo-quality calls it; the card draws
its dropout masks from the trainer's CUDA generator, the CPU from its CPU
generator, so a seed is another run on each device. The same-draws
readings take every mask from one CPU generator seeded with the seed
(moved to the card), so the card and the CPU then run one computation up
to the order of the card's atomic sums (``index_add``). ``--deterministic``
takes the card's readings under ``torch.use_deterministic_algorithms(True)``
(start the process with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which cuBLAS
then needs). ``--trajectory N`` trains one copy on the card and one on the CPU for
``N`` epochs from the same weights and masks, under Adam and under SGD,
and prints the logits, loss and gradients before the first step and,
after each epoch, the largest logit difference over
``1e-4 + 1e-4·max|logits|`` (:func:`trajectory`).

The weights are the trainer's (initialised on the CPU from the seed, the
same on every device) or, with ``--weights``, the JAX package's flax
variables of this model, flattened into an ``.npz`` whose keys are their
paths joined by ``/`` (``params/fc_in/kernel``, ``batch_stats/...``), put
in by ``load_jax_params``. One JSON line a reading or comparison; the
last line sums them up. A device that is asked for and missing raises.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..datasets import build_dataset
from ..experiments import train
from ..layers import utils as layer_utils
from ..models import build_model, load_jax_params
from ..trainer.trainer import (
    Trainer,
    TrainerConfig,
    build_optimizer,
    resolve_device,
)
from ..wrappers.node_classification import NodeClfWrapper

# zoo-quality's run: sbm at the model's defaults for 300 epochs
MODEL = "deepergcn"
DATASET = "sbm"
EPOCHS = 300


def read_weights(path: str) -> Dict[str, Dict]:
    """The nested flax variables of an ``.npz`` whose keys are paths
    joined by ``/``."""
    out: Dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    return out


@contextlib.contextmanager
def cpu_draws(seed: int):
    """Every dropout mask drawn from one CPU generator seeded ``seed`` and
    moved to the tensor's device, whatever generator the caller passes."""
    gen = torch.Generator().manual_seed(seed)
    real = layer_utils.dropout_keep

    def keep(shape, rate, device, generator=None):
        return (torch.rand(shape, generator=gen) < 1.0 - rate).to(device)

    layer_utils.dropout_keep = keep
    try:
        yield
    finally:
        layer_utils.dropout_keep = real


@contextlib.contextmanager
def injected(variables: Optional[Dict]):
    """``NodeClfWrapper.init`` loading ``variables`` (the JAX package's)
    in place of its draw, when given."""
    if variables is None:
        yield
        return
    real = NodeClfWrapper.init

    def init(self, generator, graph):
        load_jax_params(self.model, variables["params"],
                        variables.get("batch_stats"))

    NodeClfWrapper.init = init
    try:
        yield
    finally:
        NodeClfWrapper.init = real


def reading(device: torch.device, epochs: int, seed: int, label: str,
            variables=None, same_draws: bool = False) -> Dict:
    """One zoo-quality run of DeeperGCN on ``device``."""
    ds = build_dataset(DATASET)
    t0 = time.perf_counter()
    with injected(variables), (cpu_draws(seed) if same_draws
                               else contextlib.nullcontext()):
        res = train(ds, MODEL, seed=seed, epochs=epochs, device=str(device))
    return {"reading": label, "device": str(device), "seed": seed,
            "test_acc": res["test_acc"], "val_acc": res["val_acc"],
            "best_epoch": res["best_epoch"],
            "seconds": round(time.perf_counter() - t0, 2)}


def _copy(device: torch.device, seed: int, variables,
          optimizer: str = "adam"):
    """The wrapper, prepared graph, optimizer and generator of one run on
    ``device``, its weights the trainer's from ``seed`` or
    ``variables``."""
    ds = build_dataset(DATASET)
    model = build_model(MODEL, in_features=ds.num_features,
                        out_features=ds.num_classes)
    wrapper = NodeClfWrapper(model, dataset=ds)
    graph = wrapper.prepare_graph(ds.graph.to(device))
    model.to("cpu")
    with injected(variables):
        wrapper.init(torch.Generator().manual_seed(seed), graph)
    model.to(device)
    cfg = TrainerConfig(seed=seed, device=str(device), optimizer=optimizer)
    opt, sched = build_optimizer(cfg, model.parameters())
    gen = torch.Generator(device=device).manual_seed(seed)
    return Trainer(cfg), wrapper, graph, opt, sched, gen


def _err(a: torch.Tensor, b: torch.Tensor, rel: float) -> float:
    """The largest ``|a - b|`` over ``rel·(1 + max|b|)``."""
    return float((a - b).abs().max()) / (rel * (1.0 + float(b.abs().max())))


def trajectory(device: torch.device, epochs: int, seed: int,
               variables=None, optimizer: str = "adam") -> list:
    """The card's and the CPU's runs from the same weights and the same
    masks (:func:`cpu_draws`) under ``optimizer`` (the trainer's Adam, or
    SGD, whose step is linear in the gradient): before any step (epoch 0)
    the eval logits, the first step's loss and gradients (each over
    ``1e-4·(1 + max|CPU|)``) and the parameters whose Adam step changes
    sign (a gradient near zero whose sign the sums' order flips: its step
    is ``lr`` either way); then after each of ``epochs`` epochs the
    largest logit difference over ``1e-4 + 1e-4·max|CPU logits|``."""
    runs = {}
    for dev in (device, torch.device("cpu")):
        trainer, wrapper, graph, opt, sched, gen = _copy(dev, seed,
                                                         variables, optimizer)
        model = wrapper.model
        with torch.no_grad():
            logits = [model(graph, graph.x, training=False).cpu()]
        # the first step's gradients, the batch statistics put back after
        state = copy.deepcopy(model.state_dict())
        with cpu_draws(seed):
            loss = wrapper.loss(graph, gen, training=True)
            loss.backward()
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
        model.load_state_dict(state)
        with cpu_draws(seed):
            for _ in range(epochs):
                trainer.train_step(wrapper, opt, sched, graph, gen)
                with torch.no_grad():
                    logits.append(model(graph, graph.x,
                                        training=False).cpu())
        runs[dev.type] = (logits, float(loss.detach()), grads)
    (lc, loss_c, gc), (lh, loss_h, gh) = runs[device.type], runs["cpu"]
    flips = sum(int((torch.sign(gc[k]) != torch.sign(gh[k])).sum())
                for k in gh)
    first = {"epoch": 0, "optimizer": optimizer,
             "logits_err_over_tol": _err(lc[0], lh[0], 1e-4),
             "loss_diff": abs(loss_c - loss_h),
             "grad_err_over_tol": max(_err(gc[k], gh[k], 1e-4) for k in gh),
             "grad_sign_flips": flips,
             "grad_elements": sum(g.numel() for g in gh.values())}
    rows = [first]
    for e, (a, b) in enumerate(zip(lc[1:], lh[1:]), 1):
        diff = float((a - b).abs().max())
        tol = 1e-4 + 1e-4 * float(b.abs().max())
        rows.append({"epoch": e, "optimizer": optimizer,
                     "max_abs_diff": diff, "max_abs_logit":
                     float(b.abs().max()), "err_over_tol": diff / tol})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser("deepergcn_seed", description=__doc__.split(
        "\n\n")[0])
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights", default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--no-cpu", action="store_true")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--trajectory", type=int, default=10)
    p.add_argument("--only-trajectory", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    variables = read_weights(args.weights) if args.weights else None
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    tag = "card-deterministic" if args.deterministic else "card"
    rows = []
    if args.only_trajectory:
        for opt in ("adam", "sgd"):
            for r in trajectory(device, args.trajectory, args.seed,
                                variables, opt):
                print(json.dumps({"trajectory": r}), flush=True)
        return 0
    for i in range(args.runs):
        rows.append(dict(reading(device, args.epochs, args.seed, tag,
                                 variables), run=i))
        print(json.dumps(rows[-1]), flush=True)
    if not args.deterministic:
        devices = [device] + ([] if args.no_cpu else [torch.device("cpu")])
        if not args.no_cpu:
            rows.append(reading(torch.device("cpu"), args.epochs, args.seed,
                                "cpu", variables))
            print(json.dumps(rows[-1]), flush=True)
        for dev in devices:
            rows.append(reading(dev, args.epochs, args.seed, "same-draws",
                                variables, same_draws=True))
            print(json.dumps(rows[-1]), flush=True)
        if args.trajectory and not args.no_cpu:
            for opt in ("adam", "sgd"):
                for r in trajectory(device, args.trajectory, args.seed,
                                    variables, opt):
                    print(json.dumps({"trajectory": r}), flush=True)
    summary = {}
    for r in rows:
        summary.setdefault(f"{r['reading']}@{r['device']}", []).append(
            r["test_acc"])
    print("[deepergcn-seed] " + json.dumps({
        "seed": args.seed, "epochs": args.epochs,
        "weights": "jax" if variables else "trainer",
        "test_acc": summary,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
