"""Training runtime — the port of ``cogdl_tpu/trainer/trainer.py``.

``Trainer.run(wrapper, graph)`` moves the graph to the device (for a
multi-graph task, ``graph`` None, the wrapper moves the batches it holds:
``wrapper.to_device``), lets the wrapper prepare it, initialises the model from a seeded generator and runs
the epoch loop: one ``train_step`` per batch, evaluation every
``eval_step`` epochs, early stopping on the wrapper's monitor, the
``nan_guard`` rollback, and a final evaluation on the best parameters.

A wrapper's batches come one of two ways, as in the JAX trainer: its
``train_batches(graph)``, read once (or every epoch when the wrapper sets
``refresh_per_epoch``); or, when it has ``epoch_xs`` and ``make_batch``,
one step per row of ``epoch_xs(graph)`` each epoch, the batch made by
``make_batch(graph, row)`` (the JAX trainer scans that loop inside one jit;
here it is a plain loop).

A wrapper with ``num_stages`` trains that many stages in a row, as the JAX
trainer does: before each, ``pre_stage(stage, graph)`` runs with the best
snapshot's weights in the model and may return a new graph (its batches
are then rebuilt); after each, ``post_stage(stage, graph)``, also with the
best weights. Training goes on from the current weights and optimizer
state. Patience restarts each stage; the best score, its epoch and the
``nan_guard`` count carry over; ``start_epoch`` applies to stage 0 only;
``train_step_ms`` and ``eval_ms`` span every stage.

It runs on the card unless the config asks for the CPU, and raises when no
card is visible rather than carry on on the CPU.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device a run uses: ``cuda`` unless the caller names another.
    Raises when a CUDA device is asked for (or defaulted to) and none is
    visible — there is no silent move to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cogdl_tpu_torch runs on an NVIDIA card by default and torch sees "
            "none; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return device


@dataclass
class TrainerConfig:
    epochs: int = 200
    lr: float = 1e-2
    weight_decay: float = 5e-4
    patience: int = 100
    eval_step: int = 1
    seed: int = 0
    monitor: str = "val_acc"          # early-stop metric
    monitor_mode: str = "max"
    grad_clip: Optional[float] = None
    optimizer: str = "adam"           # adam | adamw | sgd
    lr_schedule: Optional[str] = None  # None | "cosine" | "linear" | "noam"
    warmup_steps: int = 0
    progress: bool = False
    checkpoint_path: Optional[str] = None
    resume_training: bool = False
    # when the train loss goes non-finite at an eval point, roll back to the
    # best snapshot and keep going; give up after nan_guard_retries
    nan_guard: bool = True
    nan_guard_retries: int = 3
    device: Optional[str] = None      # None → "cuda"
    # options of the JAX trainer that are not ported yet (ROADMAP.md §1,
    # "Trainer extras"); setting any of them raises
    logger: Optional[Any] = None
    bf16: bool = False
    profile_dir: Optional[str] = None
    attack: Optional[str] = None
    activation_compression: bool = False

    def __post_init__(self):
        unported = [name for name, on in (
            ("logger", self.logger not in (None, "none")),
            ("bf16", self.bf16),
            ("profile_dir", self.profile_dir is not None),
            ("attack", self.attack is not None),
            ("activation_compression", self.activation_compression)) if on]
        if unported:
            raise NotImplementedError(
                f"TrainerConfig options {unported} are not yet ported to "
                "cogdl_tpu_torch (ROADMAP.md §1, 'Trainer extras')")


def _schedule_factor(cfg: TrainerConfig):
    """Learning-rate multiplier per optimizer step, as the optax schedules
    of the JAX package compute it (None: constant)."""
    steps = max(cfg.epochs, 1)
    if cfg.lr_schedule == "cosine":
        return lambda s: 0.5 * (1.0 + math.cos(math.pi * min(s, steps) / steps))
    if cfg.lr_schedule == "linear":
        return lambda s: 1.0 - min(s, steps) / steps
    if cfg.lr_schedule == "noam":
        warm = max(cfg.warmup_steps, 1)
        return lambda s: (min((s + 1.0) ** -0.5, (s + 1.0) * warm ** -1.5)
                          * warm ** 0.5)
    if cfg.lr_schedule is not None:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}: "
                         "cosine | linear | noam")
    return None


def build_optimizer(cfg: TrainerConfig, params
                    ) -> Tuple[Optional[torch.optim.Optimizer], Any]:
    """Optimizer and schedule. ``adam`` adds ``weight_decay · p`` to the
    gradient before Adam (optax ``add_decayed_weights`` then ``adam``, which
    is ``torch.optim.Adam(weight_decay=…)``); ``adamw`` decouples the decay;
    ``sgd`` is momentum 0.9 without decay. Returns ``(optimizer,
    scheduler-or-None)``; step the scheduler once per optimizer step. A
    model without parameters (AGC) gets ``(None, None)``: optax steps an
    empty tree as a no-op, and the trainer then only computes the loss."""
    params = list(params)
    if not params:
        return None, None
    if cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=0.9)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr,
                               weight_decay=cfg.weight_decay or 0.0)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}: "
                         "adam | adamw | sgd")
    factor = _schedule_factor(cfg)
    sched = (None if factor is None
             else torch.optim.lr_scheduler.LambdaLR(opt, factor))
    return opt, sched


def clip_by_global_norm(params, max_norm: float) -> None:
    """Scale all gradients by ``max_norm / ‖g‖`` when the global norm
    exceeds ``max_norm`` (optax ``clip_by_global_norm``)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    for g in grads:
        g.mul_(scale.to(g.dtype))


def _snapshot(model, opt, sched):
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            None if opt is None else copy.deepcopy(opt.state_dict()),
            None if sched is None else sched.state_dict())


def _opt_state_fits(opt, state) -> bool:
    """Whether a saved optimizer ``state_dict`` fits ``opt``: the same
    groups with the same hyperparameter names and parameter counts, and every
    saved per-parameter tensor shaped as its parameter (``load_state_dict``
    checks only the counts)."""
    groups = state.get("param_groups", [])
    if len(groups) != len(opt.param_groups):
        return False
    params = {}
    for saved, mine in zip(groups, opt.param_groups):
        if set(saved) != set(mine) or len(saved["params"]) != len(
                mine["params"]):
            return False
        params.update(zip(saved["params"], mine["params"]))
    for i, st in state.get("state", {}).items():
        if i not in params:
            return False
        for v in st.values():
            if torch.is_tensor(v) and v.ndim and v.shape != params[i].shape:
                return False
    return True


def _restore(model, opt, sched, snap):
    state, opt_state, sched_state = snap
    model.load_state_dict(state)
    if opt is not None:
        opt.load_state_dict(opt_state)
    if sched is not None:
        sched.load_state_dict(sched_state)


def _with_weights(model, snap, fn):
    """``fn()`` with the model's weights (and buffers) those of the snapshot
    ``snap``; the model's own are put back after, and the optimizer's state
    is not touched."""
    current = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(snap[0])
    try:
        return fn()
    finally:
        model.load_state_dict(current)


class Trainer:
    """Task-agnostic epoch driver around a wrapper's loss/evaluate."""

    def __init__(self, cfg: Optional[TrainerConfig] = None, **kw):
        self.cfg = TrainerConfig(**kw) if cfg is None else cfg

    def train_step(self, wrapper, optimizer, scheduler, graph,
                   generator: torch.Generator) -> torch.Tensor:
        """One optimizer step on one batch; returns the (detached) loss
        without waiting for the device. A parameter the loss does not reach
        steps with a zero gradient, as every leaf of the JAX trainer's tree
        does (weight decay then moves it). Without an optimizer (a model
        without parameters) the step only computes the loss."""
        if optimizer is None:
            with torch.no_grad():
                return wrapper.loss(graph, generator, training=True).detach()
        params = [p for g in optimizer.param_groups for p in g["params"]]
        optimizer.zero_grad(set_to_none=True)
        loss = wrapper.loss(graph, generator, training=True)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.cfg.grad_clip:
            clip_by_global_norm(params, self.cfg.grad_clip)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach()

    def run(self, wrapper, graph) -> Dict[str, Any]:
        cfg = self.cfg
        device = resolve_device(cfg.device)
        if graph is None:
            # a multi-graph task (graph classification): the wrapper holds
            # its batches and moves them to the device itself
            if not hasattr(wrapper, "to_device"):
                raise ValueError(
                    f"Trainer.run got no graph, and {type(wrapper).__name__} "
                    "holds no batches of its own (to_device)")
            wrapper.to_device(device)
        else:
            graph = graph.to(device)
        if hasattr(wrapper, "prepare_graph"):
            graph = wrapper.prepare_graph(graph)
        model = wrapper.model
        # initialise on the CPU from a CPU generator: the same seed gives the
        # same weights on every device
        model.to("cpu")
        wrapper.init(torch.Generator().manual_seed(cfg.seed), graph)
        model.to(device)
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        opt, sched = build_optimizer(cfg, model.parameters())
        start_epoch = 0
        if cfg.resume_training and cfg.checkpoint_path:
            from .checkpoint import load_checkpoint, to_torch

            try:
                ckpt = load_checkpoint(cfg.checkpoint_path)
            except FileNotFoundError:
                ckpt = None
            if ckpt is not None:
                model.load_state_dict(to_torch(ckpt["params"]))
                opt_state = to_torch(ckpt.get("opt_state"))
                # as the reference (cogdl_tpu/trainer/trainer.py:220-225): a
                # saved state that does not fit this optimizer is dropped and
                # the run starts from fresh moments and a fresh schedule
                if (opt is not None and opt_state is not None
                        and _opt_state_fits(opt, opt_state)):
                    opt.load_state_dict(opt_state)
                    sched_state = ckpt.get("extra", {}).get("sched_state")
                    if sched is not None and sched_state is not None:
                        sched.load_state_dict(sched_state)
                start_epoch = int(ckpt.get("epoch", 0))

        epoch_rows = hasattr(wrapper, "epoch_xs") and hasattr(
            wrapper, "make_batch")
        refresh = getattr(wrapper, "refresh_per_epoch", False)
        # under the epoch protocol the batch list is never read; building it
        # would spend one of the sampler's shuffles
        batches = None if epoch_rows else wrapper.train_batches(graph)
        monitor = getattr(wrapper, "eval_metric", cfg.monitor)
        sign = 1.0 if getattr(wrapper, "eval_mode", cfg.monitor_mode) == "max" else -1.0
        best = -np.inf
        best_snap = _snapshot(model, opt, sched)
        best_epoch = 0
        nan_rollbacks = 0
        step_ms, eval_ms = [], []
        train_loss = float("nan")
        t0 = time.time()
        for stage in range(getattr(wrapper, "num_stages", 1)):
            if hasattr(wrapper, "pre_stage"):
                # the multi-stage contract (SAGN, M3S self-training): the
                # hook sees the best snapshot's weights, as the JAX trainer
                # passes its best parameters; training goes on from the
                # current ones
                upd = _with_weights(model, best_snap,
                                    lambda: wrapper.pre_stage(stage, graph))
                if upd is not None:
                    graph = upd
                    if not epoch_rows:
                        batches = wrapper.train_batches(graph)
            patience_left = cfg.patience
            for epoch in range(start_epoch if stage == 0 else 0, cfg.epochs):
                t_step = time.perf_counter()
                if epoch_rows:
                    losses = [self.train_step(wrapper, opt, sched,
                                              wrapper.make_batch(graph, x),
                                              generator)
                              for x in wrapper.epoch_xs(graph)]
                else:
                    if refresh and epoch > 0:
                        batches = wrapper.train_batches(graph)
                    losses = [self.train_step(wrapper, opt, sched, b,
                                              generator)
                              for b in batches]
                if (epoch + 1) % cfg.eval_step == 0:
                    # float() waits for the device, so this clock spans the
                    # steps
                    train_loss = float(torch.stack(losses).mean())
                    t_eval = time.perf_counter()
                    step_ms.append((t_eval - t_step) * 1e3 / len(losses))
                    if cfg.nan_guard:
                        if not np.isfinite(train_loss):
                            # consecutive failures only — a recovered blip
                            # resets
                            nan_rollbacks += 1
                            if nan_rollbacks > cfg.nan_guard_retries:
                                raise RuntimeError(
                                    f"training diverged: non-finite loss at "
                                    f"epoch {epoch} persisted through "
                                    f"{cfg.nan_guard_retries} rollbacks "
                                    "(lower lr / enable grad_clip)")
                            _restore(model, opt, sched, best_snap)
                            print(f"nan_guard: non-finite loss at epoch "
                                  f"{epoch}; rolled back to epoch "
                                  f"{best_epoch} snapshot "
                                  f"({nan_rollbacks}/{cfg.nan_guard_retries})")
                            continue
                        nan_rollbacks = 0
                    metrics = wrapper.evaluate(graph)
                    if monitor not in metrics:
                        raise KeyError(
                            f"early-stop monitor {monitor!r} not in eval "
                            f"metrics {sorted(metrics)}")
                    score = float(metrics[monitor]) * sign
                    eval_ms.append((time.perf_counter() - t_eval) * 1e3)
                    if score > best:
                        best = score
                        best_snap = _snapshot(model, opt, sched)
                        best_epoch = epoch
                        patience_left = cfg.patience
                    else:
                        patience_left -= cfg.eval_step
                        if patience_left <= 0:
                            break
                # every 20th epoch whatever eval_step is: the mean over the
                # epoch's steps under the epoch protocol, else the last
                # batch's loss (cogdl_tpu/trainer/trainer.py:357,411-413)
                if cfg.progress and epoch % 20 == 0:
                    shown = (torch.stack(losses).mean() if epoch_rows
                             else losses[-1])
                    print(f"epoch {epoch}: loss={float(shown):.4f}")
            if hasattr(wrapper, "post_stage"):
                _with_weights(model, best_snap,
                              lambda: wrapper.post_stage(stage, graph))

        if cfg.checkpoint_path:
            from .checkpoint import save_checkpoint

            save_checkpoint(cfg.checkpoint_path, best_snap[0],
                            opt_state=best_snap[1], epoch=best_epoch,
                            extra={"sched_state": best_snap[2]})
        _restore(model, opt, sched, best_snap)
        final = wrapper.evaluate(graph)
        result: Dict[str, Any] = {k: float(v) for k, v in final.items()}
        result["best_epoch"] = best_epoch
        result["train_loss"] = train_loss   # at the last eval point
        result["train_time"] = time.time() - t0
        # wall-clock medians over the eval points (each ends in a device sync)
        result["train_step_ms"] = float(np.median(step_ms)) if step_ms else float("nan")
        result["eval_ms"] = float(np.median(eval_ms)) if eval_ms else float("nan")
        if getattr(wrapper, "stage_record", None):
            # what a staged wrapper did at each stage (labels it added)
            result["stages"] = wrapper.stage_record
        result["_variables"] = best_snap[0]
        result["_graph"] = graph   # the prepared frame
        return result
