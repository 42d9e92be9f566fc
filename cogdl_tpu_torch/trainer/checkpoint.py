"""Checkpoint / resume — the port of ``cogdl_tpu/trainer/checkpoint.py``.
Saves the full training state: the model's ``state_dict``, the optimizer's
``state_dict``, the epoch and, under ``extra``, what the trainer adds (its
learning-rate schedule's ``state_dict`` as ``sched_state``), as host numpy
arrays in one pickle written atomically."""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch


def to_host(tree):
    """Nested dicts/lists/tuples with every tensor turned into numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def to_torch(tree):
    """Inverse of :func:`to_host`: numpy arrays back to tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return tree


def save_checkpoint(path: str, params, opt_state=None, epoch: int = 0,
                    extra: Optional[Dict[str, Any]] = None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "params": to_host(params),
        "opt_state": None if opt_state is None else to_host(opt_state),
        "epoch": epoch,
        "extra": extra or {},
        "format": 1,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint this module wrote (pickle: trusted files only)."""
    with open(path, "rb") as f:
        return pickle.load(f)
