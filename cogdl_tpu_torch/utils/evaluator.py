"""Losses and metrics — the port of ``cogdl_tpu/utils/evaluator.py``: the
losses, ``masked_accuracy`` and the accumulating evaluators (``Accuracy``,
``MultiLabelMicroF1``, ``MAE``, ``build_evaluator``). All are mask-aware:
masks handle both the splits and node padding. Beside them, the two scores
the link-prediction and clustering wrappers take from scikit-learn in the
JAX package, ``roc_auc_score`` and ``normalized_mutual_info``, in float64
numpy."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    if labels.ndim == logits.ndim:  # one-hot / soft labels
        return -(labels * logp).sum(-1).mean()
    return -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1).mean()


def masked_cross_entropy(logits, labels, mask) -> torch.Tensor:
    """Mean cross-entropy over the masked nodes."""
    logp = F.log_softmax(logits, dim=-1)
    if labels.ndim == logits.ndim:
        per_node = -(labels * logp).sum(-1)
    else:
        safe = labels.long().clamp(0, logits.shape[-1] - 1)
        per_node = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    m = mask.to(logits.dtype)
    return (per_node * m).sum() / m.sum().clamp_min(1.0)


def bce_with_logits_loss(logits, targets, mask=None) -> torch.Tensor:
    per = (logits.clamp_min(0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    if mask is not None:
        m = mask.to(logits.dtype)
        if m.ndim < per.ndim:
            m = m.reshape(m.shape + (1,) * (per.ndim - m.ndim))
        return (per * m).sum() / m.expand_as(per).sum().clamp_min(1.0)
    return per.mean()


def bce_logits(logit: torch.Tensor, target) -> torch.Tensor:
    """``max(l, 0) − l·y + log(1 + e^{−|l|})`` elementwise, the JAX
    wrappers' form, with JAX's gradient where a logit is exactly 0
    (``jnp.maximum`` splits it, the derivative of ``jnp.abs`` there is 1):
    a ConvE scorer starts with every logit at 0."""
    mag = torch.where(logit >= 0, logit, -logit)
    return (torch.maximum(logit, torch.zeros_like(logit)) - logit * target
            + torch.log1p(torch.exp(-mag)))


def masked_accuracy(logits, labels, mask) -> torch.Tensor:
    pred = logits.argmax(-1)
    m = mask.float()
    correct = (pred == labels.long()).float() * m
    return correct.sum() / m.sum().clamp_min(1.0)


# -- ranking and clustering scores (scikit-learn's, without scikit-learn) -----

def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of binary ``y_true`` (1 positive, 0
    negative) against ``y_score``, as ``sklearn.metrics.roc_auc_score``
    gives it: the Mann-Whitney statistic, a positive scored level with a
    negative counting ½, from mid-ranks in float64. Raises when one class
    is absent, as scikit-learn does."""
    y = np.asarray(y_true).reshape(-1) != 0
    s = np.asarray(y_score, np.float64).reshape(-1)
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc_score: only one class present in y_true")
    order = np.argsort(s, kind="stable")
    ss = s[order]
    # each run of equal scores takes the mean of its 1-based ranks
    starts = np.flatnonzero(np.r_[True, ss[1:] != ss[:-1]])
    ends = np.r_[starts[1:], ss.size]
    ranks = np.empty(s.size, np.float64)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    u = ranks[y].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def _entropy(labels: np.ndarray) -> float:
    if labels.size == 0:
        return 1.0
    pi = np.bincount(np.unique(labels, return_inverse=True)[1]).astype(
        np.float64)
    pi = pi[pi > 0]
    if pi.size == 1:
        return 0.0
    total = pi.sum()
    return float(-np.sum((pi / total) * (np.log(pi) - math.log(total))))


def normalized_mutual_info(labels_true, labels_pred) -> float:
    """Normalised mutual information of two labellings, over the arithmetic
    mean of their entropies: ``sklearn.metrics.normalized_mutual_info_score``
    at its default ``average_method="arithmetic"``, its edge cases
    included (one cluster on both sides, or none, gives 1.0; a mutual
    information of 0 gives 0.0)."""
    a = np.asarray(labels_true).reshape(-1)
    b = np.asarray(labels_pred).reshape(-1)
    if a.shape != b.shape:
        raise ValueError(f"normalized_mutual_info: {a.shape} against "
                         f"{b.shape} labels")
    classes, ia = np.unique(a, return_inverse=True)
    clusters, ib = np.unique(b, return_inverse=True)
    if classes.size == clusters.size and classes.size in (0, 1):
        return 1.0
    if classes.size == 1 or clusters.size == 1:
        return 0.0
    # the non-zero cells of the contingency table, row-major
    cell, nz = np.unique(ia * clusters.size + ib, return_counts=True)
    nzx, nzy = cell // clusters.size, cell % clusters.size
    nz = nz.astype(np.float64)
    pi = np.bincount(ia).astype(np.float64)
    pj = np.bincount(ib).astype(np.float64)
    n = float(a.size)
    outer = pi[nzx].astype(np.int64) * pj[nzy].astype(np.int64)
    log_outer = -np.log(outer) + math.log(pi.sum()) + math.log(pj.sum())
    p = nz / n
    mi = p * (np.log(nz) - math.log(n)) + p * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    mi = float(np.clip(mi.sum(), 0.0, None))
    if mi == 0:
        return 0.0
    return float(mi / np.mean([_entropy(a), _entropy(b)]))


# ---------------------------------------------------------------------------
# Accumulating evaluators
# ---------------------------------------------------------------------------

def _mask_like(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    m = mask.float()
    return m.reshape(tuple(m.shape) + (1,) * (ndim - m.ndim))


class Accuracy:
    """Accuracy summed over calls: the argmax against the labels, over the
    masked rows when a mask is given."""

    def __init__(self):
        self.correct = 0.0
        self.total = 0.0

    def __call__(self, logits, labels, mask=None) -> float:
        ok = (logits.argmax(-1) == labels).float()
        if mask is not None:
            m = mask.float()
            self.correct += float((ok * m).sum())
            self.total += float(m.sum())
        else:
            self.correct += float(ok.sum())
            self.total += float(ok.numel())
        return self.evaluate()

    def evaluate(self) -> float:
        return self.correct / max(self.total, 1.0)

    def clear(self):
        self.correct = self.total = 0.0


class MultiLabelMicroF1:
    """Micro-F1 of multilabel targets summed over calls, a label predicted
    where its logit is above 0 (its sigmoid above 0.5)."""

    def __init__(self):
        self.tp = self.fp = self.fn = 0.0

    def __call__(self, logits, labels, mask=None) -> float:
        pred = (logits > 0).float()
        tgt = labels.float()
        if mask is not None:
            m = _mask_like(mask, pred.ndim)
            pred, tgt = pred * m, tgt * m
        self.tp += float((pred * tgt).sum())
        self.fp += float((pred * (1 - tgt)).sum())
        self.fn += float(((1 - pred) * tgt).sum())
        return self.evaluate()

    def evaluate(self) -> float:
        denom = 2 * self.tp + self.fp + self.fn
        return 2 * self.tp / denom if denom > 0 else 0.0

    def clear(self):
        self.tp = self.fp = self.fn = 0.0


class MAE:
    """Mean absolute error summed over calls (traffic forecasting), over the
    masked rows when a mask is given."""

    def __init__(self):
        self.err = 0.0
        self.total = 0.0

    def __call__(self, pred, target, mask=None) -> float:
        e = (pred - target).abs()
        if mask is not None:
            m = _mask_like(mask, e.ndim)
            self.err += float((e * m).sum())
            self.total += float(m.expand(e.shape).sum())
        else:
            self.err += float(e.sum())
            self.total += float(e.numel())
        return self.evaluate()

    def evaluate(self) -> float:
        return self.err / max(self.total, 1.0)

    def clear(self):
        self.err = self.total = 0.0


def build_evaluator(metric: str):
    """A fresh evaluator by name: ``accuracy`` (or ``acc``), ``microf1`` or
    ``mae``; another name raises ``KeyError``."""
    return {"accuracy": Accuracy, "acc": Accuracy,
            "microf1": MultiLabelMicroF1, "mae": MAE}[metric]()
