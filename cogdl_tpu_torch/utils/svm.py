"""A support vector classifier without scikit-learn — what
``InfoGraphWrapper.evaluate`` (``cogdl_tpu/wrappers/graph_classification.py:127-143``)
asks of ``cross_val_score(SVC(), X, y, cv=3)``.

* :func:`stratified_kfold` assigns the folds as scikit-learn's
  ``StratifiedKFold(n_splits)`` without shuffling: classes in order of
  first appearance, each fold's share of a class from a round robin over
  the sorted labels, and each class's samples given to the folds in
  blocks, in data order.
* :class:`SVC` is ``SVC()``: the RBF kernel with ``gamma="scale"``
  (``1 / (n_features · X.var())`` of the training rows), ``C = 1``,
  one-vs-one for more than two classes with libsvm's vote. Each binary
  problem's dual is solved by SMO with libsvm's second-order working-set
  selection (Fan, Chen and Lin, JMLR 2005) to its stopping tolerance
  ``1e-3``, without shrinking; the bias is the mean of ``y·∇`` over the
  free support vectors (the middle of the bounds without one).
* :func:`cross_val_accuracy` is ``cross_val_score``'s per-fold accuracy.

It runs on the host in float64 numpy by design: SMO is a long chain of
small dependent steps (two kernel columns and an argmax over the samples
each), which the host runs without a launch or a synchronisation a step;
the card computes the embeddings it is fitted on. Nothing here gives way
to another route.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

TAU = 1e-12
# SVC()'s penalty and libsvm's stopping tolerance
C = 1.0
EPS = 1e-3


def stratified_kfold(y, n_splits: int = 3) -> np.ndarray:
    """The test fold of each sample under ``StratifiedKFold(n_splits)``
    (no shuffle): ``int`` ``[n]``. Raises if a split would get no sample
    of any class (scikit-learn raises when every class is smaller than
    ``n_splits``)."""
    y = np.asarray(y).ravel()
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    # classes in order of first appearance
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits],
                                         minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype=np.int64)
    for k in range(n_classes):
        test_folds[y_encoded == k] = np.arange(n_splits).repeat(
            allocation[:, k])
    return test_folds


def rbf_kernel(A: np.ndarray, B: np.ndarray, gamma: float) -> np.ndarray:
    """``exp(-gamma·‖a − b‖²)`` for every row pair, float64."""
    sq = ((A * A).sum(1)[:, None] + (B * B).sum(1)[None, :]
          - 2.0 * (A @ B.T))
    return np.exp(-gamma * np.maximum(sq, 0.0))


def smo(K: np.ndarray, y: np.ndarray, C: float = C, eps: float = EPS,
        max_iter: int = 10_000_000) -> Tuple[np.ndarray, float, int]:
    """Solve ``min ½ αᵀQα − Σα`` s.t. ``yᵀα = 0``, ``0 ≤ α ≤ C``, ``Q =
    (y yᵀ) ∘ K``, as libsvm's ``Solver::Solve`` does (second-order working
    set, no shrinking). ``y`` is ±1. Returns ``(alpha, rho, iterations)``;
    the decision function is ``Σ αᵢ yᵢ K(xᵢ, x) − rho``."""
    n = y.shape[0]
    y = y.astype(np.float64)
    alpha = np.zeros(n)
    G = -np.ones(n)
    QD = np.diag(K).copy()
    it = 0
    while it < max_iter:
        pos = y > 0
        up = np.where(pos, alpha < C, alpha > 0)     # may move up
        low = np.where(pos, alpha > 0, alpha < C)    # may move down
        yG = -y * G
        cand = np.where(up, yG, -np.inf)
        # libsvm keeps the last of equal candidates (its ">=" / "<=")
        i = n - 1 - int(np.argmax(cand[::-1]))
        gmax = cand[i]
        mg = np.where(low, -yG, -np.inf)             # y_t·G_t over I_low
        gmax2 = mg.max() if low.any() else -np.inf
        if gmax + gmax2 < eps:
            break
        b = gmax + mg                                # grad_diff, -inf off I_low
        quad = QD[i] + QD - 2.0 * K[i]
        quad = np.where(quad > 0, quad, TAU)
        obj = np.where(low & (b > 0), -(b * b) / quad, np.inf)
        j = n - 1 - int(np.argmin(obj[::-1]))
        if not np.isfinite(obj[j]):
            break
        it += 1
        Ki, Kj = K[i], K[j]
        yi, yj = y[i], y[j]
        ai, aj = alpha[i], alpha[j]
        Qij = yi * yj * Ki[j]
        if yi != yj:
            qc = QD[i] + QD[j] + 2.0 * Qij
            qc = qc if qc > 0 else TAU
            delta = (-G[i] - G[j]) / qc
            diff = ai - aj
            ni, nj = ai + delta, aj + delta
            if diff > 0:
                if nj < 0:
                    nj, ni = 0.0, diff
            elif ni < 0:
                ni, nj = 0.0, -diff
            if diff > 0:                              # C_i - C_j = 0
                if ni > C:
                    ni, nj = C, C - diff
            elif nj > C:
                nj, ni = C, C + diff
        else:
            qc = QD[i] + QD[j] - 2.0 * Qij
            qc = qc if qc > 0 else TAU
            delta = (G[i] - G[j]) / qc
            s = ai + aj
            ni, nj = ai - delta, aj + delta
            if s > C:
                if ni > C:
                    ni, nj = C, s - C
            elif nj < 0:
                nj, ni = 0.0, s
            if s > C:
                if nj > C:
                    nj, ni = C, s - C
            elif ni < 0:
                ni, nj = 0.0, s
        alpha[i], alpha[j] = ni, nj
        # G_k += Q_ki·Δα_i + Q_kj·Δα_j
        G += y * (Ki * (yi * (ni - ai)) + Kj * (yj * (nj - aj)))
    # the bias (libsvm calculate_rho)
    yG = y * G
    upper = alpha >= C
    lower = alpha <= 0
    free = ~upper & ~lower
    if free.any():
        rho = float(yG[free].mean())
    else:
        ub_mask = (upper & (y < 0)) | (lower & (y > 0))
        lb_mask = (upper & (y > 0)) | (lower & (y < 0))
        ub = yG[ub_mask].min() if ub_mask.any() else np.inf
        lb = yG[lb_mask].max() if lb_mask.any() else -np.inf
        rho = float((ub + lb) / 2)
    return alpha, rho, it


class SVC:
    """``sklearn.svm.SVC()`` (RBF, ``gamma="scale"``, ``C=1``), fitted by
    :func:`smo` on the host in float64."""

    def fit(self, X, y) -> "SVC":
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        var = X.var()
        self.gamma = 1.0 / (X.shape[1] * var) if var != 0 else 1.0
        self.classes_ = np.unique(y)
        if self.classes_.size < 2:
            raise ValueError("SVC needs at least two classes")
        self.X_ = X
        K = rbf_kernel(X, X, self.gamma)
        # one problem a class pair (i < j): class i is +1, class j is -1
        self.pairs_: List[Tuple[int, int, np.ndarray, np.ndarray, float]] = []
        self.n_iter_ = []
        for a in range(self.classes_.size):
            for b in range(a + 1, self.classes_.size):
                idx = np.nonzero((y == self.classes_[a])
                                 | (y == self.classes_[b]))[0]
                yy = np.where(y[idx] == self.classes_[a], 1.0, -1.0)
                alpha, rho, it = smo(K[np.ix_(idx, idx)], yy)
                sv = alpha > 0
                self.pairs_.append((a, b, idx[sv], alpha[sv] * yy[sv], rho))
                self.n_iter_.append(it)
        return self

    def _ovo(self, X) -> np.ndarray:
        """libsvm's one-vs-one values ``[n, pairs]``, positive for the
        pair's first class."""
        X = np.asarray(X, np.float64)
        return np.stack([rbf_kernel(X, self.X_[sv], self.gamma) @ coef - rho
                         for _, _, sv, coef, rho in self.pairs_], 1)

    def decision_function(self, X) -> np.ndarray:
        """The one-vs-one values; for two classes scikit-learn's ``[n]``,
        positive for ``classes_[1]``."""
        dec = self._ovo(X)
        return -dec[:, 0] if self.classes_.size == 2 else dec

    def predict(self, X) -> np.ndarray:
        """libsvm's vote over the pairs, ties to the lower class."""
        dec = self._ovo(X)
        votes = np.zeros((dec.shape[0], self.classes_.size), np.int64)
        for p, (a, b, *_rest) in enumerate(self.pairs_):
            win = dec[:, p] > 0
            votes[:, a] += win
            votes[:, b] += ~win
        return self.classes_[votes.argmax(1)]


def cross_val_accuracy(X, y, cv: int = 3) -> np.ndarray:
    """Each fold's test accuracy of :class:`SVC` trained on the other
    folds, the folds of :func:`stratified_kfold` — ``cross_val_score(SVC(),
    X, y, cv=cv)``."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y)
    folds = stratified_kfold(y, cv)
    scores = []
    for k in range(cv):
        test = folds == k
        clf = SVC().fit(X[~test], y[~test])
        scores.append(float((clf.predict(X[test]) == y[test]).mean()))
    return np.asarray(scores)
