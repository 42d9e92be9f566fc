"""Embedding probes — the port of ``cogdl_tpu/utils/probe.py``'s
``_standardize`` and ``logreg_probe``: a logistic regression fitted on
frozen node embeddings, without scikit-learn.

:func:`logreg_fit` minimises the objective of scikit-learn's
``LogisticRegression()`` (L2, ``C = 1``, an unpenalised intercept):
the cross-entropy averaged over the training rows plus ``‖W‖² / (2·C·n)``,
multinomial over ``K`` columns for more than two classes, one logistic
column for two. The objective is strictly convex, so its minimiser is
unique and the fit converges to scikit-learn's solution, not to a path.

It runs in float64 on the embeddings' device, from zero, by L-BFGS that
asks the host nothing between its checks: the direction from the last
``HISTORY`` steps in the compact form (Byrd, Nocedal and Schnabel 1994:
two small triangular solves, no loop over the pairs), the step the best
of the grid ``STEPS`` (every candidate's objective from one product
``X·d``), the gradient in closed form; on the card a CUDA graph runs
each block of ``CHECK_EVERY`` iterations after the first. After each
block the host reads the gradient's largest entry and stops at ``tol``, or
where the objective no longer falls; it returns the iterations it took
and warns when it stops above ``CONVERGED``. (``torch.optim.LBFGS``
synchronises the card dozens of times an iteration.) ``f1_label_probe``
waits for its callers (ROADMAP.md §1, item 13h).
"""

from __future__ import annotations

import time
import warnings
from typing import Dict

import torch
import torch.nn.functional as F

# LogisticRegression()'s inverse penalty
C = 1.0
# L-BFGS iterations before the fit gives up, and warns, unconverged
MAX_ITER = 20_000
# the largest entry of the objective's gradient the fit runs to, and the
# one below which a fit that stopped earlier (its steps lost in float64
# rounding) still counts as converged
TOL = 1e-8
CONVERGED = 1e-6
# curvature pairs kept, iterations between the host's checks, and the
# step grid 4, 2, 1, 1/2, ..., 2^-9 and 0
HISTORY = 10
CHECK_EVERY = 10
STEPS = [2.0 ** (2 - j) for j in range(12)] + [0.0]


def standardize(emb: torch.Tensor) -> torch.Tensor:
    """Column-standardised ``emb`` in float64: zero mean, unit population
    standard deviation (at least 1e-8), over every row given (the JAX
    probe standardises the padded array, pad rows included)."""
    emb = emb.double()
    mu = emb.mean(0, keepdim=True)
    sd = emb.std(0, unbiased=False, keepdim=True)
    return (emb - mu) / sd.clamp_min(1e-8)


class LogReg:
    """The fitted classifier: ``classes`` (sorted labels seen in training),
    ``coef`` ``[K or 1, F]`` and ``intercept`` ``[K or 1]`` in
    scikit-learn's layout, ``n_iter`` and the final ``grad_max``."""

    def __init__(self, classes, coef, intercept, n_iter, grad_max):
        self.classes = classes
        self.coef = coef
        self.intercept = intercept
        self.n_iter = n_iter
        self.grad_max = grad_max

    def decision_function(self, X: torch.Tensor) -> torch.Tensor:
        z = X.double() @ self.coef.T + self.intercept
        return z[:, 0] if self.coef.shape[0] == 1 else z

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        z = self.decision_function(X)
        idx = (z > 0).long() if z.ndim == 1 else z.argmax(1)
        return self.classes[idx]


class Objective:
    """The objective of ``X`` ``[n, F]`` and labels ``y`` over ``theta``
    ``[F + 1, cols]`` (the coefficients over the intercept row), as
    functions of the scores ``Z = Xa·theta``: the data term of a batch of
    score matrices, the penalty, and the gradient."""

    def __init__(self, X: torch.Tensor, y: torch.Tensor):
        X = X.double()
        n = X.shape[0]
        self.classes, t = torch.unique(y, return_inverse=True)
        K = self.classes.numel()
        if K < 2:
            raise ValueError(f"logreg_fit needs at least two classes in the "
                             f"training rows; got {K}")
        self.binary = K == 2
        self.cols = 1 if self.binary else K
        self.Xa = torch.cat([X, X.new_ones(n, 1)], 1)
        self.scale = 1.0 / (C * n)
        if self.binary:
            self.t = (t.double() * 2.0 - 1.0)[:, None]     # ±1
        else:
            self.onehot = F.one_hot(t, K).double()
            self.idx = t

    def data(self, Z: torch.Tensor) -> torch.Tensor:
        """The mean loss of each ``[..., n, cols]`` score matrix."""
        if self.binary:
            return F.softplus(-self.t * Z).mean((-2, -1))
        picked = Z.gather(-1, self.idx.expand(Z.shape[:-1])[..., None])
        return (torch.logsumexp(Z, -1) - picked[..., 0]).mean(-1)

    def penalty(self, theta: torch.Tensor) -> torch.Tensor:
        return 0.5 * self.scale * (theta[:-1] ** 2).sum()

    def __call__(self, theta: torch.Tensor) -> torch.Tensor:
        return self.data(self.Xa @ theta) + self.penalty(theta)

    def grad(self, Z: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        if self.binary:
            r = -self.t * torch.sigmoid(-self.t * Z)
        else:
            r = torch.softmax(Z, -1) - self.onehot
        g = self.Xa.T @ r / Z.shape[0]
        g[:-1] += self.scale * theta[:-1]
        return g


def _direction(g, S, Y, used, gamma):
    """``−H·g`` for the L-BFGS inverse Hessian of the pairs ``S``, ``Y``
    (``[m, d]``, newest first; unused rows zero and ``used`` 0 there) in
    the compact form, the initial matrix ``gamma·I``."""
    a, b = S @ g, Y @ g
    SY = S @ Y.T
    R = torch.triu(SY) + torch.diag(1.0 - used)
    u = torch.linalg.solve_triangular(R, a[:, None], upper=True)
    w = (torch.diag(torch.diagonal(SY)) + gamma * (Y @ Y.T)) @ u \
        - gamma * b[:, None]
    v1 = torch.linalg.solve_triangular(R.T, w, upper=False)
    return -(gamma * g + S.T @ v1[:, 0] - gamma * (Y.T @ u[:, 0]))


def _iterate(obj: Objective, steps: torch.Tensor, st: Dict[str, torch.Tensor]):
    """One L-BFGS iteration, in place on the state ``st``: ``theta``, its
    scores ``Z``, objective ``f`` and gradient ``g``, the pairs ``S``,
    ``Y`` and ``used``, and ``gamma``. It asks the host nothing, so a CUDA
    graph can record it."""
    theta, Z, g, S, Y, used = (st[k] for k in ("theta", "Z", "g", "S", "Y",
                                               "used"))
    D = _direction(g.reshape(-1), S, Y, used, st["gamma"]).reshape(
        theta.shape)
    # every step of the grid at once: the scores Z + s·(Xa·D) and the
    # penalty's quadratic in s
    cand = Z[None] + steps[:, None, None] * (obj.Xa @ D)[None]
    r, dr = theta[:-1], D[:-1]
    pen = 0.5 * obj.scale * ((r * r).sum() + 2 * steps * (r * dr).sum()
                             + steps ** 2 * (dr * dr).sum())
    fs = obj.data(cand) + pen
    j = torch.argmin(fs).reshape(1)
    step = steps.index_select(0, j) * D
    theta_new = theta + step
    Z_new = cand.index_select(0, j)[0]
    g_new = obj.grad(Z_new, theta_new)
    s, yv = step.reshape(-1), (g_new - g).reshape(-1)
    sy = s @ yv
    ok = sy > 0              # a zero step keeps the pairs as they are
    new = {"theta": theta_new, "Z": Z_new, "f": fs.index_select(0, j)[0],
           "g": g_new,
           "S": torch.where(ok, torch.cat([s[None], S[:-1]]), S),
           "Y": torch.where(ok, torch.cat([yv[None], Y[:-1]]), Y),
           "used": torch.where(ok, torch.cat([used.new_ones(1), used[:-1]]),
                               used),
           "gamma": torch.where(ok, sy / (yv @ yv), st["gamma"])}
    for k, v in new.items():
        st[k].copy_(v)


def _recorded(block, dev: torch.device) -> "torch.cuda.CUDAGraph":
    """Run ``block`` once on a side stream (the warm-up a CUDA graph
    needs), then record it, unrun, into a graph whose every replay runs it
    again."""
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        block()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        block()
    return graph


def logreg_fit(X: torch.Tensor, y: torch.Tensor, max_iter: int = MAX_ITER,
               tol: float = TOL) -> LogReg:
    """Fit scikit-learn's ``LogisticRegression()`` objective on ``X``
    ``[n, F]`` and labels ``y`` ``[n]`` in float64 on their device. On
    the card the first ``CHECK_EVERY`` iterations run as they are and are
    recorded into a CUDA graph, which runs each later block of them: the
    host then enqueues one graph a block, not some 90 operations an
    iteration."""
    obj = Objective(X, y)
    dev = obj.Xa.device
    steps = torch.tensor(STEPS, dtype=torch.float64, device=dev)
    theta = torch.zeros((obj.Xa.shape[1], obj.cols), dtype=torch.float64,
                        device=dev)
    Z = obj.Xa @ theta
    g = obj.grad(Z, theta)
    S = torch.zeros(HISTORY, theta.numel(), dtype=torch.float64, device=dev)
    # the first step's scale: a unit step along the unit gradient
    st = {"theta": theta, "Z": Z, "f": obj.data(Z) + obj.penalty(theta),
          "g": g, "S": S, "Y": torch.zeros_like(S),
          "used": torch.zeros(HISTORY, dtype=torch.float64, device=dev),
          "gamma": 1.0 / g.norm().clamp_min(1e-300)}

    def block():
        for _ in range(CHECK_EVERY):
            _iterate(obj, steps, st)

    graph = None
    n_iter, f_checked = 0, float("inf")
    grad_max = float(g.abs().max())
    while grad_max > tol and n_iter < max_iter:
        if graph is not None:
            graph.replay()
        elif dev.type == "cuda":
            graph = _recorded(block, dev)
        else:
            block()
        n_iter += CHECK_EVERY
        grad_max, f_now = float(st["g"].abs().max()), float(st["f"])
        if not f_now < f_checked:
            break            # the objective stopped falling: float64's floor
        f_checked = f_now
    if not grad_max <= max(tol, CONVERGED):
        warnings.warn(f"logreg_fit: the gradient's largest entry is "
                      f"{grad_max:.3g} after {n_iter} L-BFGS iterations, "
                      f"above {max(tol, CONVERGED):g} (not converged)",
                      RuntimeWarning)
    theta = st["theta"]
    return LogReg(obj.classes, theta[:-1].T.contiguous(), theta[-1].clone(),
                  n_iter, grad_max)



def logreg_probe(emb: torch.Tensor, graph) -> Dict[str, float]:
    """Standardise ``emb`` (:func:`standardize`), fit on the real train
    nodes, and report ``train_acc`` / ``val_acc`` / ``test_acc`` over each
    split's real nodes, with the fit's ``probe_iters`` and the probe's own
    ``probe_ms`` (the card synchronised before and after)."""
    if emb.device.type == "cuda":
        torch.cuda.synchronize(emb.device)
    t0 = time.perf_counter()
    X = standardize(emb)
    node_m = graph.node_mask()
    tr = graph.train_mask & node_m
    clf = logreg_fit(X[tr], graph.y[tr])
    out = {}
    for split, m in (("train", graph.train_mask), ("val", graph.val_mask),
                     ("test", graph.test_mask)):
        if m is None:
            continue
        mask = m & node_m
        n = int(mask.sum())
        if n == 0:
            continue
        pred = clf.predict(X[mask])
        out[f"{split}_acc"] = float((pred == graph.y[mask]).sum()) / n
    out["probe_iters"] = clf.n_iter
    out["probe_ms"] = (time.perf_counter() - t0) * 1e3
    return out
