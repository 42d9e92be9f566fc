"""KMeans in torch, on the card or the CPU — the port's stand-in for
scikit-learn's ``KMeans(n_clusters, n_init, random_state)``, which the JAX
package calls in ``cogdl_tpu/wrappers/staged.py`` (M3S) and
``wrappers/clustering.py`` and which the card's machine does not have.

The algorithm is scikit-learn's: greedy k-means++ seeding (``2 +
int(log k)`` candidates a centre, drawn in proportion to the squared
distance to the nearest chosen centre), then Lloyd iterations until the
labels stop changing or the centres move, in squared distance summed over
the centres, no more than ``tol`` times the mean of the features'
variances, for at most ``max_iter`` iterations; a last assignment to the
final centres; and the best of ``n_init`` runs by inertia. Every draw
comes from an explicit ``torch.Generator`` on the data's device. The
labels are not scikit-learn's draw for draw: the tests hold them equal up
to a relabelling on well-separated blobs, and the inertia within 1% of
scikit-learn's on a trained GCN's embeddings."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class KMeansResult(NamedTuple):
    labels: torch.Tensor     # int64 [n]
    centers: torch.Tensor    # [n_clusters, d]
    inertia: float           # Σ of squared distances to the own centre
    n_iter: int              # Lloyd iterations of the best run


def squared_distances(x: torch.Tensor, centers: torch.Tensor,
                      x_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[n, k]`` squared Euclidean distances, ``|x|² − 2x·c + |c|²``
    floored at 0."""
    if x_sq is None:
        x_sq = (x * x).sum(1)
    d = x_sq[:, None] - 2.0 * (x @ centers.T) + (centers * centers).sum(1)
    return d.clamp_min_(0.0)


def kmeans_plusplus(x: torch.Tensor, n_clusters: int,
                    generator: Optional[torch.Generator] = None,
                    x_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scikit-learn's greedy k-means++: the first centre uniform, each next
    the best, by the potential it leaves, of ``2 + int(log k)`` candidates
    drawn in proportion to the squared distance to the nearest centre."""
    n, device = x.shape[0], x.device
    trials = 2 + int(math.log(n_clusters))
    first = torch.randint(n, (1,), generator=generator, device=device)
    centers = [x[first[0]]]
    closest = squared_distances(x, x[first], x_sq)[:, 0]
    potential = closest.sum(dtype=torch.float64)
    for _ in range(1, n_clusters):
        draws = torch.rand(trials, generator=generator, device=device,
                           dtype=torch.float64) * potential
        cand = torch.searchsorted(torch.cumsum(closest, 0, dtype=torch.float64),
                                  draws).clamp_max_(n - 1)
        dist = torch.minimum(closest[None, :],
                             squared_distances(x, x[cand], x_sq).T)
        pots = dist.sum(1, dtype=torch.float64)
        best = int(torch.argmin(pots))
        centers.append(x[cand[best]])
        closest, potential = dist[best], pots[best]
    return torch.stack(centers)


def _update_centers(x: torch.Tensor, labels: torch.Tensor,
                    centers: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Each centre the mean of its points; an empty cluster takes the point
    farthest from its own centre among those not taken yet, as
    scikit-learn relocates it."""
    k = centers.shape[0]
    counts = torch.bincount(labels, minlength=k)
    sums = torch.zeros_like(centers).index_add_(0, labels, x)
    new = sums / counts.clamp_min(1).unsqueeze(1).to(x.dtype)
    empty = torch.nonzero(counts == 0).flatten()
    if empty.numel():
        far = torch.argsort(dist.gather(1, labels[:, None])[:, 0],
                            descending=True)[: empty.numel()]
        new[empty] = x[far]
    return new


def kmeans(x: torch.Tensor, n_clusters: int, n_init: int = 3,
           max_iter: int = 300, tol: float = 1e-4,
           generator: Optional[torch.Generator] = None,
           seed: int = 0) -> KMeansResult:
    """Cluster the rows of ``x`` (``[n, d]``) into ``n_clusters``, on
    ``x``'s device: the best of ``n_init`` seeded runs by inertia. Draws
    come from ``generator``, or a generator on ``x``'s device seeded with
    ``seed``."""
    if not 1 <= n_clusters <= x.shape[0]:
        raise ValueError(f"kmeans: n_clusters={n_clusters} for "
                         f"{x.shape[0]} points")
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(seed)
    x = x.detach()
    x_sq = (x * x).sum(1)
    tol = float(x.var(0, unbiased=False).mean()) * tol
    best = None
    for _ in range(n_init):
        centers = kmeans_plusplus(x, n_clusters, generator, x_sq)
        labels = None
        n_iter, converged = 0, False
        for n_iter in range(1, max_iter + 1):
            dist = squared_distances(x, centers, x_sq)
            new_labels = dist.argmin(1)
            new_centers = _update_centers(x, new_labels, centers, dist)
            shift = float(((new_centers - centers) ** 2).sum())
            centers = new_centers
            if labels is not None and torch.equal(new_labels, labels):
                converged = True
                break
            labels = new_labels
            if shift <= tol:
                break
        if not converged:
            labels = squared_distances(x, centers, x_sq).argmin(1)
        dist = squared_distances(x, centers, x_sq)
        inertia = float(dist.gather(1, labels[:, None]).sum(
            dtype=torch.float64))
        if best is None or inertia < best.inertia:
            best = KMeansResult(labels, centers, inertia, n_iter)
    return best
