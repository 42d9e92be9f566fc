"""Recommendation — the port of ``cogdl_tpu/wrappers/recommendation.py``
(``RecommendationWrapper``): LightGCN's embeddings trained with the BPR
loss over random training interactions and random items, evaluated by
recall@k and NDCG@k over every user with a held-out item.

The held-out items are the dataset's official test positives
(``Dataset.eval_user_items``, the graph then holding the training
interactions only), else the last item (highest id) of every user with
more than one, removed from the graph in both directions. The JAX wrapper
finds those edges with a loop over every edge on the host; here it is
vectorised over sorted ``(user, item)`` keys, the same kept edges and the
same graph.

The step's draws come from ``draws(graph, generator)`` (4096 edge slots of
the prepared graph and 4096 items, drawn on the graph's device) and the
loss is ``loss_at(graph, draws)``: a caller holds the loss at draws of its
own, as the tests hold it at the JAX package's.

The evaluation scores users in chunks on the embeddings' device (the JAX
wrapper's ``U @ itemsᵀ`` is 4.8 GB at yelp2018's 31,668 × 38,048), masks
the items each user has in the graph, and takes ``torch.topk``; recall and
NDCG are then summed on the host in float64 in the JAX loop's order. They
equal the JAX wrapper's wherever no two of a user's top ``k + 1`` scores
tie (``np.argsort`` and ``torch.topk`` may order ties otherwise).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.graph import Graph, from_coo
from .node_classification import NodeClfWrapper, apply_adj_norm

BPR_BATCH = 4096
# scores a chunk of users holds on the device: 2²⁷ floats, 512 MB
SCORE_CHUNK = 1 << 27


def held_out_last(row: np.ndarray, col: np.ndarray, num_users: int,
                  num_nodes: int) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """The JAX wrapper's hold-out over the edges ``(row, col)``: for each
    user (a row below ``num_users``) with more than one distinct item, its
    highest item. Returns ``(users, items, keep)``: the held-out pairs in
    ascending user order and the mask of the edges that stay, every edge
    of a held-out pair removed in both directions."""
    ui = row < num_users
    keys = np.unique(row[ui] * num_nodes + col[ui])
    users = keys // num_nodes
    last = np.r_[users[1:] != users[:-1], True]
    first = np.r_[True, users[1:] != users[:-1]]
    held = keys[last & ~first]            # users with two items or more
    keep = ~(np.isin(row * num_nodes + col, held)
             | np.isin(col * num_nodes + row, held))
    return held // num_nodes, held % num_nodes, keep


class RecommendationWrapper:
    eval_metric = "val_recall"
    eval_mode = "max"

    def __init__(self, model, dataset=None, num_neg: int = 1, topk: int = 20,
                 seed: int = 0):
        self.model = model
        self.dataset = dataset
        self.topk = topk
        self.seed = seed

    # -- data ---------------------------------------------------------------
    def prepare_graph(self, graph: Graph) -> Graph:
        """The hold-out (or the official positives) on the host, then the
        training graph on ``graph``'s device under the model's
        normalisation, with the kernels' structure there on the card; and
        the evaluation's users, their targets and the items they have in
        the graph, as index tensors on that device."""
        device = graph.device
        nu = int(graph.meta_get("num_users"))
        self.num_users, self.num_items = nu, graph.num_nodes - nu
        E, N = graph.num_edges, graph.num_nodes
        row = graph.row[:E].cpu().numpy().astype(np.int64)
        col = graph.col[:E].cpu().numpy().astype(np.int64)
        official = getattr(self.dataset, "eval_user_items", None)
        if official:
            pos = {int(u): np.asarray(i, np.int64)
                   for u, i in official.items() if len(i)}
        else:
            users, items, keep = held_out_last(row, col, nu, N)
            pos = {int(u): np.asarray([i - nu]) for u, i in zip(users, items)}
            if not keep.all():
                row, col = row[keep], col[keep]
                graph = from_coo(np.stack([row, col]), num_nodes=N,
                                 n_pad=graph.n_pad, e_pad=graph.e_pad,
                                 bucket=False, meta=dict(graph.meta)).to(
                                     device)
        self._eval_index(pos, row, col, device)
        return NodeClfWrapper.with_structure(apply_adj_norm(self.model, graph))

    def _eval_index(self, pos: Dict[int, np.ndarray], row, col, device):
        """The evaluation's users (ascending), the count of each one's
        targets (repeats counted, as the JAX wrapper divides by them), and
        ``(user slot, item)`` pairs of the distinct targets and of the
        items each has in the graph, sorted by slot, with each slot's
        first pair (``*_ptr``)."""
        nu = self.num_users
        users = np.asarray(sorted(pos), np.int64)
        self.eval_users = users
        self.target_count = np.asarray([pos[u].size for u in users], np.int64)

        def pairs(u_of, i_of):
            slot = np.searchsorted(users, u_of)
            ok = slot < users.size
            ok[ok] = users[slot[ok]] == u_of[ok]
            key = np.unique(slot[ok] * self.num_items + i_of[ok])
            slots = key // self.num_items
            ptr = np.searchsorted(slots, np.arange(users.size + 1))
            return (torch.from_numpy(slots).to(device),
                    torch.from_numpy(key % self.num_items).to(device), ptr)

        flat = (np.concatenate([pos[u] for u in users]) if users.size
                else np.zeros(0, np.int64))
        self._targets = pairs(np.repeat(users, self.target_count), flat)
        ui = row < nu
        self._seen = pairs(row[ui], col[ui] - nu)
        self._users_t = torch.from_numpy(users).to(device)

    def train_batches(self, graph: Graph):
        return [graph]

    def init(self, generator: torch.Generator, graph: Graph):
        """LightGCN's table sized for ``graph``, drawn from ``generator``."""
        self.model.reset_parameters(generator, graph)

    # -- steps --------------------------------------------------------------
    def draws(self, graph: Graph, generator: Optional[torch.Generator]):
        """``BPR_BATCH`` edge slots over the graph's real edges and as many
        items, drawn from ``generator`` on the graph's device (the JAX
        wrapper's two ``randint`` draws)."""
        eidx = torch.randint(0, graph.num_edges, (BPR_BATCH,),
                             generator=generator, device=graph.device)
        neg = torch.randint(self.num_users, self.num_users + self.num_items,
                            (BPR_BATCH,), generator=generator,
                            device=graph.device)
        return eidx, neg

    def loss(self, graph: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        return self.loss_at(graph, self.draws(graph, generator), training)

    def loss_at(self, graph: Graph, draws, training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """BPR over the edge slots ``eidx`` (their user side ``row``, their
        positive item ``col``; an item-to-user edge drawn counts in the
        regulariser only) against the items ``neg``, plus ``1e-4`` times
        the squared norms of every drawn row over ``BPR_BATCH``."""
        eidx, neg = draws
        emb = self.model(graph, training=training, generator=generator)
        users = graph.row[eidx].long()
        ue, pe, ne = (emb[users], emb[graph.col[eidx].long()],
                      emb[neg.long()])
        valid = (users < self.num_users).to(emb.dtype)
        bpr = -F.logsigmoid((ue * pe).sum(-1) - (ue * ne).sum(-1))
        reg = 1e-4 * ((ue ** 2).sum() + (pe ** 2).sum()
                      + (ne ** 2).sum()) / eidx.shape[0]
        return (bpr * valid).sum() / valid.sum().clamp_min(1.0) + reg

    @torch.no_grad()
    def top_items(self, emb: torch.Tensor) -> torch.Tensor:
        """``[users, k']`` bool: whether each of a user's top
        ``k' = min(topk, num_items)`` items (best first) is a target, over
        the scores ``u · item`` with the items in the graph at −1e30."""
        nu, ni = self.num_users, self.num_items
        k = min(self.topk, ni)
        items = emb[nu: nu + ni]
        U = emb[self._users_t]
        step = max(1, SCORE_CHUNK // max(ni, 1))
        out = []
        for a in range(0, U.shape[0], step):
            b = min(a + step, U.shape[0])
            scores = U[a:b] @ items.T
            s_slot, s_item, s_ptr = self._seen
            lo, hi = s_ptr[a], s_ptr[b]
            scores[s_slot[lo:hi] - a, s_item[lo:hi]] = -1e30
            top = torch.topk(scores, k, dim=1).indices
            t_slot, t_item, t_ptr = self._targets
            lo, hi = t_ptr[a], t_ptr[b]
            hit = torch.zeros_like(scores, dtype=torch.bool)
            hit[t_slot[lo:hi] - a, t_item[lo:hi]] = True
            out.append(hit.gather(1, top))
        return torch.cat(out) if out else torch.zeros(
            (0, k), dtype=torch.bool, device=emb.device)

    @torch.no_grad()
    def evaluate(self, graph: Graph) -> Dict[str, float]:
        if not self.eval_users.size:
            return {"val_recall": 0.0, "test_recall": 0.0}
        emb = self.model(graph, training=False)
        rel = self.top_items(emb).cpu().numpy()
        k = rel.shape[1]
        disc = 1.0 / np.log2(np.arange(2, self.topk + 2))
        t = self.target_count
        ideal = np.asarray([disc[:m].sum() for m in range(k + 1)])
        # the JAX loop's sums: each user's terms in float64, then the users
        # added one after another in ascending order (cumsum adds in order)
        recall = np.cumsum(rel.sum(1) / t)[-1]
        ndcg = np.cumsum((rel * disc[:k]).sum(1)
                         / ideal[np.minimum(t, k)])[-1]
        n = rel.shape[0]
        return {"val_recall": recall / n, "test_recall": recall / n,
                "val_ndcg": ndcg / n, "test_ndcg": ndcg / n}
