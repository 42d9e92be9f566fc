"""KG triple embeddings, TransE / DistMult / RotatE / ComplEx — the port of
``cogdl_tpu/models/emb/knowledge_base.py``: one scorer family trained with
self-adversarial negative sampling and evaluated by filtered, mean-rank-tied
MRR and hits@k.

Training follows the JAX loop draw for draw: the initial tables come from
the JAX package's generator at ``PRNGKey(seed)`` (``utils/threefry.py``,
bit for bit), a ``numpy`` generator seeded with ``seed`` shuffles the
training triples each epoch and draws each batch's negative entities and
which end they corrupt, in the JAX order; the step is torch Adam (the
optax defaults), TransE's entities projected back into the unit ball after
each. ``train_triples(init=...)`` takes other tables.

The evaluation ranks the target among all entities, counting a contender
scored level with it as half, and leaves out every other known triple
(of any split). The JAX package loops in Python over the contenders; here
the known triples are one sorted table of int64 keys and the filter is a
``searchsorted`` over a batch of rows, which gives the same ranks."""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...utils import threefry

# elements of the [rows, entities, width] score tensor of one evaluation
# batch: about 0.5 GB of float32
EVAL_ELEMENTS = 2 ** 27


def known_keys(triples: torch.Tensor, num_entities: int,
               num_rel_ids: int) -> torch.Tensor:
    """The sorted distinct int64 keys ``(h·num_rel_ids + r)·num_entities +
    t`` of ``[n, 3]`` triples, on their device."""
    t = triples.long()
    return torch.unique((t[:, 0] * num_rel_ids + t[:, 1]) * num_entities
                        + t[:, 2])


def key_in(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Whether each key of ``q`` is in ``keys`` (sorted, distinct)."""
    pos = torch.searchsorted(keys, q).clamp_max(keys.numel() - 1)
    return keys[pos] == q


class KGEModel:
    score_name = "transe"
    project_entities = False

    def __init__(self, num_entities: int = 0, num_relations: int = 0,
                 hidden_size: int = 200, gamma: float = 12.0,
                 negative_size: int = 64, lr: float = 1e-3,
                 batch_size: int = 1024, epochs: int = 50,
                 self_adversarial: float = 1.0, seed: int = 0):
        self.num_entities = num_entities
        self.num_relations = num_relations
        self.dim = hidden_size
        self.gamma = gamma
        self.negative_size = negative_size
        self.lr = lr
        self.batch_size = batch_size
        self.epochs = epochs
        self.alpha = self_adversarial
        self.seed = seed
        self.params: Optional[Dict[str, torch.Tensor]] = None

    # -- scoring -----------------------------------------------------------
    def init_params(self, seed: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
        """``ent`` ``[num_entities, entity_dim]`` and ``rel``
        ``[num_relations, relation_dim]``, uniform in ``±gamma / dim``: the
        JAX package's tables at ``PRNGKey(seed)`` (``seed`` by default)."""
        ke, kr = threefry.split(threefry.prng_key(
            self.seed if seed is None else seed))
        scale = self.gamma / self.dim
        return {
            "ent": torch.from_numpy(threefry.uniform(
                ke, (self.num_entities, self.entity_dim()), -scale, scale)),
            "rel": torch.from_numpy(threefry.uniform(
                kr, (self.num_relations, self.relation_dim()), -scale,
                scale)),
        }

    def entity_dim(self) -> int:
        return self.dim

    def relation_dim(self) -> int:
        return self.dim

    def score(self, h, r, t):
        """TransE: ``γ − ‖h + r − t‖``."""
        return self.gamma - torch.linalg.vector_norm(h + r - t + 1e-12,
                                                     dim=-1)

    # -- training ----------------------------------------------------------
    def train_triples(self, triples: Dict, device="cpu",
                      init: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Train on ``triples["train"]`` for ``epochs`` epochs of
        ``len(train) // batch_size`` batches (at least one; a short last
        batch wraps around the epoch's order) on ``device``, from ``init``
        (arrays ``ent`` and ``rel``) or :meth:`init_params`. Returns and
        keeps ``params``, the trained tables on ``device``."""
        device = torch.device(device)
        train = np.asarray(triples["train"])
        if init is None:
            init = self.init_params()
        # copies: the steps write into them, never into the caller's init
        ent, rel = (torch.tensor(np.asarray(init[k], np.float32),
                                 device=device).requires_grad_(True)
                    for k in ("ent", "rel"))
        opt = torch.optim.Adam([ent, rel], lr=self.lr)
        B, K = self.batch_size, self.negative_size
        rng = np.random.default_rng(self.seed)
        n = train.shape[0]
        nb = max(n // B, 1)
        for _ in range(self.epochs):
            perm = rng.permutation(n)
            for b in range(nb):
                sl = perm[b * B: (b + 1) * B]
                if sl.shape[0] < B:
                    sl = np.concatenate([sl, perm[: B - sl.shape[0]]])
                batch = torch.as_tensor(train[sl].astype(np.int64),
                                        device=device)
                neg = torch.as_tensor(rng.integers(0, self.num_entities,
                                                   (B, K)), device=device)
                ch = torch.as_tensor(rng.integers(0, 2, B) == 1,
                                     device=device)
                opt.zero_grad(set_to_none=True)
                self.batch_loss(ent, rel, batch, neg, ch).backward()
                opt.step()
                if self.project_entities:
                    with torch.no_grad():
                        ent.div_(torch.linalg.vector_norm(
                            ent, dim=1, keepdim=True).clamp_min(1.0))
        self.params = {"ent": ent.detach(), "rel": rel.detach()}
        return self.params

    def batch_loss(self, ent, rel, batch, neg_ent, corrupt_head):
        """The self-adversarial loss of one batch: ``−log σ(pos)`` and the
        softmax-weighted (weights held constant) ``−log σ(−neg)`` over the
        ``K`` corruptions of each triple, each averaged over the batch."""
        h, r, t = batch[:, 0], batch[:, 1], batch[:, 2]
        pos = self.score(ent[h], rel[r], ent[t])
        hn = torch.where(corrupt_head[:, None], neg_ent, h[:, None])
        tn = torch.where(corrupt_head[:, None], t[:, None], neg_ent)
        neg = self.score(ent[hn], rel[r][:, None], ent[tn])
        w = torch.softmax(self.alpha * neg, dim=1).detach()
        pos_l = -F.logsigmoid(pos).mean()
        neg_l = -(w * F.logsigmoid(-neg)).sum(1).mean()
        return pos_l + neg_l

    # -- filtered evaluation ----------------------------------------------
    @torch.no_grad()
    def ranks(self, triples: Dict, split: str = "test",
              max_eval: int = 2000) -> np.ndarray:
        """The filtered ranks of the first ``max_eval`` triples of
        ``split``, each triple's tail rank among all entities then its head
        rank: ``1 + #better + ½·#level`` over the contenders that form no
        known triple (of any split)."""
        ent, rel = self.params["ent"], self.params["rel"]
        device, N, R = ent.device, self.num_entities, self.num_relations
        test = torch.as_tensor(np.asarray(triples[split])[:max_eval]
                               .astype(np.int64), device=device)
        keys = known_keys(torch.as_tensor(np.concatenate(
            [np.asarray(triples[s], np.int64)
             for s in ("train", "valid", "test")]), device=device), N, R)
        cand = torch.arange(N, device=device)
        step = max(EVAL_ELEMENTS // max(N * ent.shape[1], 1), 1)
        ranks = []
        for i in range(0, test.shape[0], step):
            h, r, t = test[i: i + step].unbind(1)
            pair = []
            for tail in (True, False):
                if tail:
                    s = self.score(ent[h][:, None], rel[r][:, None],
                                   ent[None])
                    target = t
                    q = ((h * R + r) * N)[:, None] + cand
                else:
                    s = self.score(ent[None], rel[r][:, None],
                                   ent[t][:, None])
                    target = h
                    q = (cand * R)[None] * N + (r * N + t)[:, None]
                free = ~key_in(keys, q)
                s_t = s.gather(1, target[:, None])
                better = (s > s_t) & free
                tied = (s == s_t) & free
                tied.scatter_(1, target[:, None], False)
                pair.append(1.0 + better.sum(1).double()
                            + 0.5 * tied.sum(1).double())
            # each triple's tail rank, then its head rank: the JAX order
            ranks.append(torch.stack(pair, 1).reshape(-1))
        return torch.cat(ranks).cpu().numpy()

    def evaluate(self, triples: Dict, split: str = "test",
                 max_eval: int = 2000) -> Dict[str, float]:
        """MRR, mean rank and hits@{1, 3, 10} over :meth:`ranks`."""
        ranks = self.ranks(triples, split, max_eval)
        return {
            "mrr": float((1.0 / ranks).mean()),
            "mr": float(ranks.mean()),
            "hits@1": float((ranks <= 1).mean()),
            "hits@3": float((ranks <= 3).mean()),
            "hits@10": float((ranks <= 10).mean()),
        }


class TransE(KGEModel):
    score_name = "transe"
    project_entities = True


class DistMult(KGEModel):
    score_name = "distmult"

    def score(self, h, r, t):
        return (h * r * t).sum(-1)


class ComplEx(KGEModel):
    score_name = "complex"

    def score(self, h, r, t):
        hr, hi = h.chunk(2, -1)
        tr, ti = t.chunk(2, -1)
        rr, ri = r.chunk(2, -1)
        return (hr * rr * tr + hi * rr * ti + hr * ri * ti
                - hi * ri * tr).sum(-1)


class RotatE(KGEModel):
    score_name = "rotate"

    def relation_dim(self) -> int:
        return self.dim // 2

    def score(self, h, r, t):
        hr, hi = h.chunk(2, -1)
        tr, ti = t.chunk(2, -1)
        phase = r * math.pi      # relations as rotations
        rr, ri = torch.cos(phase), torch.sin(phase)
        dr = hr * rr - hi * ri - tr
        di = hr * ri + hi * rr - ti
        return self.gamma - torch.sqrt(dr ** 2 + di ** 2 + 1e-12).sum(-1)
