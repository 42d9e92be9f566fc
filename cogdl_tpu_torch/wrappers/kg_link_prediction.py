"""GNN knowledge-graph link prediction — the port of
``cogdl_tpu/wrappers/kg_link_prediction.py`` (``KGLinkPredictionWrapper``).

An RGCN or CompGCN encoder over the training triples, triples scored by
DistMult or ConvE (``KGLinkPredictor``), trained by BCE on a fixed-size
uniform sample of training triples and as many corrupted ones per
``neg_ratio``, evaluated by the MRR and hits@{1, 3, 10} of each held-out
triple's tail, and of its head through the inverse relation, among every
entity: the raw protocol, or the filtered one that drops the other known
triples from each ranking.

The graph (built here from the triples: ``graph`` is None) carries each
training triple ``(h, r, t)`` as an edge from ``h`` to ``t`` of type ``r``
and one back of type ``r + R``, and a self loop of type ``2R`` on every
entity. The encoder is rebuilt for it through the model registry with the
model's own arguments (``models.build_model`` keeps them on the model),
``num_relations = 2R + 1``, ``in_features = out_features = hidden_size``,
``return_rel=True`` and ``num_entities=0`` wherever the model takes them,
as the JAX wrapper's ``clone`` does.

The trainer hands this wrapper its device (``to_device``) before
``prepare_graph``; the step's draws come from ``draws(graph,
generator)`` and ``loss_at(graph, draws, training, generator)`` takes
them. The filtered ranks drop the known triples with one sorted table of
int64 keys (``searchsorted``), on the scores' device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.graph import Graph, from_coo
from ..models import build_model
from ..models.emb.knowledge_base import key_in, known_keys
from ..models.nn.kg_gnn import KGLinkPredictor
from ..utils.evaluator import bce_logits


class KGLinkPredictionWrapper:
    eval_metric = "val_mrr"
    eval_mode = "max"

    def __init__(self, model, dataset=None, score_func: str = "distmult",
                 batch_size: int = 1024, neg_ratio: int = 1,
                 penalty: float = 0.001, protocol: str = "raw",
                 seed: int = 0):
        if dataset is None or dataset.triples is None:
            raise ValueError(
                "kg_link_prediction needs a triples dataset (e.g. "
                "'random-kg')")
        t = dataset.triples
        self.triples = t
        self.num_entities = int(t["num_entities"])
        self.num_relations = int(t["num_relations"])
        self.batch_size = batch_size
        self.neg_ratio = max(int(neg_ratio), 1)
        self.penalty = penalty
        if protocol not in ("raw", "filtered"):
            raise ValueError("protocol must be 'raw' or 'filtered'")
        self.protocol = protocol
        self.seed = seed
        self.device = torch.device("cpu")
        name = getattr(model, "registry_name", None)
        if name is None:
            raise ValueError(
                "kg_link_prediction rebuilds its encoder through the model "
                "registry; build the model with cogdl_tpu_torch.models."
                "build_model")
        kw = dict(model.build_kwargs)
        hidden = kw.get("hidden_size", 64)
        total_rel = 2 * self.num_relations + 1
        kw.update(num_relations=total_rel, in_features=hidden,
                  out_features=hidden, return_rel=True, num_entities=0)
        self.model = KGLinkPredictor(
            build_model(name, **kw), num_entities=self.num_entities,
            num_relations=total_rel, hidden_size=hidden,
            score_func=score_func)

    # -- data ---------------------------------------------------------------
    def to_device(self, device) -> None:
        """The device ``prepare_graph`` puts the graph and the training
        triples on."""
        self.device = torch.device(device)

    def prepare_graph(self, graph: Optional[Graph] = None) -> Graph:
        t = self.triples
        train = np.asarray(t["train"], np.int64)
        h, r, tl = train[:, 0], train[:, 1], train[:, 2]
        R, N = self.num_relations, self.num_entities
        loops = np.arange(N)
        row = np.concatenate([tl, h, loops])     # destination
        col = np.concatenate([h, tl, loops])     # source
        et = np.concatenate([r, r + R, np.full(N, 2 * R)]).astype(np.int32)
        g = from_coo(np.stack([row, col]), num_nodes=N, edge_type=et,
                     meta={"num_relations": 2 * R + 1})
        self.train_triples = torch.from_numpy(train).to(self.device)
        self.eval_triples = {"val": np.asarray(t["valid"], np.int64),
                             "test": np.asarray(t["test"], np.int64)}
        if self.protocol == "filtered":
            # every split's triples in ranking coordinates: (h, r) → t and,
            # through the inverse relation, (t, r + R) → h
            every = np.concatenate([train] + list(self.eval_triples.values()))
            inverse = np.stack([every[:, 2], every[:, 1] + R, every[:, 0]], 1)
            self.known = known_keys(
                torch.as_tensor(np.concatenate([every, inverse]),
                                device=self.device), N, 2 * R)
        return g.to(self.device)

    def train_batches(self, graph: Graph):
        return [graph]

    # -- training -----------------------------------------------------------
    def init(self, generator: torch.Generator, graph: Graph):
        self.model.reset_parameters(generator)

    def draws(self, graph: Graph, generator: Optional[torch.Generator]):
        """``(pick, ent, corrupt_head)``: ``batch_size`` training triples by
        index, ``batch_size·neg_ratio`` random entities and which end of
        each corrupted triple they replace, on the graph's device."""
        B, K, dev = self.batch_size, self.neg_ratio, graph.device
        n = self.train_triples.shape[0]
        pick = torch.randint(0, n, (B,), generator=generator, device=dev)
        ent = torch.randint(0, self.num_entities, (B * K,),
                            generator=generator, device=dev)
        corrupt_head = torch.rand(B * K, generator=generator,
                                  device=dev) < 0.5
        return pick, ent, corrupt_head

    def loss(self, graph: Graph, generator: Optional[torch.Generator] = None,
             training: bool = True) -> torch.Tensor:
        return self.loss_at(graph, self.draws(graph, generator), training,
                            generator)

    def loss_at(self, graph: Graph, draws, training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Mean BCE of the picked triples (label 1) and their corruptions
        (label 0) plus ``penalty`` times the embeddings' L2 term."""
        pick, ent, corrupt_head = draws
        K = self.neg_ratio
        tr = self.train_triples.index_select(0, pick.long())
        h, r, t = tr[:, 0], tr[:, 1], tr[:, 2]
        hk, tk = h.repeat(K), t.repeat(K)
        ent = ent.long()
        hh = torch.cat([h, torch.where(corrupt_head, ent, hk)])
        tt = torch.cat([t, torch.where(corrupt_head, tk, ent)])
        rr = torch.cat([r, r.repeat(K)])
        labels = torch.cat([torch.ones(h.shape[0], device=h.device),
                            torch.zeros(hk.shape[0], device=h.device)])
        logits, reg = self.model.loss_logits(graph, hh, rr, tt, training,
                                             generator)
        return (bce_logits(logits, labels).mean()
                + self.penalty * reg)

    # -- evaluation ---------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, graph: Graph) -> Dict[str, float]:
        out = {}
        for split, trip in self.eval_triples.items():
            if len(trip) == 0:
                continue
            mrr, hits = self.rank(graph, trip)
            out[f"{split}_mrr"] = mrr
            for k, v in hits.items():
                out[f"{split}_hits{k}"] = v
        if "val_mrr" in out:
            out["val_acc"] = out["val_mrr"]
        if "test_mrr" in out:
            out["test_acc"] = out["test_mrr"]
        return out

    @torch.no_grad()
    def rank(self, graph: Graph, triples, batch: int = 512):
        """MRR and hits@{1, 3, 10} over the ranks of each triple's tail
        among all entities for ``(h, r, ?)`` and of its head for ``(t, r +
        R, ?)``: one plus the entities scored strictly above the target,
        the known ones left out under the filtered protocol. Each batch of
        ``batch`` rows encodes the graph anew (``rank_scores``), as the
        JAX wrapper does."""
        R, N = self.num_relations, self.num_entities
        trip = torch.as_tensor(np.asarray(triples, np.int64),
                               device=graph.device)
        heads = torch.cat([trip[:, 0], trip[:, 2]])
        rels = torch.cat([trip[:, 1], trip[:, 1] + R])
        targets = torch.cat([trip[:, 2], trip[:, 0]])
        ranks = []
        for i in range(0, heads.shape[0], batch):
            h, r = heads[i: i + batch], rels[i: i + batch]
            tgt = targets[i: i + batch]
            s = self.model.rank_scores(graph, h, r)[:, :N]
            tgt_score = s.gather(1, tgt[:, None])
            if self.protocol == "filtered":
                q = ((h * (2 * R) + r) * N)[:, None] + torch.arange(
                    N, device=s.device)
                s = s.masked_fill(key_in(self.known, q), float("-inf"))
            ranks.append(1 + (s > tgt_score).sum(1))
        ranks = torch.cat(ranks).double().cpu().numpy()
        hits = {k: float((ranks <= k).mean()) for k in (1, 3, 10)}
        return float((1.0 / ranks).mean()), hits

