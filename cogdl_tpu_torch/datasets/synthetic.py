"""Synthetic graph generators — the port of the ``sbm_graph``,
``powerlaw_graph``, ``powerlaw_graph_device``, ``random_graphs_dataset``,
``traffic_graph``, ``hetero_sbm_graph``, ``bipartite_rec_graph`` and
``random_triples`` parts of ``cogdl_tpu/datasets/synthetic.py``.

The host generators draw from ``np.random.default_rng(seed)`` with the
same calls in the same order as the JAX package, so the same arguments give
the same graph in both packages. ``powerlaw_graph_device`` and the features
of ``powerlaw_graph(device_features=True)`` are drawn on the device from a
``torch.Generator``: the same law, other numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.graph import (
    Graph,
    add_self_loops,
    from_coo,
    pad_to,
    to_undirected,
)
from ..trainer.trainer import resolve_device


def sbm_graph(
    num_nodes: int = 400,
    num_classes: int = 4,
    p_in: float = 0.05,
    p_out: float = 0.005,
    feat_dim: int = 32,
    feat_noise: float = 1.0,
    train_ratio: float = 0.3,
    val_ratio: float = 0.2,
    seed: int = 0,
    self_loops: bool = True,
) -> Graph:
    """Stochastic block model with class-informative Gaussian features (the
    Cora stand-in: a GCN reaches high accuracy on it)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)
    # sample the edge count of each block pair, then its endpoints
    rows, cols = [], []
    for a in range(num_classes):
        ia = np.where(y == a)[0]
        for b in range(num_classes):
            ib = np.where(y == b)[0]
            p = p_in if a == b else p_out
            k = rng.binomial(len(ia) * len(ib), p)
            if k == 0:
                continue
            rows.append(rng.choice(ia, size=k))
            cols.append(rng.choice(ib, size=k))
    row = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    col = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    keep = row != col
    row, col = row[keep], col[keep]

    centers = rng.normal(size=(num_classes, feat_dim)) * 2.0
    x = centers[y] + rng.normal(size=(num_nodes, feat_dim)) * feat_noise
    x = x.astype(np.float32)

    perm = rng.permutation(num_nodes)
    n_train = int(train_ratio * num_nodes)
    n_val = int(val_ratio * num_nodes)
    train_mask = np.zeros(num_nodes, bool)
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    train_mask[perm[:n_train]] = True
    val_mask[perm[n_train: n_train + n_val]] = True
    test_mask[perm[n_train + n_val:]] = True

    g = from_coo(
        np.stack([row, col]),
        num_nodes=num_nodes,
        x=x,
        y=y.astype(np.int32),
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        meta={"num_classes": num_classes, "name": f"sbm{num_nodes}"},
    )
    g = to_undirected(g)
    if self_loops:
        g = add_self_loops(g)
    return g


def powerlaw_graph(
    num_nodes: int,
    avg_degree: int = 15,
    feat_dim: int = 128,
    num_classes: int = 47,
    seed: int = 0,
    device_features: bool = False,
    device="cuda",
) -> Graph:
    """Directed power-law graph, the SpMM benchmark workload: sources are
    drawn from a Zipf law (a few hub columns), destinations uniformly.

    ``device_features=True`` draws ``x``, ``y`` and the masks on ``device``
    (the card unless the caller names another) from a ``torch.Generator``
    seeded with ``seed`` and returns the graph there: ``x`` has ``n_pad``
    rows, the pad rows random too, as in the JAX package; ``train_mask`` is
    ``(uniform < 0.1) & node_mask``, val and test its complement within
    ``node_mask``. The edges are the host generator's either way. Without
    it the graph is built on the host and ``device`` is not read. The JAX
    package's ``relabel`` option is not ported."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** -0.8
    probs /= probs.sum()
    col = rng.choice(num_nodes, size=num_edges, p=probs).astype(np.int64)
    row = rng.integers(0, num_nodes, size=num_edges).astype(np.int64)
    meta = {"num_classes": num_classes, "name": f"powerlaw{num_nodes}"}
    if device_features:
        device = resolve_device(device)
        g = from_coo(np.stack([row, col]), num_nodes=num_nodes,
                     meta=meta).to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn(g.n_pad, feat_dim, generator=gen, device=device)
        y = torch.randint(0, num_classes, (g.n_pad,), generator=gen,
                          device=device, dtype=torch.int32)
        node_ok = g.node_mask()
        train_mask = (torch.rand(g.n_pad, generator=gen, device=device)
                      < 0.1) & node_ok
        return g.replace(x=x, y=y, train_mask=train_mask,
                         val_mask=~train_mask & node_ok,
                         test_mask=~train_mask & node_ok)
    x = rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    train_mask = rng.uniform(size=num_nodes) < 0.1
    return from_coo(
        np.stack([row, col]),
        num_nodes=num_nodes,
        x=x,
        y=y,
        train_mask=train_mask,
        val_mask=~train_mask,
        test_mask=~train_mask,
        meta=meta,
    )


def powerlaw_graph_device(
    num_nodes: int,
    avg_degree: int = 15,
    feat_dim: int = 128,
    num_classes: int = 47,
    seed: int = 0,
    undirected: bool = True,
    zipf_a: float = 0.8,
    pad_multiple: int = 128,
    device="cuda",
) -> Graph:
    """Power-law graph generated and laid out on ``device`` (the
    ogbn-products stand-in of the products-scale benchmark): edge sampling,
    the CSR sort, ``row_ptr``, the symmetric normalisation and the features
    all run there, drawn from one ``torch.Generator`` on that device seeded
    with ``seed``. Only the ``[num_nodes]`` Zipf CDF is computed on the host
    (float64 for the cumulative sum) and copied over as float32.

    Destinations follow the Zipf law, sources are uniform;
    ``undirected=True`` mirrors every sampled edge, so ``Aᵀ = A`` and the
    backward SpMM can share the forward's structure
    (``prepare_spmm_device(symmetric=True)``). Self loops are appended and
    the symmetric normalisation is folded into ``edge_weight``
    (``meta["norm"] == "sym"``); parallel edges are kept. ``n_pad`` is
    ``num_nodes`` rounded up to ``pad_multiple`` and the edge arrays carry no
    padding (``e_pad == num_edges``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_pad = -(-num_nodes // pad_multiple) * pad_multiple
    n_directed = (num_nodes * avg_degree) // (2 if undirected else 1)

    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** -zipf_a
    cdf = torch.from_numpy(
        np.cumsum(probs / probs.sum()).astype(np.float32)).to(device)

    u = torch.rand(n_directed, generator=gen, device=device)
    dst = torch.searchsorted(cdf, u).clamp_(max=num_nodes - 1).int()
    del u, cdf
    src = torch.randint(0, num_nodes, (n_directed,), generator=gen,
                        device=device, dtype=torch.int32)
    loops = torch.arange(num_nodes, dtype=torch.int32, device=device)
    if undirected:
        row = torch.cat([dst, src, loops])
        col = torch.cat([src, dst, loops])
    else:
        row = torch.cat([dst, loops])
        col = torch.cat([src, loops])
    del dst, src, loops
    row, order = torch.sort(row, stable=True)
    col = col[order]
    del order
    counts = torch.bincount(row, minlength=n_pad)
    row_ptr = torch.zeros(n_pad + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    # symmetric normalisation folded into the weights (D^-1/2 A D^-1/2)
    deg = counts.float()
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                           torch.zeros_like(deg))
    w = inv_sqrt[row.long()]
    w *= inv_sqrt[col.long()]

    x = torch.randn(n_pad, feat_dim, generator=gen, device=device)
    y = torch.randint(0, num_classes, (n_pad,), generator=gen, device=device,
                      dtype=torch.int32)
    node_ok = torch.arange(n_pad, device=device) < num_nodes
    train_mask = (torch.rand(n_pad, generator=gen, device=device) < 0.1) & node_ok
    return Graph(
        row_ptr=row_ptr.int(), row=row, col=col, edge_weight=w,
        num_nodes=num_nodes, num_edges=int(row.numel()),
        x=x, y=y, train_mask=train_mask,
        val_mask=~train_mask & node_ok, test_mask=~train_mask & node_ok,
        meta=tuple(sorted({
            "num_classes": num_classes, "norm": "sym", "self_loops": True,
            "symmetric": bool(undirected),
            "name": f"powerlaw{num_nodes}-dev"}.items())),
    )


def random_graphs_dataset(
    num_graphs: int = 60,
    min_nodes: int = 10,
    max_nodes: int = 30,
    num_classes: int = 2,
    feat_dim: int = 8,
    seed: int = 0,
):
    """Multi-graph classification set: class 0 sparse Erdős–Rényi graphs,
    class 1 dense ones (learnable from the mean degree), each with self
    loops and Gaussian node features. Returns ``(graphs, labels)``, the JAX
    package's graphs for the same arguments."""
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for i in range(num_graphs):
        label = i % num_classes
        n = int(rng.integers(min_nodes, max_nodes + 1))
        p = 0.15 + 0.3 * label / max(1, num_classes - 1)
        mask = rng.uniform(size=(n, n)) < p
        np.fill_diagonal(mask, False)
        r, c = np.where(mask | mask.T)
        x = rng.normal(size=(n, feat_dim)).astype(np.float32)
        g = add_self_loops(from_coo(np.stack([r, c]), num_nodes=n, x=x,
                                    meta={"num_classes": num_classes}))
        graphs.append(g.replace(
            y=torch.full((g.n_pad,), label, dtype=torch.int32)))
        labels.append(label)
    return graphs, np.asarray(labels, np.int32)


def traffic_graph(
    num_nodes: int = 50,
    num_steps: int = 400,
    feat_dim: int = 1,
    seed: int = 0,
) -> Graph:
    """Traffic time-series stand-in (PeMS-style): a ring road graph (each
    station linked both ways to the next two along the ring), and a
    smooth periodic series a station with noise in ``extras["series"]``
    ``[num_steps, n_pad, feat_dim]``, zero on the pad rows, so that a
    window of it lines up with the graph's rows; ``x`` is ``[n_pad, 1]``
    zeros. The JAX package's graph and series for the same arguments."""
    rng = np.random.default_rng(seed)
    v = np.arange(num_nodes)
    near, far = (v + 1) % num_nodes, (v + 2) % num_nodes
    # a station's four entries in the JAX generator's order
    rows = np.stack([v, near, v, far], 1).reshape(-1)
    cols = np.stack([near, v, far, v], 1).reshape(-1)
    g = from_coo(np.stack([rows, cols]), num_nodes=num_nodes,
                 meta={"name": f"traffic{num_nodes}", "num_classes": 1})
    t = np.arange(num_steps)[:, None]
    phase = rng.uniform(0, 2 * np.pi, num_nodes)[None, :]
    base = (np.sin(2 * np.pi * t / 48 + phase)
            + 0.5 * np.sin(2 * np.pi * t / 12 + 2 * phase))
    noise = 0.1 * rng.normal(size=(num_steps, num_nodes))
    series = (base + noise).astype(np.float32)[..., None]
    if feat_dim > 1:
        series = np.repeat(series, feat_dim, axis=-1)
    series = np.concatenate(
        [series, np.zeros((num_steps, g.n_pad - num_nodes, series.shape[-1]),
                          np.float32)], axis=1)
    return g.replace(x=torch.zeros((g.n_pad, 1)),
                     extras={"series": torch.from_numpy(series)})


def hetero_sbm_graph(
    num_nodes: int = 300,
    num_types: int = 3,
    num_classes: int = 3,
    num_metapaths: int = 2,
    feat_dim: int = 16,
    seed: int = 0,
) -> Graph:
    """Heterogeneous stand-in (ACM/DBLP-style): an undirected sbm graph
    whose edges each draw a type, kept as the typed union graph
    (``edge_type``, ``meta["num_relations"]``), and one graph a type with a
    self loop a node, padded to the union graph's ``n_pad``, in
    ``extras["metapath_graphs"]`` and ``extras["relation_graphs"]`` (one
    tuple under both keys), with ``extras["node_type"]``. It drives HAN,
    GTN, RGCN, CompGCN and Simple-HGN; the JAX package's graph for the same
    arguments."""
    base = sbm_graph(num_nodes=num_nodes, num_classes=num_classes,
                     feat_dim=feat_dim, seed=seed, self_loops=False)
    rng = np.random.default_rng(seed + 1)
    node_type = rng.integers(0, num_types, num_nodes)
    E = base.num_edges
    etype = rng.integers(0, num_metapaths, E)
    row = base.row[:E].numpy()
    col = base.col[:E].numpy()
    shared_n, shared_e = base.n_pad, base.e_pad
    metas = []
    for t in range(num_metapaths):
        sel = etype == t
        gm = from_coo(np.stack([row[sel], col[sel]]), num_nodes=num_nodes,
                      n_pad=shared_n, e_pad=shared_e, bucket=False)
        # self loops keep isolated nodes sane
        metas.append(add_self_loops(gm).replace(meta=gm.meta))
    metas = [pad_to(m, shared_n, max(m.e_pad, shared_e)) for m in metas]
    nt = np.zeros(shared_n, np.int32)
    nt[:num_nodes] = node_type
    g = from_coo(
        np.stack([row, col]), num_nodes=num_nodes, edge_type=etype,
        n_pad=shared_n, e_pad=shared_e, bucket=False,
        x=base.x[:num_nodes], y=base.y[:num_nodes],
        train_mask=base.train_mask[:num_nodes],
        val_mask=base.val_mask[:num_nodes],
        test_mask=base.test_mask[:num_nodes],
        meta={"num_classes": num_classes, "num_relations": num_metapaths,
              "name": f"hetero{num_nodes}"},
    )
    metas = tuple(metas)
    return g.replace(extras={"node_type": torch.from_numpy(nt),
                             "metapath_graphs": metas,
                             "relation_graphs": metas})


def bipartite_rec_graph(
    num_users: int = 200,
    num_items: int = 100,
    avg_interactions: int = 12,
    num_tastes: int = 5,
    seed: int = 0,
) -> Graph:
    """User-item bipartite graph with latent taste clusters (a yelp2018
    stand-in for LightGCN): each user takes ``max(2, Poisson(avg))`` items,
    85% of them of its own taste, so collaborative filtering is learnable.
    Users are nodes ``[0, num_users)``, items follow; both directions of
    every interaction; ``meta`` carries ``num_users`` and ``num_items``. The
    JAX package's graph for the same arguments: the same draws in the same
    order, with the pools of each taste found once instead of once a
    user."""
    rng = np.random.default_rng(seed)
    user_taste = rng.integers(0, num_tastes, num_users)
    item_taste = rng.integers(0, num_tastes, num_items)
    pools = {t: (np.where(item_taste == t)[0], np.where(item_taste != t)[0])
             for t in np.unique(user_taste)}
    picked = []
    for u in range(num_users):
        k = max(2, rng.poisson(avg_interactions))
        same, other = pools[user_taste[u]]
        n_same = int(0.85 * k)
        pick = []
        if same.size:
            pick.append(rng.choice(same, size=min(n_same, same.size),
                                   replace=False))
        if other.size:
            pick.append(rng.choice(other, size=min(k - n_same, other.size),
                                   replace=False))
        picked.append(np.unique(np.concatenate(pick)) + num_users)
    counts = np.fromiter((p.size for p in picked), np.int64, num_users)
    users = np.repeat(np.arange(num_users), counts)
    items = np.concatenate(picked) if picked else np.zeros(0, np.int64)
    return from_coo(np.stack([np.concatenate([users, items]),
                              np.concatenate([items, users])]),
                    num_nodes=num_users + num_items,
                    meta={"num_users": num_users, "num_items": num_items,
                          "num_classes": num_tastes,
                          "name": f"rec{num_users}x{num_items}"})


def random_triples(
    num_entities: int = 200,
    num_relations: int = 12,
    num_triples: int = 2000,
    structured: float = 0.8,
    seed: int = 0,
):
    """KG triple set with a train / valid / test split (an FB15k stand-in):
    int32 ``[n, 3]`` arrays of ``(head, relation, tail)`` under ``train``,
    ``valid`` and ``test`` (80 / 10 / 10 of the distinct triples), with
    ``num_entities`` and ``num_relations``. A ``structured`` fraction of
    the tails follows a learnable rule (each relation a fixed cyclic shift
    of the entity ids, the additive structure TransE models), the rest is
    noise. The JAX package's sets for the same arguments, array for
    array."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, num_entities, num_triples)
    r = rng.integers(0, num_relations, num_triples)
    shifts = rng.integers(1, num_entities, num_relations)
    t_rule = (h + shifts[r]) % num_entities
    t_noise = rng.integers(0, num_entities, num_triples)
    use_rule = rng.random(num_triples) < structured
    t = np.where(use_rule, t_rule, t_noise)
    triples = np.unique(np.stack([h, r, t], 1).astype(np.int32), axis=0)
    num_triples = triples.shape[0]
    rng.shuffle(triples)
    perm = rng.permutation(num_triples)
    n_tr = int(0.8 * num_triples)
    n_va = int(0.1 * num_triples)
    return {
        "train": triples[perm[:n_tr]],
        "valid": triples[perm[n_tr: n_tr + n_va]],
        "test": triples[perm[n_tr + n_va:]],
        "num_entities": num_entities,
        "num_relations": num_relations,
    }
