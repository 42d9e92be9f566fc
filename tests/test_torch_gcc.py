"""The port's GCC (``layers/set2set.py``, ``models/nn/gcc.py``,
``wrappers/pretraining.py``, ``datasets/gcc.py``) against the JAX
package's, on the CPU, on a seeded 200-node sbm graph.

The JAX wrapper runs its numpy branch (``cogdl_tpu.native.available``
patched to False); the port samples with its C++ library, so the node sets
of both come from the port's walks and are handed to the JAX wrapper.
Weights: the JAX package's, carried across by ``load_jax_params``.
Tolerances: forward 1e-5, gradients 1e-4, losses of three MoCo steps
1e-4, the queue and the key weights 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cogdl_tpu.native as jnative
import cogdl_tpu.utils.probe as jprobe
from cogdl_tpu.datasets import gcc as jgcc
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.layers.set2set import Set2Set as JSet2Set
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.trainer.trainer import TrainerConfig as JTrainerConfig
from cogdl_tpu.trainer.trainer import build_optimizer as j_build_optimizer
from cogdl_tpu.wrappers import fetch_wrapper as j_fetch_wrapper
from cogdl_tpu_torch import experiment, native
from cogdl_tpu_torch.data.graph import from_coo as t_from_coo
from cogdl_tpu_torch.datasets import build_dataset
from cogdl_tpu_torch.datasets import gcc as tgcc
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.layers import Set2Set
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.trainer.trainer import (
    Trainer,
    TrainerConfig,
    build_optimizer,
)
from cogdl_tpu_torch.wrappers import fetch_wrapper
from cogdl_tpu_torch.wrappers import pretraining as tpre
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
NODES, F_IN, CLASSES = 200, 8, 4
FWD_TOL, GRAD_TOL, LOSS_TOL, STATE_TOL = 1e-5, 1e-4, 1e-4, 1e-5
# the wrapper cut to a test's size: 4 seeds a step (8 subgraphs of at most
# 8 nodes), walks of 16 steps, a queue of 16 keys; the encoder keeps its
# five GIN layers and its Set2Set of 6 steps over 3 layers
WRAP_KW = {"batch_size": 4, "subgraph_size": 8, "rw_hops": 16,
           "queue_size": 16, "batches_per_epoch": 2, "momentum": 0.9}
MODEL_KW = {"in_features": F_IN, "out_features": CLASSES, "hidden_size": 16}
LR = 0.01
STEPS = 3


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.fixture
def jax_numpy_branch(monkeypatch):
    """Send the JAX wrapper down its numpy branch."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def make_pair(probe_nodes=512, **model_kw):
    """The JAX wrapper on its prepared graph with its initial variables,
    the port wrapper on its prepared graph with the port model carrying
    them (``init`` first: it attaches the MoCo buffers)."""
    kw = dict(MODEL_KW, **model_kw)
    wj = j_fetch_wrapper("gcc")(j_build_model("gcc", **kw),
                                probe_nodes=probe_nodes, **WRAP_KW)
    gj = wj.prepare_graph(j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    variables = wj.init(jax.random.PRNGKey(0), gj)
    wt = fetch_wrapper("gcc")(build_model("gcc", **kw),
                              probe_nodes=probe_nodes, num_threads=2,
                              **WRAP_KW)
    gt = wt.prepare_graph(t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    wt.init(torch.Generator().manual_seed(0), gt)
    v = _host(variables)
    load_jax_params(wt.model, v["params"], v["batch_stats"], moco=v["moco"])
    return wj, gj, variables, wt, gt


def node_sets(wt, n_seeds, seed=3):
    seeds = np.random.default_rng(seed).integers(0, NODES, n_seeds)
    return wt._rwr_nodes(seeds, 11)


def unions(wj, wt, sets):
    """The JAX wrapper's and the port's union of the subgraphs of
    ``sets``."""
    return (wj._union([wj._subgraph(nd) for nd in sets]),
            wt._union(sets))


def port_subgraph(wt, nodes):
    """The port wrapper's subgraph of ``nodes`` as a Graph (its union
    takes the arrays as they are)."""
    row, col, x = wt._subgraph_arrays(nodes)
    return t_from_coo(np.stack([row, col]), num_nodes=len(nodes), x=x,
                      bucket=False)


# -- Set2Set ------------------------------------------------------------------

def test_set2set_forward_and_grads_match_jax():
    rng = np.random.default_rng(0)
    F, G = 6, 5
    gid = np.sort(rng.integers(0, G - 1, 40)).astype(np.int32)  # G-1 empty
    x = rng.normal(size=(40, F)).astype(np.float32)
    jm = JSet2Set(F, processing_steps=6, num_layers=3)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(gid),
                     G)["params"]
    w = rng.normal(size=(G, 2 * F)).astype(np.float32)

    def f(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, jnp.asarray(gid), G) * w)

    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(gid), G)
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    tm = load_jax_params(Set2Set(F, 6, 3), _host(params))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, torch.from_numpy(gid), G)
    close(out, want, FWD_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    close(xt.grad, gx, GRAD_TOL)
    for name, p in tm.named_parameters():
        close(p.grad, np.asarray(_host(gp)[name]), GRAD_TOL, name)


def test_set2set_initialises_from_the_generator():
    a, b = Set2Set(8, 6, 3), Set2Set(8, 6, 3)
    for m in (a, b):
        m.reset_own_parameters(torch.Generator().manual_seed(4))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    w = a.w_hh_l1.detach()
    torch.testing.assert_close(w @ w.T, torch.eye(8), atol=1e-5, rtol=0)
    assert float(a.b_l2.detach().abs().sum()) == 0.0


# -- the encoder -------------------------------------------------------------

@pytest.mark.usefixtures("jax_numpy_branch")
@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_gcc_forward_and_grads_match_jax(structure, training):
    """The encoder over one union of subgraphs, its output and the
    gradients of a weighted sum of it, from the JAX weights; in training
    mode over the batch statistics of the real nodes."""
    wj, _, variables, wt, _ = make_pair()
    bj, bt = unions(wj, wt, node_sets(wt, 8))
    if not structure:
        bt = bt.replace(extras={k: v for k, v in bt.extras.items()
                                if not k.startswith("spmm_")})
    G = bt.meta_get("num_graphs")
    w = np.random.default_rng(2).normal(size=(G, CLASSES)).astype(np.float32)
    jm = wj.model
    svars = {"batch_stats": variables["batch_stats"]}

    def f(p):
        out = jm.apply({"params": p, **svars}, bj, bj.x, training=training,
                       mutable=["batch_stats"] if training else False)
        out = out[0] if training else out
        return jnp.sum(out * w), out

    (_, want), grads = jax.value_and_grad(f, has_aux=True)(
        variables["params"])
    tm = wt.model
    out = tm(bt, bt.x, training=training)
    close(out, want, FWD_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    g = _host(grads)
    ref = load_jax_params(build_model("gcc", **dict(MODEL_KW,
                                                    in_features=18)), g)
    want_g = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        close(p.grad, want_g[name].detach(), GRAD_TOL, name)


def test_gcc_builds_for_the_wrappers_features():
    """The wrapper rebuilds a model made for the graph's features at its
    own input width (the eigenvector embedding, the seed flag, the
    degree), as the JAX wrapper clones it."""
    w = fetch_wrapper("gcc")(build_model("gcc", **MODEL_KW))
    assert w.model.in_features == 18 and w.out_dim == CLASSES
    assert w.model.gin0.fc1.in_features == 18
    with pytest.raises(ValueError, match="readout"):
        build_model("gcc", in_features=4, readout="mean")


# -- sampling ---------------------------------------------------------------

def test_induced_subgraph_matches_its_replay_and_refuses_bad_ids():
    """The library's edges among a node set, positions in its sorted
    order, bit for bit its numpy replay's; and each an edge of the
    graph."""
    _, _, _, wt, _ = make_pair()
    indptr, indices = wt._csr[0], wt._csr[1]
    rng = np.random.default_rng(7)
    for k in (1, 2, 9, 50, NODES):
        nodes = rng.choice(NODES, k, replace=False)
        got = native.induced_subgraph(indptr, indices, nodes)
        want = native.induced_subgraph_reference(indptr, indices, nodes)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        s = np.sort(nodes)
        for r, c in zip(*got):
            assert s[c] in indices[indptr[s[r]]: indptr[s[r] + 1]]
    for fn in (native.induced_subgraph, native.induced_subgraph_reference):
        with pytest.raises(ValueError, match="distinct"):
            fn(indptr, indices, np.array([3, 3]))
        with pytest.raises(ValueError, match="must lie"):
            fn(indptr, indices, np.array([0, NODES]))


def test_rwr_node_sets_come_from_the_library_walks():
    """Each set is its seed, then the other nodes its walk with restart
    visited, ascending, cut to ``subgraph_size``: the walks those of
    ``random_walk_reference`` at the wrapper's thread count."""
    _, _, _, wt, _ = make_pair()
    seeds = np.random.default_rng(0).integers(0, NODES, 8)
    sets = wt._rwr_nodes(seeds, 42)
    walks = native.random_walk_reference(
        wt._csr[0], wt._csr[1], seeds, WRAP_KW["rw_hops"], seed=42,
        num_threads=2, restart_prob=0.8)
    assert len(sets) == 8
    for s, walk, nodes in zip(seeds, walks, sets):
        rest = np.unique(walk)
        rest = rest[rest != s][: WRAP_KW["subgraph_size"] - 1]
        np.testing.assert_array_equal(nodes, np.r_[s, rest])
        assert len(nodes) <= WRAP_KW["subgraph_size"]


@pytest.mark.usefixtures("jax_numpy_branch")
def test_subgraphs_and_unions_match_the_jax_numpy_branch():
    """Over the same node sets, each subgraph (edges, the eigenvector
    features, the seed flag, the degree) and each union, array for array;
    an isolated seed keeps its self loop in both."""
    wj, _, _, wt, _ = make_pair()
    sets = node_sets(wt, 8) + [np.array([NODES - 1, 0, 1])]
    for nodes in sets:
        sj, st = wj._subgraph(nodes), port_subgraph(wt, nodes)
        assert (st.num_nodes, st.num_edges) == (sj.num_nodes, sj.num_edges)
        for f in ("row", "col"):
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(sj, f)))
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(sj.x))
    bj, bt = unions(wj, wt, sets[:8])
    assert (bt.n_pad, bt.e_pad, bt.num_nodes, bt.num_edges) == (
        bj.n_pad, bj.e_pad, bj.num_nodes, bj.num_edges)
    assert bt.meta_get("num_graphs") == bj.meta_get("num_graphs") == 9
    for f in ("row", "col", "edge_weight", "x"):
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)))
    for k in ("graph_id", "graph_mask"):
        np.testing.assert_array_equal(bt.extras[k].numpy(),
                                      np.asarray(bj.extras[k]))
    # the union carries K1's structure, built on the host
    assert "spmm_fw_ptr" in bt.extras and "spmm_bw_ptr" in bt.extras


def test_train_batches_draw_pairs_of_views_per_epoch():
    """``batches_per_epoch`` unions an epoch, the first ``batch_size``
    graphs the query views and the next the key views of the same seeds;
    the epoch's generator ``default_rng(seed + 1000·epoch)``."""
    _, _, _, wt, gt = make_pair()
    b0 = wt.train_batches(gt)
    b1 = wt.train_batches(gt)
    assert len(b0) == WRAP_KW["batches_per_epoch"]
    B = WRAP_KW["batch_size"]
    rng = np.random.default_rng(1000)
    seeds = rng.integers(0, NODES, B)
    x = b1[0].x.numpy()
    gid = b1[0].extras["graph_id"].numpy()
    for i in range(2 * B):
        rows = np.nonzero(gid == i)[0]
        assert x[rows[0], 16] == 1.0 and x[rows[1:], 16].sum() == 0.0
    assert not torch.equal(b0[0].x, b1[0].x)
    wt._epoch = 1
    again = wt.train_batches(gt)
    assert torch.equal(again[0].x, b1[0].x) and seeds.shape == (B,)


# -- MoCo ---------------------------------------------------------------------

@pytest.mark.usefixtures("jax_numpy_branch")
def test_three_moco_steps_match_jax():
    """Three steps of the trainer over the same unions from the same
    weights, queue and key encoder: the losses, and after them the queue,
    its pointer, the key weights and the running statistics. The steps
    are SGD's (momentum 0.9): Adam's first steps move a weight by about
    ±lr whatever its gradient, so a gradient at float32's rounding level
    (Set2Set's inputs from ReLU-dead units) would step differently in
    either package."""
    wj, _, variables, wt, _ = make_pair()
    batches = [unions(wj, wt, node_sets(wt, 8, seed=s)) for s in range(2)]
    tx = j_build_optimizer(JTrainerConfig(lr=LR, optimizer="sgd"))
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    opt_state = tx.init(params)

    @jax.jit
    def step(params, state, opt_state, b):
        (loss, upd), grads = jax.value_and_grad(
            lambda p: wj.loss({"params": p, **state}, b,
                              jax.random.PRNGKey(0)), has_aux=True)(params)
        u, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, u), {**state, **upd}, opt_state,
                loss)

    cfg = TrainerConfig(lr=LR, optimizer="sgd", device="cpu")
    opt, sched = build_optimizer(cfg, wt.model.parameters())
    gen = torch.Generator().manual_seed(0)
    for i in range(STEPS):
        bj, bt = batches[i % 2]
        params, state, opt_state, loss_j = step(params, state, opt_state, bj)
        loss_t = Trainer(cfg).train_step(wt, opt, sched, bt, gen)
        close(loss_t, float(loss_j), LOSS_TOL, f"step {i}")
    moco = _host(state["moco"])
    m = wt.model
    close(m.moco.queue, moco["queue"], STATE_TOL)
    assert int(m.moco.ptr) == int(moco["ptr"]) == (
        STEPS * WRAP_KW["batch_size"]) % WRAP_KW["queue_size"]
    ref = load_jax_params(build_model("gcc", **dict(MODEL_KW,
                                                    in_features=18)),
                          moco["key_params"], _host(state["batch_stats"]))
    for name, _ in m.named_parameters():
        close(m.moco.key.get_buffer(name), ref.get_parameter(name).detach(),
              STATE_TOL, name)
    for name, buf in ref.named_buffers():
        close(m.get_buffer(name), buf, STATE_TOL, name)
    moved = max(float((m.moco.key.get_buffer(n) - p.detach()).abs().max())
                for n, p in make_pair()[3].model.named_parameters())
    assert moved > 100 * STATE_TOL


def test_the_key_encoder_reads_the_querys_statistics():
    """The key forward is the query encoder in eval mode with the key
    weights: the key state holds the weights alone, no statistics, and
    its output equals the query's own when the weights agree, with the
    query's statistics moved."""
    _, _, _, wt, _ = make_pair()
    sets = node_sets(wt, 8)
    bt = wt._union(sets)
    m = wt.model
    names = {n for n, _ in m.named_parameters()}
    assert {n for n, _ in m.moco.key.named_buffers()} == names
    for name, p in m.named_parameters():
        m.moco.key.get_buffer(name).copy_(p.detach())
    m.gin0.bn.mean.fill_(0.3)
    with torch.no_grad():
        torch.testing.assert_close(wt.key_forward(bt),
                                   m(bt, bt.x, training=False))


def test_init_draws_the_queue_and_copies_the_encoder():
    _, _, _, wt, gt = make_pair()
    wt.init(torch.Generator().manual_seed(3), gt)
    m = wt.model
    q = m.moco.queue
    assert q.shape == (WRAP_KW["queue_size"], CLASSES)
    torch.testing.assert_close(q.norm(dim=1), torch.ones(q.shape[0]))
    for name, p in m.named_parameters():
        assert torch.equal(m.moco.key.get_buffer(name), p), name
    assert int(m.moco.ptr) == 0
    assert not any(n.startswith("moco") for n, _ in m.named_parameters())
    wt.init(torch.Generator().manual_seed(3), gt)     # again: no nesting
    assert "moco" not in m.moco.key._modules


# -- the probe ----------------------------------------------------------------

@pytest.mark.usefixtures("jax_numpy_branch")
@pytest.mark.parametrize("probe_nodes", [512, 64])
def test_probe_matches_jax(probe_nodes, monkeypatch):
    """Over the same node sets (the port's walks, handed to the JAX
    wrapper), the embeddings the probe fits on, its masks restricted to
    the embedded nodes and its accuracies."""
    wj, gj, variables, wt, gt = make_pair(probe_nodes=probe_nodes)
    monkeypatch.setattr(wj, "_rwr_nodes", wt._rwr_nodes)
    seen = {}

    def record(key, fn):
        def probe(emb, graph):
            seen[key] = (np.asarray(emb), np.asarray(graph.train_mask),
                         np.asarray(graph.test_mask))
            return fn(emb, graph)
        return probe

    monkeypatch.setattr(jprobe, "logreg_probe",
                        record("jax", jprobe.logreg_probe))
    monkeypatch.setattr(tpre, "logreg_probe",
                        record("port", tpre.logreg_probe))
    want = wj.evaluate(variables, gj)
    got = wt.evaluate(gt)
    (ej, trj, tej), (et, trt, tet) = seen["jax"], seen["port"]
    close(et, ej, FWD_TOL)
    np.testing.assert_array_equal(trt, trj)
    np.testing.assert_array_equal(tet, tej)
    if probe_nodes < NODES:
        assert int((np.abs(et).sum(1) > 0).sum()) == probe_nodes
    for k in ("val_acc", "test_acc"):
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])


def test_probe_refuses_a_graph_without_a_split():
    _, _, _, wt, gt = make_pair()
    g = gt.replace(train_mask=None, val_mask=None, test_mask=None)
    with pytest.raises(ValueError, match="train_mask, val_mask, test_mask"):
        wt.evaluate(g)
    assert wt.evaluate(gt.replace(y=None)) == {"val_acc": 0.0,
                                               "test_acc": 0.0}


def test_gcc_trains_through_experiment():
    ds = build_dataset("sbm", num_nodes=120, feat_dim=F_IN)
    (res,) = experiment(dataset=ds, model="gcc", epochs=2, seed=0,
                        device="cpu", hidden_size=16, probe_nodes=40,
                        **WRAP_KW)[(ds.name, "gcc")]
    assert np.isfinite(res["train_loss"])
    assert 0.0 <= res["test_acc"] <= 1.0 and res["probe_ms"] > 0


# -- the loaders --------------------------------------------------------------

def _write_edgelist(root, labelled, h_index=False):
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(0)
    ids = rng.permutation(1000)[:60] + 7
    with open(os.path.join(raw, "edgelist.txt"), "w") as f:
        for _ in range(150):
            u, v = rng.choice(ids, 2, replace=False)
            f.write(f"{u} {v}\n")
        f.write("\n")
    if labelled:
        with open(os.path.join(raw, "nodelabel.txt"), "w") as f:
            for n in ids[:50]:
                lab = rng.integers(0, 40) if h_index else rng.choice(
                    [3, 11, 5])
                f.write(f"{n} {lab}\n")


def _same_graph(gt, gj):
    assert (gt.num_nodes, gt.num_edges) == (gj.num_nodes, gj.num_edges)
    for f in ("row", "col", "edge_weight", "y"):
        a, b = getattr(gt, f), getattr(gj, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert gt.meta_get("num_classes") == gj.meta_get("num_classes")


@pytest.mark.parametrize("name", ["usa-airport", "h-index", "gcc_imdb"])
def test_edgelist_loader_matches_jax(name, tmp_path):
    root = str(tmp_path / name)
    _write_edgelist(root, name != "gcc_imdb", h_index=name == "h-index")
    _same_graph(tgcc.build_edgelist(name, root).graph,
                jgcc.build_edgelist(name, root).graph)


def test_paired_loader_matches_jax(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(1)
    for part in ("kdd", "icdm"):
        with open(raw / f"{part}.graph", "w") as f:
            f.write("header\n")
            for _ in range(80):
                u, v = rng.integers(0, 40, 2) + 100
                f.write(f"{u} {v} {rng.integers(1, 4)}\n")
        with open(raw / f"{part}.dict", "w") as f:
            for i in range(30):
                f.write(f"author {i}\t{rng.integers(0, 60) + 100}\n")
    t = tgcc.build_paired("kdd_icdm", str(tmp_path))
    j = jgcc.build_paired("kdd_icdm", str(tmp_path))
    assert len(t.graphs) == len(j.graphs) == 2
    for gt, gj in zip(t.graphs, j.graphs):
        _same_graph(gt, gj)
    assert t.name_maps == j.name_maps


@pytest.mark.parametrize("name", ["usa-airport", "gcc_academic",
                                  "sigir_cikm"])
def test_missing_files_raise_the_jax_message(name, tmp_path):
    build = (tgcc.build_paired if name == "sigir_cikm"
             else tgcc.build_edgelist)
    jbuild = (jgcc.build_paired if name == "sigir_cikm"
              else jgcc.build_edgelist)
    with pytest.raises(FileNotFoundError) as want:
        jbuild(name, str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        build(name, str(tmp_path))
    assert str(got.value) == str(want.value)


def test_every_gcc_name_is_registered():
    from cogdl_tpu.datasets import SUPPORTED_DATASETS as J
    from cogdl_tpu_torch.datasets import SUPPORTED_DATASETS as T

    names = [n for n, p in J.items() if ".datasets.gcc." in p]
    assert len(names) == 11
    for n in names:
        assert T[n].rsplit(".", 1)[1] == J[n].rsplit(".", 1)[1], n
