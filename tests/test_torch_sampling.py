"""cogdl_tpu_torch's host neighbor path against the JAX package on the CPU:
the C++ sampler against its numpy replay, ``graph_csr``, ``sample_adj``,
``NeighborSampler``, GraphSAGE and GAT over host-sampled blocks, the
``neighbor_sampling`` wrapper's loss curve, and ``Prefetcher``.

The port's library draws other numbers than the JAX package's (its thread
split is fixed by the call, the JAX library's by the OpenMP runtime), so it
is held bit for bit against its own replay, and parity with the JAX package
runs on the numpy branch: both samplers get the same seed, and the JAX
package is sent down its numpy branch by patching
``cogdl_tpu.native.available`` (no file of the JAX package changes)."""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu.native
import cogdl_tpu_torch.data.graph as tg
from cogdl_tpu.data import sampling as js
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.models.nn.gat import GAT as JGAT
from cogdl_tpu.models.nn.graphsage import GraphSAGE as JGraphSAGE
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu_torch import native
from cogdl_tpu_torch.data import sampling as ts
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import (
    build_spmm_schedule,
    prepare_spmm,
    stored_schedule,
)
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.trainer.trainer import Trainer
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from cogdl_tpu_torch.wrappers import fetch_wrapper
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from cogdl_tpu_torch.wrappers.sampled_node_classification import (
    SampledNodeClfWrapper,
    reads_kernel_structure,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 on both sides over identical blocks and weights, summed in other
# orders: forward 1e-5; grads 1e-4 (sums over the frame's rows)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
# per-epoch mean losses after up to 45 Adam steps from the same weights over
# the same batches: fp32 differences compound through the normalised
# updates (tests/test_torch_trainer.py's tolerance)
LOSS_RTOL = 1e-4
B, FANOUTS = 8, (2, 2)


@pytest.fixture
def jax_numpy_branch(monkeypatch):
    """Send the JAX package's ``sample_adj`` down its numpy branch."""
    monkeypatch.setattr(cogdl_tpu.native, "available", lambda: False)


@pytest.fixture(scope="module")
def graphs():
    gj = jg.add_self_loops(j_sbm(num_nodes=300, seed=1))
    gt = tg.add_self_loops(t_sbm(num_nodes=300, seed=1))
    return gj, gt


def _csr_with_holes():
    """A CSR whose nodes 3 and 9 (the last) have no edge: node 9's offset is
    ``len(indices)``."""
    rng = np.random.default_rng(3)
    deg = rng.integers(1, 5, 10)
    deg[[3, 9]] = 0
    indptr = np.zeros(11, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, 10, indptr[-1])
    return indptr, indices


# -- the library and its replay ---------------------------------------------

@pytest.mark.parametrize("threads", [1, 2, 3])
def test_library_matches_its_replay_bit_for_bit(threads):
    """For every (seed, threads) pair: the same (src, mask), zero-degree
    seeds (the last node's among them) masked off and pointing at
    themselves, every live slot an edge of its seed's row; more threads
    than seeds leave some threads without work."""
    indptr, indices = _csr_with_holes()
    rng = np.random.default_rng(threads)
    for seeds in (rng.integers(0, 10, 40), np.array([3, 9, 0]),
                  np.array([], np.int64)):
        for seed in (0, 7, 2 ** 62 - 1):
            src, mask = native.sample_neighbors(indptr, indices, seeds, 3,
                                                seed, threads)
            ref = native.sample_neighbors_reference(indptr, indices, seeds, 3,
                                                    seed, threads)
            np.testing.assert_array_equal(src, ref[0])
            np.testing.assert_array_equal(mask, ref[1])
            assert src.dtype == np.int64 and mask.dtype == bool
            rows = np.repeat(seeds, 3)
            dead = np.isin(rows, [3, 9])
            assert not mask[dead].any() and (src[dead] == rows[dead]).all()
            for s, r in zip(src[mask], rows[mask]):
                assert s in indices[indptr[r]: indptr[r + 1]]


def test_draws_depend_on_seed_and_threads_only():
    indptr, indices = _csr_with_holes()
    seeds = np.arange(9).repeat(8)
    one = native.sample_neighbors(indptr, indices, seeds, 4, 5, 1)[0]
    assert np.array_equal(one, native.sample_neighbors(
        indptr, indices, seeds, 4, 5, 1)[0])
    assert not np.array_equal(one, native.sample_neighbors(
        indptr, indices, seeds, 4, 6, 1)[0])
    assert not np.array_equal(one, native.sample_neighbors(
        indptr, indices, seeds, 4, 5, 2)[0])
    assert native.max_threads() >= 1


def test_library_refuses_bad_arguments():
    indptr, indices = _csr_with_holes()
    for bad in (dict(seeds=np.array([10])), dict(fanout=-1),
                dict(num_threads=0)):
        kw = {**dict(seeds=np.array([0]), fanout=2, seed=0, num_threads=1),
              **bad}
        with pytest.raises(ValueError):
            native.sample_neighbors(indptr, indices, **kw)


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                          tmp_path):
    bad = tmp_path / "graph_sampler.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()
    assert not list((tmp_path / "build").iterdir())   # no file left behind


def test_build_is_keyed_by_the_source():
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.build() == lib                      # built once
    assert native.SOURCE.parent.name == "host"        # not a csrc/*.cu
    assert native.SOURCE not in sk.sources()


# -- graph_csr and sample_adj against the JAX package ------------------------

def test_graph_csr_matches_jax(graphs):
    gj, gt = graphs
    for a, b in zip(js.graph_csr(gj), ts.graph_csr(gt)):
        np.testing.assert_array_equal(b, np.asarray(a))
        assert b.dtype == np.asarray(a).dtype


@pytest.mark.usefixtures("jax_numpy_branch")
def test_sample_adj_numpy_branch_matches_jax():
    indptr, indices = _csr_with_holes()
    seeds = np.array([0, 3, 9, 5, 9, 1, 8])
    a = js.sample_adj(indptr, indices, seeds, 4, np.random.default_rng(2))
    b = ts.sample_adj(indptr, indices, seeds, 4, np.random.default_rng(2),
                      backend="numpy")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)


def test_sample_adj_native_takes_one_seed_from_the_generator():
    indptr, indices = _csr_with_holes()
    seeds = np.array([0, 3, 9, 5])
    rng, twin = np.random.default_rng(4), np.random.default_rng(4)
    src, dst, mask = ts.sample_adj(indptr, indices, seeds, 3, rng,
                                   num_threads=2)
    seed = int(twin.integers(0, 2 ** 62))
    ref = native.sample_neighbors_reference(indptr, indices, seeds, 3, seed, 2)
    np.testing.assert_array_equal(src, ref[0])
    np.testing.assert_array_equal(mask, ref[1])
    np.testing.assert_array_equal(dst, np.repeat(np.arange(4), 3))
    assert rng.random() == twin.random()              # advanced alike
    with pytest.raises(ValueError, match="backend"):
        ts.sample_adj(indptr, indices, seeds, 3, rng, backend="cuda")


# -- NeighborSampler against the JAX sampler ---------------------------------

def _assert_same_batch(bj, bt):
    (blocks_j, frame_j, seeds_j), (blocks_t, frame_t, seeds_t) = bj, bt
    np.testing.assert_array_equal(frame_t, frame_j)
    np.testing.assert_array_equal(seeds_t, seeds_j)
    assert len(blocks_t) == len(blocks_j)
    for a, b in zip(blocks_j, blocks_t):
        for name in ("row_ptr", "row", "col", "edge_weight", "x", "y",
                     "train_mask"):
            va, vb = getattr(a, name), getattr(b, name)
            assert (va is None) == (vb is None), name
            if va is not None:
                np.testing.assert_array_equal(vb.numpy(), np.asarray(va),
                                              err_msg=name)
        assert (b.n_pad, b.e_pad, b.num_nodes, b.num_edges) == (
            a.n_pad, a.e_pad, a.num_nodes, a.num_edges)
    ej, et = blocks_j[0].extras, blocks_t[0].extras
    assert (ej is None) == (et is None)
    if ej:
        np.testing.assert_array_equal(et["frame"].numpy(),
                                      np.asarray(ej["frame"]))
        np.testing.assert_array_equal(et["x_table"].numpy(),
                                      np.asarray(ej["x_table"]))


@pytest.mark.usefixtures("jax_numpy_branch")
@pytest.mark.parametrize("batch,device_features", [(8, False), (8, True),
                                                   (37, False), (200, True)])
def test_sampler_matches_jax_over_epochs(graphs, batch, device_features):
    """Frames, blocks, rows of x / y / train_mask, and frame / x_table under
    ``device_features``, over the init draw and two epochs (the last batch
    wrap-padded; B=200 exceeds the 90 train ids)."""
    gj, gt = graphs
    kw = dict(batch_size=batch, seed=6, device_features=device_features)
    sj = js.NeighborSampler(gj, FANOUTS, **kw)
    st = ts.NeighborSampler(gt, FANOUTS, backend="numpy", **kw)
    assert len(st) == len(sj) and st.num_threads is None
    assert st.layer_sizes == sj.layer_sizes
    _assert_same_batch(next(sj.epoch(shuffle=False)),
                       next(st.epoch(shuffle=False)))
    for _ in range(2):
        pairs = list(zip(sj.epoch(), st.epoch()))
        assert len(pairs) == len(st)
        for a, b in pairs:
            _assert_same_batch(a, b)
    if device_features:
        assert pairs[0][1][0][0].extras["x_table"] is gt.x


@pytest.mark.usefixtures("jax_numpy_branch")
def test_zero_degree_seed_expands_around_itself():
    ei = np.array([[0, 1, 2, 0, 1], [1, 2, 0, 2, 0]])
    kw = dict(num_nodes=4, y=np.arange(4) % 2, train_mask=np.ones(4, bool))
    sj = js.NeighborSampler(jg.from_coo(ei, **kw), (3,), batch_size=4)
    st = ts.NeighborSampler(tg.from_coo(ei, **kw), (3,), batch_size=4,
                            backend="numpy")
    bj, bt = next(sj.epoch()), next(st.epoch())
    _assert_same_batch(bj, bt)
    blocks, frame, _ = bt
    # node 3 has no in-edge: its slots are masked out of the block
    r = int(np.nonzero(frame == 3)[0][0])
    b = blocks[0]
    assert not bool((b.row[: b.num_edges] == r).any())


def test_native_sampler_draws_the_library_and_keeps_its_thread_count(graphs):
    _, gt = graphs
    st = ts.NeighborSampler(gt, FANOUTS, batch_size=B, seed=1, num_threads=3)
    assert st.num_threads == 3
    assert ts.NeighborSampler(gt, FANOUTS).num_threads == native.max_threads()
    blocks, frame, seeds = next(st.epoch())
    # every live slot is an edge of the graph, relabelled into the frame
    E = gt.num_edges
    real = set(zip(gt.row[:E].tolist(), gt.col[:E].tolist()))
    for b in blocks:
        rows = frame[b.row[: b.num_edges].numpy()]
        cols = frame[b.col[: b.num_edges].numpy()]
        assert set(zip(rows.tolist(), cols.tolist())) <= real
    np.testing.assert_array_equal(frame[:B], seeds)  # distinct train ids
    with pytest.raises(ValueError, match="backend"):
        ts.NeighborSampler(gt, FANOUTS, backend="torch")
    empty = gt.replace(train_mask=torch.zeros_like(gt.train_mask))
    with pytest.raises(ValueError, match="no seed nodes"):
        ts.NeighborSampler(empty, FANOUTS)


# -- the models over host-sampled blocks -------------------------------------

def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _carried(gj):
    """One JAX host-sampled batch, its arrays carried into the port's
    Graphs."""
    bj, _, _ = next(js.NeighborSampler(gj, FANOUTS, batch_size=B,
                                       seed=2).epoch())
    bt = []
    for b in bj:
        t = {name: torch.from_numpy(np.array(getattr(b, name)))
             for name in ("row_ptr", "row", "col", "edge_weight", "x", "y",
                          "train_mask")}
        bt.append(tg.Graph(num_nodes=b.num_nodes, num_edges=b.num_edges,
                           **t))
    return list(bj), bt


MODELS = {
    "sage-mean": ("graphsage", JGraphSAGE, {"aggr": "mean"}),
    "sage-sum": ("graphsage", JGraphSAGE, {"aggr": "sum"}),
    "sage-gcn": ("graphsage", JGraphSAGE, {"aggr": "gcn"}),
    "sage-max": ("graphsage", JGraphSAGE, {"aggr": "max"}),
    "gat": ("gat", JGAT, {"nhead": 2, "attn_drop": 0.0}),
}


@pytest.mark.usefixtures("jax_numpy_branch")
@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_over_carried_host_blocks_match(graphs, name, structure):
    """Logits and parameter grads of the wrapper's loss (the first B frame
    rows that are train nodes) over the same blocks with the same weights,
    dropout 0. ``structure``: each block carries ``prepare_spmm``'s
    structure, so ``sum``/``gcn`` and GAT take K1's and K3's plain versions
    (what the card runs as kernels)."""
    gj, _ = graphs
    model, jcls, cfg = MODELS[name]
    kw = dict(in_features=gj.x.shape[1], out_features=4, hidden_size=6,
              dropout=0.0, **cfg)
    bj, bt = _carried(gj)
    if structure:
        bt = [prepare_spmm(b) for b in bt]
    jm = jcls(**kw)
    variables = jm.init({"params": jax.random.PRNGKey(2),
                         "dropout": jax.random.PRNGKey(2)}, bj, bj[0].x,
                        training=False)
    tm = build_model(model, **kw)
    load_jax_params(tm, _host(variables["params"]))
    mask_j = jnp.zeros(bj[0].n_pad, bool).at[:B].set(True) & bj[0].train_mask

    def loss_j(params):
        logits = jm.apply({"params": params}, bj, bj[0].x, training=False)
        return j_mce(logits, bj[0].y, mask_j), logits

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    sk.reset_launch_counts()
    out_t = tm(bt, bt[0].x, training=False)
    masked_cross_entropy(out_t[:B], bt[0].y[:B],
                         bt[0].train_mask[:B]).backward()
    assert sk.gat_pass.launches == sk.spmm_csr.launches == 0   # CPU: plain
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    ref = build_model(model, **kw)
    load_jax_params(ref, _host(grads_j))
    ref_params = dict(ref.named_parameters())
    for pname, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[pname].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=pname)


def test_host_block_structure_fits_the_kernels_cut(graphs):
    """A host block's structure: its live edges only (the sink row, which
    holds the pad edges, has none), rows without an edge everywhere past
    the frontier, and a schedule that K1's and K3's chunked plain versions
    (which raise on a schedule that does not fit) cut like the plain
    versions, in both directions and also at 2 edges a chunk, where the CSC
    has rows cut across chunks; and a block with no live edge."""
    _, gt = graphs
    st = ts.NeighborSampler(gt, FANOUTS, batch_size=B, seed=3)
    blocks, _, _ = next(st.epoch())
    empty = tg.from_coo(np.zeros((2, 0), np.int64), num_nodes=blocks[0].num_nodes,
                        n_pad=blocks[0].n_pad, e_pad=blocks[-1].e_pad)
    gen = torch.Generator().manual_seed(0)
    seed = torch.tensor([7], dtype=torch.int64)
    for b in blocks + [empty]:
        g = prepare_spmm(b)
        ex = g.extras
        n = g.n_pad
        assert int(ex["spmm_fw_ptr"][-1]) == b.num_edges
        assert int(ex["spmm_fw_ptr"][-1] - ex["spmm_fw_ptr"][-2]) == 0
        assert int((ex["spmm_fw_ptr"][1:] > ex["spmm_fw_ptr"][:-1]).sum()) \
            < n // 2
        x = torch.randn(n, 5, generator=gen)
        sd, ss, dagg = (torch.randn(n, 2, generator=gen),
                        torch.randn(n, 2, generator=gen),
                        torch.randn(n, 6, generator=gen))
        h2, dden = torch.randn(n, 6, generator=gen), torch.randn(n, 2,
                                                                 generator=gen)
        smax = ss.amax(0)
        for d in ("fw", "bw"):
            ptr, col, w, orig = (ex[f"spmm_{d}_{k}"]
                                 for k in ("ptr", "col", "w", "orig"))
            for sched in (stored_schedule(ex, d),
                          build_spmm_schedule(ptr, chunk_edges=2,
                                              erow=stored_schedule(ex, d).erow)):
                torch.testing.assert_close(
                    sk.spmm_csr_chunked_reference(ptr, col, w, x, sched),
                    sk.spmm_csr_reference(ptr, col, w, x),
                    rtol=FWD_RTOL, atol=FWD_ATOL)
                for mode in sk.GAT_MODES:
                    if (mode == "dsrc") != (d == "bw"):
                        continue
                    back = () if mode == "fwd" else (dagg, dden)
                    kw = dict(alpha=0.2, attn_drop=0.5, seed=seed)
                    args = (mode, ptr, col, orig, sd, ss, smax, h2, *back)
                    for a, r in zip(
                            sk.gat_pass_chunked_reference(*args, schedule=sched,
                                                      **kw),
                            sk.gat_pass_reference(*args, **kw)):
                        torch.testing.assert_close(a, r, rtol=FWD_RTOL,
                                                   atol=FWD_ATOL)


# -- the wrapper through experiment() against the JAX trainer ----------------

class _Recorder:
    """A JAX trainer logger that keeps each eval point's train loss."""

    def __init__(self):
        self.losses = []

    def start(self):
        pass

    def note(self, metrics, step):
        self.losses.append(metrics["train_loss"])

    def finish(self):
        pass


@pytest.mark.usefixtures("jax_numpy_branch")
def test_wrapper_loss_curve_matches_the_jax_trainer(monkeypatch):
    """``experiment(wrapper="neighbor_sampling", backend="numpy")`` against
    ``cogdl_tpu.experiments.train`` from the JAX initial weights: the same
    per-epoch mean train losses, which holds ``init``'s draw (it shifts
    every later batch) and the loss's per-frame train mask."""
    kw = dict(wrapper="neighbor_sampling", fanouts=FANOUTS, batch_size=B,
              epochs=3, eval_step=1, patience=100, seed=0, hidden_size=16,
              dropout=0.0)
    rec = _Recorder()
    res_j = j_train("sbm", "graphsage", logger=rec, **kw)
    # the JAX trainer's initial weights: the second half of split(key(seed))
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    gj = j_sbm()
    bj, _, _ = next(js.NeighborSampler(gj, FANOUTS, batch_size=B).epoch())
    params = _host(JGraphSAGE(in_features=gj.x.shape[1], out_features=4,
                              hidden_size=16, dropout=0.0).init(
        {"params": init_rng, "dropout": init_rng}, bj, bj[0].x,
        training=False)["params"])
    monkeypatch.setattr(NodeClfWrapper, "init",
                        lambda self, gen, graph: load_jax_params(self.model,
                                                                 params))
    steps = []
    real_step = Trainer.train_step

    def step(self, *a):
        loss = real_step(self, *a)
        steps.append(float(loss))
        return loss

    monkeypatch.setattr(Trainer, "train_step", step)
    res_t = experiment(dataset="sbm", model="graphsage", device="cpu",
                       backend="numpy", **kw)
    (res_t,) = res_t[("sbm", "graphsage")]
    per_epoch = len(steps) // 3
    assert per_epoch == 15 and len(steps) == 45      # 120 train ids, B=8
    means = [np.mean(steps[i * per_epoch: (i + 1) * per_epoch])
             for i in range(3)]
    np.testing.assert_allclose(means, rec.losses, rtol=LOSS_RTOL)
    assert res_t["train_loss"] == pytest.approx(rec.losses[-1], rel=LOSS_RTOL)
    assert res_t["best_epoch"] == res_j["best_epoch"]


def test_wrapper_draws_the_init_batch_and_learns(graphs):
    """``init`` consumes the sampler's generator as the JAX wrapper's does;
    a CPU run through the registry learns sbm."""
    _, gt = graphs
    model = build_model("graphsage", in_features=gt.num_features,
                        out_features=4, hidden_size=8)
    w, twin = (fetch_wrapper("neighbor_sampling")(model, fanouts=FANOUTS,
                                                  batch_size=B, seed=5,
                                                  backend="numpy")
               for _ in range(2))
    assert type(w) is SampledNodeClfWrapper
    for x in (w, twin):
        x.prepare_graph(gt)
    w.init(torch.Generator().manual_seed(0), gt)
    twin.draw_init_batch()
    assert w._sampler.rng.random() == twin._sampler.rng.random()
    res = experiment(dataset="sbm", model="graphsage",
                     wrapper="neighbor_sampling", fanouts=(5, 5),
                     batch_size=64, epochs=15, eval_step=5, device="cpu")
    (res,) = res[("sbm", "graphsage")]
    assert res["test_acc"] > 0.9, res


@pytest.mark.parametrize("model,kw,reads", [
    ("graphsage", {"aggr": "mean"}, False),
    ("graphsage", {"aggr": "max"}, False),
    ("graphsage", {"aggr": "sum"}, True),
    ("graphsage", {"aggr": "gcn"}, True),
    ("gat", {}, True),
])
def test_batches_carry_the_kernel_structure_when_the_model_reads_it(
        graphs, model, kw, reads):
    _, gt = graphs
    net = build_model(model, in_features=gt.num_features, out_features=4,
                      **kw)
    assert reads_kernel_structure(net) == reads
    w = SampledNodeClfWrapper(net, fanouts=FANOUTS, batch_size=B)
    w.prepare_graph(gt)
    batches = list(w.train_batches(gt))
    assert len(batches) == len(w._sampler) and len(w.host_ms) == len(batches)
    for blocks in batches:
        for b in blocks:
            assert ("spmm_fw_orig" in (b.extras or {})) == reads
    sample_ms, structure_ms = zip(*w.host_ms)
    assert min(sample_ms) > 0
    assert all((ms is not None and ms > 0) == reads for ms in structure_ms)


# -- Prefetcher --------------------------------------------------------------

def test_prefetcher_order_restart_and_errors():
    pf = ts.Prefetcher(lambda: iter(range(7)))
    assert list(pf) == list(range(7))
    assert list(pf) == list(range(7))     # restartable (one thread an epoch)

    def bad():
        yield 1
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(ts.Prefetcher(bad))


def test_prefetcher_on_the_cpu_hands_batches_through():
    t = torch.arange(4)
    (out,) = list(ts.Prefetcher(lambda: iter([(t, {"a": t})]), device="cpu"))
    assert out[0] is t and out[1]["a"] is t


def test_prefetcher_runs_ahead_by_its_depth_and_stops_when_abandoned():
    made = []

    def factory():
        for i in range(100):
            made.append(i)
            yield i

    threads = threading.active_count()
    it = iter(ts.Prefetcher(factory, depth=3))
    assert next(it) == 0
    deadline = time.time() + 5
    while len(made) < 5 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    # one handed out, three queued, one waiting to be queued
    assert len(made) == 5
    it.close()
    assert len(made) == 5
    assert threading.active_count() == threads    # the worker has ended


def test_prefetcher_under_frequent_thread_switches():
    """Many short epochs, some abandoned early, with the interpreter
    switching threads every microsecond: every batch arrives once and in
    order, and no worker outlives its iterator."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = threading.active_count()
        for depth in (1, 2, 5):
            pf = ts.Prefetcher(lambda: iter(range(300)), depth=depth)
            for _ in range(3):
                assert list(pf) == list(range(300))
                it = iter(pf)
                assert [next(it) for _ in range(7)] == list(range(7))
                it.close()
        assert threading.active_count() == threads
    finally:
        sys.setswitchinterval(old)
