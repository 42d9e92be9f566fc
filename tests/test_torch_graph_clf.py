"""cogdl_tpu_torch's graph classification (union batches, the
``random-graphs`` set, GINLayer, GIN, SortPool, DiffPool and the
``graph_classification`` wrapper) against the JAX package on the CPU.

The data must be the JAX package's array for array: the same graphs for a
seed, the same union batches in the same shuffled order. Each model gets
the JAX model's initial variables through ``load_jax_params`` and is held
at 1e-5 (logits) and 1e-4 (gradients of the masked per-graph
cross-entropy), over a batch with and without ``prepare_spmm``'s structure
(K1's plain version on the CPU); GIN's running statistics against flax's
after two training calls on batches of different real sizes; and the
wrapper's per-epoch losses through ``experiment()`` against the JAX
trainer's at dropout 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogdl_tpu.data.batch import make_batches as j_make_batches
from cogdl_tpu.data.batch import union_batch as j_union_batch
from cogdl_tpu.datasets import build_dataset as j_build_dataset
from cogdl_tpu.datasets.dataset import Dataset as JDataset
from cogdl_tpu.datasets.synthetic import random_graphs_dataset as j_rg
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.layers.gin_layer import GINLayer as JGINLayer
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.wrappers.graph_classification import (
    GraphClfWrapper as JGraphClfWrapper,
)
from cogdl_tpu_torch.data.batch import make_batches, union_batch
from cogdl_tpu_torch.datasets import build_dataset
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import random_graphs_dataset as t_rg
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.layers import GINLayer
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.trainer.trainer import Trainer
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from cogdl_tpu_torch.wrappers import DEFAULT_WRAPPER, fetch_wrapper
from cogdl_tpu_torch.wrappers.graph_classification import GraphClfWrapper
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from cogdl_tpu_torch.wrappers.sampled_node_classification import (
    reads_kernel_structure,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-4
F_IN, CLASSES = 6, 2
# 6-20 nodes a graph: some below SortPool's k=16, which then pads with
# zero rows
SET = dict(num_graphs=24, min_nodes=6, max_nodes=20, feat_dim=F_IN, seed=3)
CASES = {
    "gin-sum": ("gin", dict(hidden_size=8, num_layers=3)),
    "gin-mean": ("gin", dict(hidden_size=8, num_layers=4, pooling="mean")),
    "gin-fixed-eps": ("gin", dict(hidden_size=8, num_layers=2, eps=0.25,
                                  train_eps=False)),
    "sortpool": ("sortpool", dict(hidden_size=8, k=16)),
    "diffpool": ("diffpool", dict(hidden_size=8, num_clusters=4)),
}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


@pytest.fixture(scope="module")
def sets():
    """The same small multi-graph set in both packages, and each package's
    batches of 10 (shuffled at seed 1)."""
    (gj, yj), (gt, yt) = j_rg(**SET), t_rg(**SET)
    return (gj, yj, j_make_batches(gj, yj, 10, seed=1),
            gt, yt, make_batches(gt, yt, 10, seed=1))


def _assert_graphs_equal(a, b):
    """A JAX graph ``a`` and a port graph ``b``: the same arrays."""
    assert (a.num_nodes, a.num_edges, a.n_pad, a.e_pad) == (
        b.num_nodes, b.num_edges, b.n_pad, b.e_pad)
    for f in ("row_ptr", "row", "col", "edge_weight", "x", "y"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(np.asarray(va), _np(vb), err_msg=f)
    assert dict(a.meta) == dict(b.meta)
    assert set(a.extras or {}) == set(b.extras or {})
    for k in a.extras or {}:
        np.testing.assert_array_equal(np.asarray(a.extras[k]),
                                      _np(b.extras[k]), err_msg=k)


def test_random_graphs_are_the_jax_packages(sets):
    gj, yj, _, gt, yt, _ = sets
    np.testing.assert_array_equal(yj, yt)
    assert len(gj) == len(gt) == SET["num_graphs"]
    for a, b in zip(gj, gt):
        _assert_graphs_equal(a, b)


def test_build_dataset_random_graphs():
    ds = build_dataset("random-graphs", num_graphs=8, feat_dim=5, seed=2)
    jd = j_build_dataset("random-graphs", num_graphs=8, feat_dim=5, seed=2)
    assert ds.graph is None and len(ds) == len(jd) == 8
    assert (ds.num_features, ds.num_classes) == (jd.num_features,
                                                 jd.num_classes) == (5, 2)
    np.testing.assert_array_equal(ds.labels, jd.labels)
    assert ds.split_idx is None
    assert repr(ds) == "Dataset(random-graphs, 8 graphs)"


def test_union_batches_are_the_jax_packages(sets):
    """Every batch of the shuffled list: ``row``, ``col``, weights,
    features, ``graph_id``, ``graph_mask``, ``graph_y``, ``n_pad`` and
    ``e_pad``, in the same order; and one union at its own sizes."""
    gj, yj, bj, gt, yt, bt = sets
    assert len(bj) == len(bt) == 3
    for a, b in zip(bj, bt):
        _assert_graphs_equal(a, b)
    assert len({(b.n_pad, b.e_pad) for b in bt}) == 1
    assert bt[0].meta_get("num_graphs") == 12      # _bucket(10 + 1)
    gid = _np(bt[-1].extras["graph_id"])
    assert (gid[bt[-1].num_nodes:] == 11).all()
    assert _np(bt[-1].extras["graph_mask"]).sum() == 4
    _assert_graphs_equal(j_union_batch(gj[:3], yj[:3]),
                         union_batch(gt[:3], yt[:3]))
    # no shuffle keeps the order
    for a, b in zip(j_make_batches(gj, yj, 7, shuffle=False),
                    make_batches(gt, yt, 7, shuffle=False)):
        _assert_graphs_equal(a, b)


def _per_graph_ce_j(logits, b):
    logp = jax.nn.log_softmax(logits, axis=-1)
    per = -jnp.take_along_axis(logp, b.extras["graph_y"][:, None],
                               axis=-1).squeeze(-1)
    m = b.extras["graph_mask"].astype(logits.dtype)
    return jnp.sum(per * m) / jnp.maximum(jnp.sum(m), 1.0)


def _assert_grads(tm, grads_j, build):
    ref = load_jax_params(build(), _host(grads_j))
    ref_params = dict(ref.named_parameters())
    assert set(ref_params) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[name].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _run_both(jm, tm_build, bj, bt, structure, training, variables=None):
    """The JAX module ``jm`` and the port module carrying its variables,
    on one batch: logits within 1e-5, loss gradients within 1e-4. Returns
    the port module and the JAX variables after the call."""
    if variables is None:
        variables = _host(jm.init({"params": jax.random.PRNGKey(2),
                                   "dropout": jax.random.PRNGKey(2)},
                                  bj, bj.x, training=False))
    tm = load_jax_params(tm_build(), variables["params"],
                         variables.get("batch_stats"))
    mutable = ["batch_stats"] if training and "batch_stats" in variables \
        else False

    def loss_j(params):
        out = jm.apply({**variables, "params": params}, bj, bj.x,
                       training=training, mutable=mutable)
        logits, upd = out if mutable else (out, {})
        return _per_graph_ce_j(logits, bj), (logits, upd)

    (_, (logits_j, upd)), grads_j = jax.value_and_grad(
        loss_j, has_aux=True)(variables["params"])
    b = prepare_spmm(bt) if structure else bt
    logits_t = tm(b, b.x, training=training)
    masked_cross_entropy(logits_t, b.extras["graph_y"],
                         b.extras["graph_mask"]).backward()
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    _assert_grads(tm, grads_j, tm_build)
    return tm, {**variables, **_host(upd)}


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_gin_layer_matches_jax(sets, structure, training):
    """Per-node outputs of one GIN layer (sum over the batch's node rows as
    the loss), batch norm in both modes."""
    _, _, bj, _, _, bt = sets

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gin = GINLayer(F_IN, 8, eps=0.1)

    jl = JGINLayer(8, eps=0.1)
    variables = _host(jl.init(jax.random.PRNGKey(4), bj[0], bj[0].x))
    tm = Head()
    load_jax_params(tm, {"gin": variables["params"]},
                    {"gin": variables["batch_stats"]})
    mask = np.asarray(bj[0].node_mask(), np.float32)[:, None]

    def loss_j(params):
        out = jl.apply({"params": params,
                        "batch_stats": variables["batch_stats"]},
                       bj[0], bj[0].x, training=training,
                       mutable=["batch_stats"] if training else False)
        out = out[0] if training else out
        return jnp.sum(jnp.sin(out) * mask), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    b = prepare_spmm(bt[0]) if structure else bt[0]
    out_t = tm.gin(b, b.x, training=training)
    (torch.sin(out_t) * torch.from_numpy(mask)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    _assert_grads(tm, {"gin": grads_j}, Head)
    assert tm.gin.eps.shape == () and float(tm.gin.eps.detach()) == \
        pytest.approx(0.1)


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_jax(sets, name, structure):
    """Eval mode (running statistics) on the last, part-filled batch."""
    _, _, bj, _, _, bt = sets
    model, kw = CASES[name]
    kw = dict(in_features=F_IN, out_features=CLASSES, dropout=0.0, **kw)
    _run_both(j_build_model(model, **kw), lambda: build_model(model, **kw),
              bj[-1], bt[-1], structure, training=False)


@pytest.mark.parametrize("structure", [False, True])
def test_sortpool_breaks_ties_as_jax_top_k(sets, structure):
    """The last GCN layer's weights scaled by 100 saturate its tanh, so
    that many real rows of a graph share the key 1.0 or -1.0: the rows
    kept and their order are still the JAX package's (lower node index
    first among equal keys)."""
    _, _, bj, _, _, bt = sets
    kw = dict(in_features=F_IN, out_features=CLASSES, dropout=0.0,
              hidden_size=8, k=16)
    jm = j_build_model("sortpool", **kw)
    variables = _host(jm.init({"params": jax.random.PRNGKey(2),
                               "dropout": jax.random.PRNGKey(2)},
                              bj[0], bj[0].x, training=False))
    lin = variables["params"]["gcn2"]["linear"]
    lin["kernel"] = lin["kernel"] * 100.0
    tm, _ = _run_both(jm, lambda: build_model("sortpool", **kw), bj[0],
                      bt[0], structure, training=False, variables=variables)
    seen = {}
    tm.gcn2.register_forward_hook(lambda mod, a, out: seen.update(
        key=out[:, -1]))
    with torch.no_grad():
        tm(bt[0])
    key = seen["key"][: bt[0].num_nodes]
    assert int((key.abs() == 1.0).sum()) > bt[0].num_nodes // 4


@pytest.mark.parametrize("model", ["gin", "sortpool", "diffpool"])
def test_load_jax_params_refuses_a_leaf_left_over(sets, model):
    """Every leaf of the JAX variables (GIN's scalar ``eps`` and its
    ``bn`` statistics among them) has its place in the port model; one
    more leaf raises."""
    _, _, bj, _, _, _ = sets
    kw = dict(in_features=F_IN, out_features=CLASSES)
    variables = _host(j_build_model(model, **kw).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        bj[0], bj[0].x, training=False))
    stats = variables.get("batch_stats")
    tm = load_jax_params(build_model(model, **kw), variables["params"], stats)
    if model == "gin":
        assert tm.gin0.eps.shape == () and set(stats["gin0"]["bn"]) == {
            "mean", "var"}
    extra = dict(variables["params"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(build_model(model, **kw), extra, stats)


def test_sortpool_keeps_each_graphs_top_rows_in_order(sets):
    """The rows SortPool keeps are each graph's k rows with the largest
    last channel, in descending order, as a per-graph sort finds them; a
    graph of fewer than k nodes pads with zero rows. The real rows' keys
    are all distinct here, so any correct order is this one."""
    _, _, _, gt, yt, _ = sets
    b = union_batch(gt[:4], yt[:4])
    k = 16
    m = build_model("sortpool", in_features=F_IN, out_features=CLASSES,
                    k=k, dropout=0.0)
    m.reset_parameters(torch.Generator().manual_seed(0))
    seen = {}
    for i in range(3):
        getattr(m, f"gcn{i}").register_forward_hook(
            lambda mod, args, out, i=i: seen.update({i: out}))
    m.fc1.register_forward_pre_hook(
        lambda mod, args: seen.update(z=args[0]))
    with torch.no_grad():
        m(b)
    h = torch.cat([seen[i] for i in range(3)], -1)
    z = seen["z"].reshape(b.meta_get("num_graphs"), k, h.shape[-1])
    gid = b.extras["graph_id"]
    sizes = [int((gid == g).sum()) for g in range(4)]
    assert min(sizes) < k < max(sizes)
    for g, n in enumerate(sizes):
        rows = h[gid == g]
        assert rows[:, -1].unique().numel() == n
        want = rows[torch.argsort(rows[:, -1], descending=True)][:k]
        torch.testing.assert_close(z[g, : min(n, k)], want, rtol=0, atol=0)
        assert torch.count_nonzero(z[g, min(n, k):]) == 0
    assert torch.count_nonzero(z[4:]) == 0


def test_gin_batch_stats_follow_flax_over_two_training_calls(sets):
    """Two training calls on batches of different real sizes: the running
    mean and variance after each equal flax's ``batch_stats`` (momentum
    0.99, over each batch's real nodes)."""
    _, _, bj, _, _, bt = sets
    assert bt[0].num_nodes != bt[-1].num_nodes
    kw = dict(in_features=F_IN, out_features=CLASSES, dropout=0.0,
              hidden_size=8, num_layers=3)
    jm = j_build_model("gin", **kw)
    tm, variables = _run_both(jm, lambda: build_model("gin", **kw), bj[0],
                              bt[0], structure=True, training=True)
    _, variables2 = _run_both(jm, lambda: build_model("gin", **kw), bj[-1],
                              bt[-1], structure=True, training=True,
                              variables=variables)
    stats = load_jax_params(build_model("gin", **kw), variables2["params"],
                            variables2["batch_stats"])
    tm.zero_grad()
    tm(bt[-1], bt[-1].x, training=True)
    buffers = dict(stats.named_buffers())
    assert set(buffers) == {f"gin{i}.bn.{k}" for i in range(2)
                            for k in ("mean", "var")}
    for key, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), buffers[key].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert not torch.equal(buffers["gin0.bn.var"], torch.ones(8))


def test_registry_defaults_and_structure():
    for name in ("gin", "sortpool", "diffpool"):
        assert DEFAULT_WRAPPER[name] == "graph_classification"
        net = build_model(name, in_features=F_IN, out_features=CLASSES)
        assert reads_kernel_structure(net), name
    assert fetch_wrapper("graph_classification") is GraphClfWrapper
    assert GraphClfWrapper.jit_eval is False


# -- the wrapper and experiment() ---------------------------------------------

def test_wrapper_splits_and_batches_are_the_jax_packages():
    """The seeded split and its batches, and the batches' structure built
    once by ``to_device`` when the model reads it."""
    jd = j_build_dataset("random-graphs", num_graphs=30, feat_dim=F_IN)
    td = build_dataset("random-graphs", num_graphs=30, feat_dim=F_IN)
    jm = j_build_model("gin", in_features=F_IN, out_features=CLASSES)
    tm = build_model("gin", in_features=F_IN, out_features=CLASSES)
    jw = JGraphClfWrapper(jm, jd, batch_size=8, seed=4)
    tw = GraphClfWrapper(tm, td, batch_size=8, seed=4)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(jw._splits[split], tw._splits[split])
        assert len(jw._batches[split]) == len(tw._batches[split])
        for a, b in zip(jw._batches[split], tw._batches[split]):
            _assert_graphs_equal(a, b)
    tw.to_device("cpu")
    train = tw.train_batches()
    assert train is tw.train_batches()
    assert all("spmm_fw_ptr" in b.extras for split in tw._batches.values()
               for b in split)
    mlp = GraphClfWrapper(build_model("mlp", in_features=F_IN,
                                      out_features=CLASSES), td, 8)
    mlp.to_device("cpu")
    assert not any("spmm_fw_ptr" in b.extras for b in mlp.train_batches())


def test_trainer_without_a_graph_needs_a_wrapper_with_batches():
    model = build_model("gcn", in_features=4, out_features=2)
    with pytest.raises(ValueError, match="no graph"):
        Trainer(device="cpu", epochs=1).run(NodeClfWrapper(model), None)


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


@pytest.mark.parametrize("model", ["gin", "diffpool"])
def test_loss_curve_matches_the_jax_trainer(monkeypatch, model):
    """``experiment()`` on a 36-graph ``random-graphs`` set against
    ``cogdl_tpu.experiments.train`` from the JAX initial variables (the
    second half of ``split(key(0))``; their shapes do not depend on the
    batch), dropout 0, three epochs of three batches: each epoch's mean
    train loss, the best epoch and the accuracies (GIN's running
    statistics through the evaluations and the best snapshot)."""
    mkw = dict(hidden_size=16, num_layers=3) if model == "gin" else dict(
        hidden_size=16, num_clusters=4)
    kw = dict(epochs=3, eval_step=1, patience=100, seed=0, dropout=0.0,
              batch_size=9, **mkw)
    jd = j_build_dataset("random-graphs", num_graphs=36)
    td = build_dataset("random-graphs", num_graphs=36)
    rec = _Recorder()
    res_j = j_train(jd, model, logger=rec, **kw)
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    b = j_union_batch(jd.graphs[:2], jd.labels[:2])
    variables = _host(j_build_model(
        model, in_features=jd.num_features, out_features=jd.num_classes,
        dropout=0.0, **mkw).init({"params": init_rng, "dropout": init_rng},
                                 b, b.x, training=False))
    monkeypatch.setattr(
        GraphClfWrapper, "init", lambda self, gen, graph=None:
        load_jax_params(self.model, variables["params"],
                        variables.get("batch_stats")))
    steps = []
    real_step = Trainer.train_step

    def step(self, *a):
        loss = real_step(self, *a)
        steps.append(float(loss))
        return loss

    monkeypatch.setattr(Trainer, "train_step", step)
    sk.reset_launch_counts()
    (res_t,) = experiment(dataset=td, model=model, device="cpu",
                          **kw)[("random-graphs", model)]
    assert len(steps) == 3 * 3      # 25 train graphs in batches of 9
    per_epoch = np.asarray(steps).reshape(3, 3).mean(1)
    np.testing.assert_allclose(per_epoch, rec.losses, rtol=LOSS_RTOL)
    assert res_t["best_epoch"] == res_j["best_epoch"]
    for split in ("train_acc", "val_acc", "test_acc"):
        assert res_t[split] == pytest.approx(res_j[split], abs=1e-6), split
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)


def test_official_split_is_honoured():
    """A set with ``split_idx`` (``tests/test_tasks.py``'s
    ``test_graph_classification_official_split`` shape: 12 graphs, 8 / 2 /
    2): the wrapper takes those indices and builds the JAX wrapper's
    batches from them, and GIN trains through ``experiment()``."""
    graphs, labels = t_rg(num_graphs=12, min_nodes=6, max_nodes=6,
                          feat_dim=4, seed=0)
    jgraphs, jlabels = j_rg(num_graphs=12, min_nodes=6, max_nodes=6,
                            feat_dim=4, seed=0)
    split = {"train": np.arange(8), "valid": np.arange(8, 10),
             "test": np.arange(10, 12)}
    td = Dataset.from_graphs(graphs, labels, name="official",
                             split_idx=split)
    jd = JDataset.from_graphs(jgraphs, labels=jlabels, name="official")
    jd.split_idx = split
    jw = JGraphClfWrapper(j_build_model("gin", in_features=4,
                                        out_features=2), jd, batch_size=4)
    tw = GraphClfWrapper(build_model("gin", in_features=4, out_features=2),
                         td, batch_size=4)
    assert {k: v.tolist() for k, v in tw._splits.items()} == {
        "train": list(range(8)), "val": [8, 9], "test": [10, 11]}
    for split_name in ("train", "val", "test"):
        for a, b in zip(jw._batches[split_name], tw._batches[split_name],
                        strict=True):
            _assert_graphs_equal(a, b)
    (res,) = experiment(dataset=td, model="gin", epochs=3, eval_step=3,
                        hidden_size=16, batch_size=4, device="cpu"
                        )[("official", "gin")]
    assert 0.0 <= res["test_acc"] <= 1.0
