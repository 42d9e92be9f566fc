"""The port's multi-stage training against the JAX package on the CPU: the
trainer's stage loop, the staged wrappers (SAGN, M3S, C&S), the torch
KMeans against scikit-learn's, and loss curves through ``experiment()``
against the JAX trainer's for ``graph_unet``, ``sagn`` (two stages),
``correct_smooth_mlp`` and ``patchy_san``, and GCNMix's wrapper loss over
five Adam steps at the JAX model's draws."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from sklearn.cluster import KMeans
from sklearn.metrics import adjusted_rand_score

import cogdl_tpu.data.graph as jg
from cogdl_tpu.datasets import build_dataset as j_build_dataset
from cogdl_tpu.datasets.dataset import Dataset as JDataset
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.wrappers import graph_classification as j_gc
from cogdl_tpu.wrappers import node_classification as j_nc
from cogdl_tpu.wrappers import staged as j_staged
from cogdl_tpu_torch.datasets import build_dataset
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from cogdl_tpu_torch.utils.kmeans import kmeans
from cogdl_tpu_torch.wrappers import graph_classification as t_gc
from cogdl_tpu_torch.wrappers import node_classification as t_nc
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from cogdl_tpu_torch.wrappers.staged import (
    CorrectSmoothWrapper,
    M3SWrapper,
    SAGNWrapper,
    expand_labels,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# per-step losses after a few Adam steps from the same weights
# (tests/test_torch_zoo_models.py)
LOSS_RTOL = 1e-4
F_IN, CLASSES, NODES = 12, 4, 200


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _holdout(g, xp):
    """``g`` with every other test node moved out of the splits: ``sbm``
    puts every node in one, which leaves SAGN and M3S no node to label."""
    keep = xp.arange(g.n_pad) % 2 == 0
    return g.replace(test_mask=g.test_mask & keep)


def _graph_pair():
    """The same sbm graph in both packages with half its test nodes in no
    split; the JAX one with self loops, as its wrapper prepares it."""
    return (jg.add_self_loops(_holdout(
                j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5), jnp)),
            _holdout(t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5), torch))


@pytest.fixture(scope="module")
def graphs():
    return _graph_pair()


def _pair(model, seed=0, **kw):
    kw = dict(in_features=F_IN, out_features=CLASSES, dropout=0.0, **kw)
    gj = _graph_pair()[0]
    jm = j_build_model(model, **kw)
    variables = _host(jm.init({"params": jax.random.PRNGKey(seed),
                               "dropout": jax.random.PRNGKey(seed)},
                              gj, gj.x, training=False))
    return jm, variables, load_jax_params(build_model(model, **kw),
                                          variables["params"])


# -- the trainer's stage loop -------------------------------------------------------

def _weights(model):
    return torch.cat([p.detach().flatten().clone()
                      for p in model.parameters()])


class _ToyStaged(NodeClfWrapper):
    """Three stages over a small MLP; the val scores of its evaluations are
    scripted, and every hook records the weights it saw."""

    num_stages = 3

    def __init__(self, model, scores):
        super().__init__(model)
        self.scores = iter(scores)
        self.log = []

    def loss(self, graph, generator=None, training=True):
        self.log.append(("loss", _weights(self.model), graph))
        return super().loss(graph, generator, training)

    def evaluate(self, graph):
        self.log.append(("eval", _weights(self.model), graph))
        return {"val_acc": torch.tensor(next(self.scores))}

    def pre_stage(self, stage, graph):
        self.log.append(("pre", _weights(self.model), stage))
        if stage == 1:
            return graph.replace(y=(graph.y + 1) % CLASSES)
        return None

    def post_stage(self, stage, graph):
        self.log.append(("post", _weights(self.model), stage))


def test_stage_loop_hooks_see_the_best_weights_and_training_goes_on():
    """Patience 2, four epochs a stage. Stage 0 scores 0.5, 0.7, 0.6, 0.65
    (best at epoch 1, stopped after epoch 3); stage 1 0.6, 0.9, 0.8, 0.85
    (patience starts afresh: it runs all four epochs, best at its epoch
    1); stage 2 0.1, 0.2 (stopped; the best stays stage 1's). Each
    ``pre_stage`` and ``post_stage`` sees the best snapshot's weights; the
    first step of a stage trains from the weights the last one left; the
    graph ``pre_stage(1)`` returned is the one trained and evaluated on;
    the final evaluation runs on stage 1's best weights."""
    g = t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5)
    net = build_model("mlp", in_features=F_IN, out_features=CLASSES,
                      hidden_size=8)
    scores = [0.5, 0.7, 0.6, 0.65, 0.6, 0.9, 0.8, 0.85, 0.1, 0.2, 0.95]
    w = _ToyStaged(net, scores)
    res = Trainer(TrainerConfig(epochs=4, patience=2, device="cpu")).run(w, g)
    kinds = [e[0] for e in w.log]
    stage_starts = [i for i, k in enumerate(kinds) if k == "pre"]
    assert len(stage_starts) == 3
    evals = [e for e in w.log if e[0] == "eval"]
    assert len(evals) == len(scores)                 # 4 + 4 + 2 + final
    best0, best1 = evals[1][1], evals[5][1]
    pres = [e for e in w.log if e[0] == "pre"]
    posts = [e for e in w.log if e[0] == "post"]
    assert torch.equal(pres[1][1], best0) and torch.equal(pres[2][1], best1)
    assert [torch.equal(p[1], b) for p, b in zip(
        posts, (best0, best1, best1))] == [True] * 3
    for start, last_eval, pre in ((stage_starts[1], evals[3], pres[1]),
                                  (stage_starts[2], evals[7], pres[2])):
        first_loss = next(e for e in w.log[start:] if e[0] == "loss")
        assert torch.equal(first_loss[1], last_eval[1])
        assert not torch.equal(first_loss[1], pre[1])
    assert torch.equal(evals[-1][1], best1)
    relabelled = (g.y + 1) % CLASSES
    stage1 = w.log[stage_starts[1]:stage_starts[2]]
    assert all(torch.equal(e[2].y, relabelled) for e in stage1
               if e[0] in ("loss", "eval"))
    assert res["best_epoch"] == 1 and res["val_acc"] == pytest.approx(0.95)


def test_a_wrapper_without_stages_runs_one_stage():
    g = t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5)
    net = build_model("mlp", in_features=F_IN, out_features=CLASSES)
    w = NodeClfWrapper(net)
    calls = []
    real = w.evaluate
    w.evaluate = lambda graph: calls.append(1) or real(graph)
    Trainer(TrainerConfig(epochs=3, patience=10, device="cpu")).run(w, g)
    assert len(calls) == 4


# -- the staged wrappers ------------------------------------------------------------

def test_sagn_pre_stage_matches_jax(graphs):
    """At a threshold that takes pseudo-labels: the same ``y`` and
    ``train_mask`` as the JAX ``pre_stage`` from the same weights; val and
    test keep their labels; the kernel structure stays in ``extras``."""
    gj, gt = graphs
    jm, variables, tm = _pair("sagn", hidden_size=16, attn_drop=0.0)
    g = prepare_spmm(SAGNWrapper(tm).normalise(gt))
    want = j_staged.SAGNWrapper(jm, threshold=0.3).pre_stage(1, gj,
                                                             variables)
    w = SAGNWrapper(tm, threshold=0.3)
    assert w.pre_stage(0, g) is None
    got = w.pre_stage(1, g)
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.train_mask.numpy(),
                                  np.asarray(want.train_mask))
    taken = int((got.train_mask & ~g.train_mask).sum())
    assert w.stage_record == {1: {"pseudo_labels": taken}} and 0 < taken
    for m in (g.val_mask, g.test_mask):
        assert torch.equal(got.y[m], g.y[m])
        assert not (got.train_mask & m).any()
    assert got.extras is g.extras


def _m3s_jax_case(graphs, num_new_labels=20):
    gj, _ = graphs
    jm, variables, tm = _pair("m3s", hidden_size=16)
    want = j_staged.M3SWrapper(jm, num_new_labels=num_new_labels).pre_stage(
        1, gj, variables)
    emb = np.asarray(jm.apply(variables, gj, gj.x, method=jm.embed))
    return gj, jm, variables, tm, want, emb


@pytest.mark.parametrize("num_new_labels", [20, 3])
def test_m3s_expansion_equals_jax_given_sklearns_clustering(
        graphs, num_new_labels):
    """``expand_labels`` on scikit-learn's ``KMeans(2C, n_init=3,
    random_state=0)`` of the JAX embeddings equals the JAX ``pre_stage``
    (which runs that clustering itself) exactly."""
    gj, _, _, _, want, emb = _m3s_jax_case(graphs, num_new_labels)
    nmask = np.asarray(gj.node_mask())
    y = np.asarray(gj.y)
    train = np.asarray(gj.train_mask) & nmask
    reserved = train | np.asarray(gj.val_mask) | np.asarray(gj.test_mask)
    C = int(y[nmask].max()) + 1
    km = KMeans(n_clusters=2 * C, n_init=3, random_state=0).fit(emb[nmask])
    new_y, new_train = expand_labels(emb, km.labels_, km.cluster_centers_,
                                     y, train, reserved, nmask, C,
                                     num_new_labels)
    np.testing.assert_array_equal(new_y, np.asarray(want.y))
    np.testing.assert_array_equal(new_train, np.asarray(want.train_mask))
    assert 0 < (new_train & ~train).sum() <= 2 * C * num_new_labels


def test_m3s_pre_stage_expands_with_the_torch_kmeans(graphs):
    """The port's own ``pre_stage`` (its KMeans): labels added to nodes in
    no split only, each a label of a train node; val and test untouched;
    the structure kept."""
    _, gt = graphs
    _, _, tm = _pair("m3s", hidden_size=16)
    w = M3SWrapper(tm, num_new_labels=10)
    g = prepare_spmm(w.normalise(gt))
    assert w.pre_stage(0, g) is None
    got = w.pre_stage(1, g)
    added = got.train_mask & ~g.train_mask
    assert 0 < int(added.sum()) <= 2 * CLASSES * 10
    assert w.stage_record[1]["new_labels"] == int(added.sum())
    assert not (added & (g.val_mask | g.test_mask | ~g.node_mask())).any()
    assert torch.equal(got.y[~added], g.y[~added])
    assert set(got.y[added].tolist()) <= set(g.y[g.train_mask].tolist())
    assert got.extras is g.extras


def test_correct_smooth_wrapper_builds_the_structure_and_runs_k1(
        graphs, monkeypatch):
    """With the card's preparation (``with_structure`` as on a CUDA graph)
    the wrapper builds the kernels' structure for an MLP model, and an
    evaluation runs ``correct_steps + smooth_steps`` calls of K1 (its
    plain version on the CPU) and none in a train step."""
    _, gt = graphs
    monkeypatch.setattr(NodeClfWrapper, "with_structure",
                        staticmethod(prepare_spmm))
    net = build_model("correct_smooth_mlp", in_features=F_IN,
                      out_features=CLASSES, correct_steps=3, smooth_steps=4)
    net.reset_parameters(torch.Generator().manual_seed(0))
    w = CorrectSmoothWrapper(net)
    g = w.prepare_graph(gt)
    assert "spmm_fw_w" in g.extras
    calls = []
    real = sk.spmm_csr

    def count(ptr, col, wt, x, structure="csr", **kw):
        calls.append((structure, x.shape[1]))
        return real(ptr, col, wt, x, structure=structure, **kw)

    monkeypatch.setattr(sk, "spmm_csr", count)
    w.loss(g).backward()
    assert calls == []
    out = w.evaluate(g)
    assert calls == [("csr", CLASSES)] * 7
    assert set(out) == {"train_acc", "val_acc", "test_acc"}


# -- KMeans against scikit-learn -----------------------------------------------------

def test_kmeans_finds_sklearns_clusters_on_separated_blobs():
    """Five blobs ten standard deviations apart: the labels equal
    scikit-learn's up to a relabelling, the inertia to 1e-5; the centres
    are the clusters' means."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(5, 8)) * 10
    X = np.concatenate([c + rng.normal(size=(60, 8))
                        for c in centers]).astype(np.float32)
    ref = KMeans(5, n_init=3, random_state=0).fit(X)
    got = kmeans(torch.from_numpy(X), 5, n_init=3, seed=0)
    assert adjusted_rand_score(ref.labels_, got.labels.numpy()) == 1.0
    assert got.inertia == pytest.approx(ref.inertia_, rel=1e-5)
    for c in range(5):
        np.testing.assert_allclose(got.centers[c].numpy(),
                                   X[got.labels.numpy() == c].mean(0),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def gcn_embeddings():
    """A GCN's penultimate embeddings of the real nodes of ``sbm`` after 50
    epochs through the port's trainer."""
    ds = build_dataset("sbm")
    net = build_model("gcn", in_features=ds.num_features,
                      out_features=ds.num_classes)
    res = Trainer(TrainerConfig(epochs=50, device="cpu", seed=1)).run(
        NodeClfWrapper(net), ds.graph)
    g = res["_graph"]
    net.load_state_dict(res["_variables"])
    with torch.no_grad():
        return net.embed(g, g.x)[: g.num_nodes]


def test_kmeans_inertia_is_sklearns_on_trained_gcn_embeddings(
        gcn_embeddings):
    """On a trained GCN's embeddings into 8 clusters, at ``n_init=3`` over
    seeds 0-7 against ``random_state`` 0-7: the median inertia and the
    least within 1% of scikit-learn's. One seed alone is a draw of the
    seeding (either package's spreads 1912-2097 over seeds here)."""
    emb = gcn_embeddings
    ours = [kmeans(emb, 8, n_init=3, seed=s).inertia for s in range(8)]
    ref = [KMeans(8, n_init=3, random_state=s).fit(emb.numpy()).inertia_
           for s in range(8)]
    assert np.median(ours) == pytest.approx(np.median(ref), rel=0.01)
    assert min(ours) == pytest.approx(min(ref), rel=0.01)


def test_kmeans_is_seeded_and_leaves_the_global_generator_alone(
        gcn_embeddings):
    state = torch.get_rng_state()
    a = kmeans(gcn_embeddings, 6, seed=3)
    b = kmeans(gcn_embeddings, 6,
               generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a.labels, b.labels) and a.inertia == b.inertia
    assert a.labels.shape == (gcn_embeddings.shape[0],)
    assert a.centers.shape == (6, gcn_embeddings.shape[1])
    with pytest.raises(ValueError, match="n_clusters"):
        kmeans(gcn_embeddings[:3], 4)


# -- loss curves against the JAX trainer ---------------------------------------------

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


def _curves(monkeypatch, model, j_ds, t_ds, j_init_cls, t_init_cls, **kw):
    """``model`` through the JAX ``train`` and the port's ``experiment``
    from the JAX initial weights (captured from the JAX wrapper's
    ``init``): per-step losses, and both results."""
    captured = {}
    real_init = j_init_cls.init

    def capture(self, rng, graph=None):
        variables = real_init(self, rng, graph)
        captured["params"] = _host(variables["params"])
        return variables

    monkeypatch.setattr(j_init_cls, "init", capture)
    rec = _Recorder()
    res_j = j_train(j_ds, model, logger=rec, **kw)
    monkeypatch.setattr(t_init_cls, "init", lambda self, gen, graph=None:
                        load_jax_params(self.model, captured["params"]))
    steps = []
    real_step = Trainer.train_step

    def step(self, *a):
        loss = real_step(self, *a)
        steps.append(float(loss))
        return loss

    monkeypatch.setattr(Trainer, "train_step", step)
    ((res_t,),) = experiment(dataset=t_ds, model=model, device="cpu",
                             **kw).values()
    return steps, rec.losses, res_j, res_t


CURVES = {
    "graph_unet": dict(hidden_size=16, dropout=0.0),
    "correct_smooth_mlp": dict(hidden_size=16, dropout=0.0, correct_steps=5,
                               smooth_steps=5),
}


@pytest.mark.parametrize("model", sorted(CURVES))
def test_loss_curve_matches_the_jax_trainer(monkeypatch, model):
    """The same train loss at every epoch, the same best epoch and
    metrics (C&S's after its post-processing)."""
    steps, want, res_j, res_t = _curves(
        monkeypatch, model, j_build_dataset("sbm", num_nodes=NODES),
        build_dataset("sbm", num_nodes=NODES), j_nc.NodeClfWrapper,
        t_nc.NodeClfWrapper, epochs=5, eval_step=1, patience=100, seed=0,
        **CURVES[model])
    assert len(steps) == 5
    np.testing.assert_allclose(steps, want, rtol=LOSS_RTOL)
    assert res_t["best_epoch"] == res_j["best_epoch"]
    for k in ("train_acc", "val_acc", "test_acc"):
        assert res_t[k] == pytest.approx(res_j[k], abs=1e-6), k


def test_two_stage_sagn_matches_the_jax_trainer(monkeypatch):
    """Two stages of four epochs at a threshold that takes pseudo-labels
    at stage 1 (the same count in both packages): the same eight losses,
    best epoch and final metrics."""
    taken_j = []
    real_pre = j_staged.SAGNWrapper.pre_stage

    def pre(self, stage, graph, variables):
        out = real_pre(self, stage, graph, variables)
        if out is not None:
            taken_j.append(int((out.train_mask & ~graph.train_mask).sum()))
        return out

    monkeypatch.setattr(j_staged.SAGNWrapper, "pre_stage", pre)
    taken_t = []
    real_t_pre = SAGNWrapper.pre_stage

    def pre_t(self, stage, graph):
        out = real_t_pre(self, stage, graph)
        taken_t.append(dict(self.stage_record))
        return out

    monkeypatch.setattr(SAGNWrapper, "pre_stage", pre_t)
    gj = _holdout(j_build_dataset("sbm", num_nodes=NODES).graph, jnp)
    gt = _holdout(build_dataset("sbm", num_nodes=NODES).graph, torch)
    steps, want, res_j, res_t = _curves(
        monkeypatch, "sagn", JDataset.from_graph(gj, name="sbm"),
        Dataset.from_graph(gt, name="sbm"), j_nc.NodeClfWrapper,
        t_nc.NodeClfWrapper, epochs=4, eval_step=1, patience=100, seed=0,
        hidden_size=16, dropout=0.0, attn_drop=0.0, threshold=0.5)
    assert len(steps) == 8
    np.testing.assert_allclose(steps, want, rtol=LOSS_RTOL)
    assert len(taken_j) == 1 and taken_j[0] > 0
    assert taken_t[-1] == res_t["stages"] == {
        1: {"pseudo_labels": taken_j[0]}}
    assert res_t["best_epoch"] == res_j["best_epoch"]
    for k in ("train_acc", "val_acc", "test_acc"):
        assert res_t[k] == pytest.approx(res_j[k], abs=1e-6), k


def test_m3s_first_stage_matches_the_jax_trainer(monkeypatch):
    """M3S: stage 0's losses equal the JAX trainer's (stage 1 follows each
    package's own clustering, so it is held by what it adds)."""
    gj = _holdout(j_build_dataset("sbm", num_nodes=NODES).graph, jnp)
    gt = _holdout(build_dataset("sbm", num_nodes=NODES).graph, torch)
    steps, want, _, res_t = _curves(
        monkeypatch, "m3s", JDataset.from_graph(gj, name="sbm"),
        Dataset.from_graph(gt, name="sbm"), j_nc.NodeClfWrapper,
        t_nc.NodeClfWrapper, epochs=3, eval_step=1, patience=100, seed=0,
        hidden_size=16, dropout=0.0, num_new_labels=5)
    assert len(steps) == len(want) == 6
    np.testing.assert_allclose(steps[:3], want[:3], rtol=LOSS_RTOL)
    assert np.isfinite(steps).all() and 0.0 <= res_t["test_acc"] <= 1.0


def test_patchy_san_matches_the_jax_trainer(monkeypatch):
    """PATCHY-SAN on ``random-graphs`` through both trainers: the same
    split, losses, best epoch and accuracies; no kernel launched."""
    kw = dict(num_graphs=40, max_nodes=20, feat_dim=6)
    sk.reset_launch_counts()
    steps, want, res_j, res_t = _curves(
        monkeypatch, "patchy_san", j_build_dataset("random-graphs", **kw),
        build_dataset("random-graphs", **kw), j_gc.PatchySANWrapper,
        t_gc.PatchySANWrapper, epochs=5, eval_step=1, patience=100, seed=0,
        hidden_size=8, dropout=0.0)
    assert len(steps) == 5
    np.testing.assert_allclose(steps, want, rtol=LOSS_RTOL)
    assert res_t["best_epoch"] == res_j["best_epoch"]
    for k in ("train_acc", "val_acc", "test_acc"):
        assert res_t[k] == pytest.approx(res_j[k], abs=1e-6), k
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)


def test_gcnmix_five_adam_steps_match_jax_at_its_draws(graphs):
    """Each package's wrapper loss and Adam (lr 1e-2) for five steps from
    the same weights, the port replaying the ``(perm, lam)`` the JAX
    ``mixup_forward`` drew at each step's key: the same losses."""
    gj, gt = graphs
    jm, variables, tm = _pair("gcnmix", hidden_size=16)
    jw = j_nc.GCNMixWrapper(jm)
    tx = optax.adam(1e-2)
    params, opt_state = variables["params"], None
    opt_state = tx.init(params)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    losses_j, draws = [], []
    for key in keys:
        (loss, _), grads = jax.value_and_grad(
            lambda p: jw.loss({"params": p}, gj, key), has_aux=True)(params)
        _, perm, lam = jm.apply({"params": params}, gj, gj.x, True,
                                method=jm.mixup_forward,
                                rngs={"dropout": key})
        draws.append((torch.from_numpy(np.asarray(perm).copy()).long(),
                      float(lam)))
        losses_j.append(float(loss))
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
    wrapper = t_nc.GCNMixWrapper(tm, seed=0)
    g = wrapper.normalise(gt)
    replay = iter(draws)
    tm.draw_mixup = lambda graph, rng, generator=None: next(replay)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    losses_t = []
    for _ in keys:
        opt.zero_grad()
        loss = wrapper.loss(g, torch.Generator().manual_seed(0))
        loss.backward()
        opt.step()
        losses_t.append(float(loss.detach()))
    np.testing.assert_allclose(losses_t, losses_j, rtol=LOSS_RTOL)
    assert len({lam for _, lam in draws}) == 5


def test_gcnmix_trains_through_experiment_on_its_own_draws():
    """``experiment(model="gcnmix")`` on its default wrapper: finite
    losses, one seed the same run twice."""
    runs = [experiment(dataset="sbm", model="gcnmix", epochs=3, seed=2,
                       device="cpu")[("sbm", "gcnmix")][0]
            for _ in range(2)]
    assert np.isfinite(runs[0]["train_loss"])
    assert runs[0]["train_loss"] == runs[1]["train_loss"]
