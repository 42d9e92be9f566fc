"""cogdl_tpu_torch's link prediction and clustering (GAE, VGAE, AGC, DAEGC,
the ``link_prediction`` and ``clustering`` wrappers, AUC and NMI) against
the JAX package on the CPU.

The scores are held against scikit-learn within 1e-12. The link split,
its negatives and both evaluation pair sets equal the JAX wrapper's for the
same seed. Each model carries the JAX wrapper's initial variables
(``load_jax_params``) and each loss gets the JAX wrapper's draws for the
same key (the negative pairs, VGAE's noise): forward at 1e-5 and the loss's
grads at 1e-4, over the plain graph and over ``prepare_spmm``'s structure
(the CPU runs K1's and K3's plain versions over it). Through
``experiment(device="cpu")`` the train loss of every epoch is the JAX
trainer's within 1e-4 from the same weights and draws."""

import jax
import numpy as np
import pytest
import torch
from sklearn.metrics import normalized_mutual_info_score, roc_auc_score

from cogdl_tpu.data.graph import from_coo as j_from_coo
from cogdl_tpu.datasets.dataset import Dataset as JDataset
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.trainer.trainer import TrainerConfig as JTrainerConfig
from cogdl_tpu.trainer.trainer import build_optimizer as j_build_optimizer
from cogdl_tpu.wrappers import fetch_wrapper as j_fetch_wrapper
from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.data.graph import from_coo
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.trainer.trainer import Trainer, TrainerConfig
from cogdl_tpu_torch.utils.evaluator import (
    normalized_mutual_info,
)
from cogdl_tpu_torch.utils.evaluator import roc_auc_score as t_auc
from cogdl_tpu_torch.wrappers import fetch_wrapper
from cogdl_tpu_torch.wrappers.clustering import ClusteringWrapper
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)
from test_torch_zoo_models import _Recorder

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
LOSS_TOL = 1e-4
SCORE_TOL = 1e-12
F_IN, NODES = 12, 120
# registry name → small constructor arguments (DAEGC at a narrow width)
CLUSTER_MODELS = {
    "gae": dict(hidden_size=16, emb_size=8),
    "vgae": dict(hidden_size=16, emb_size=8),
    "agc": dict(max_order=3),
    "daegc": dict(hidden_size=16, emb_size=8),
}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# -- AUC and NMI ---------------------------------------------------------------

@pytest.mark.parametrize("case", range(6))
def test_roc_auc_matches_sklearn(case):
    """Continuous scores, heavy ties (integer scores), all scores level
    (0.5) and a perfect split, against ``sklearn.metrics.roc_auc_score``."""
    rng = np.random.default_rng(case)
    n = 40 + 37 * case
    y = rng.integers(0, 2, n)
    y[:2] = (0, 1)
    s = [rng.normal(size=n), rng.integers(0, 4, n).astype(float),
         np.zeros(n), y * 2.0 - 1.0, rng.integers(0, 2, n).astype(float),
         rng.normal(size=n).astype(np.float32)][case]
    assert abs(t_auc(y, s) - roc_auc_score(y, s)) <= SCORE_TOL


def test_roc_auc_raises_on_one_class():
    with pytest.raises(ValueError, match="one class"):
        t_auc(np.ones(5), np.arange(5.0))


@pytest.mark.parametrize("case", range(7))
def test_nmi_matches_sklearn(case):
    """Random labellings with up to six clusters, one cluster on both
    sides (1.0), one side single (0.0), a relabelled copy (1.0), every
    point its own cluster, and integer labels that skip values."""
    rng = np.random.default_rng(10 + case)
    n = 50 + 13 * case
    a = rng.integers(0, 6, n)
    b = [rng.integers(0, 4, n), None, np.zeros(n, int), (a + 3) % 6,
         np.arange(n), rng.integers(0, 3, n) * 7, rng.integers(0, 6, n)][case]
    if case == 1:
        a, b = np.full(n, 3), np.full(n, 5)
    if case == 6:
        a = np.where(a > 2, a, 10)
    got = normalized_mutual_info(a, b)
    assert abs(got - normalized_mutual_info_score(a, b)) <= SCORE_TOL
    if case in (1, 3):
        assert got == 1.0
    if case == 2:
        assert got == 0.0


# -- the link split -------------------------------------------------------------

def _link_pair(seed=0, model="gcn", **kw):
    """The JAX and port link wrappers over the same sbm graph with the
    JAX split done; GCN without dropout."""
    cfg = dict(in_features=F_IN, out_features=8, hidden_size=16, dropout=0.0)
    cfg.update(kw)
    jm = j_build_model(model, **cfg)
    wj = j_fetch_wrapper("link_prediction")(jm, seed=seed)
    gj = wj.prepare_graph(j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    tm = build_model(model, **cfg)
    wt = fetch_wrapper("link_prediction")(tm, seed=seed)
    gt = wt.prepare_graph(t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    return wj, gj, wt, gt


@pytest.mark.parametrize("seed", [0, 3])
def test_link_split_equals_jax(seed):
    """The training graph (self loops included) edge for edge, the
    training pairs, and both splits' positive and negative pairs."""
    wj, gj, wt, gt = _link_pair(seed)
    assert gt.e_pad == gj.e_pad and gt.n_pad == gj.x.shape[0]
    np.testing.assert_array_equal(gt.row.numpy(), np.asarray(gj.row))
    np.testing.assert_array_equal(gt.col.numpy(), np.asarray(gj.col))
    np.testing.assert_array_equal(wt.train_pairs, wj._train_pairs)
    assert set(wt.eval_edges) == set(wj._eval_edges) == {"val", "test"}
    for split, (pos, neg) in wj._eval_edges.items():
        np.testing.assert_array_equal(wt.eval_edges[split][0], pos)
        np.testing.assert_array_equal(wt.eval_edges[split][1], neg)
        assert len(neg) == len(pos) > 0


def test_link_split_with_official_pairs():
    """A dataset whose ``link_split`` the test writes: ``[2, n]`` and
    ``[n, 2]`` pairs, and a split without negatives (drawn from the seed's
    generator); the graph's own edges all train."""
    rng = np.random.default_rng(0)
    N = 40
    edges = rng.integers(0, N, (2, 150))
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    split = {"valid": (rng.integers(0, N, (2, 10)), None),
             "test": (rng.integers(0, N, (7, 2)),
                      rng.integers(0, N, (2, 7)))}
    gj = j_from_coo(edges, num_nodes=N, x=x)
    dj = JDataset.from_graph(gj, name="links")
    dj.link_split = split
    gt = from_coo(edges, num_nodes=N, x=x)
    dt = Dataset.from_graph(gt, name="links")
    dt.link_split = split
    kw = dict(in_features=F_IN, out_features=8, hidden_size=16)
    wj = j_fetch_wrapper("link_prediction")(j_build_model("gcn", **kw), dj,
                                            seed=4)
    pj = wj.prepare_graph(gj)
    wt = fetch_wrapper("link_prediction")(build_model("gcn", **kw), dt,
                                          seed=4)
    pt = wt.prepare_graph(gt)
    np.testing.assert_array_equal(pt.row.numpy(), np.asarray(pj.row))
    np.testing.assert_array_equal(pt.col.numpy(), np.asarray(pj.col))
    assert set(wt.eval_edges) == set(wj._eval_edges)
    for k, (pos, neg) in wj._eval_edges.items():
        np.testing.assert_array_equal(wt.eval_edges[k][0], pos)
        np.testing.assert_array_equal(wt.eval_edges[k][1], neg)


# -- the models and losses -------------------------------------------------------

def _cluster_pair(name, seed=0):
    kw = dict(in_features=F_IN, out_features=4, **CLUSTER_MODELS[name])
    jm = j_build_model(name, **kw)
    wj = j_fetch_wrapper("clustering")(jm)
    gj = wj.prepare_graph(j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    variables = _host(wj.init(jax.random.PRNGKey(seed), gj))
    tm = build_model(name, **kw)
    if variables.get("params"):
        load_jax_params(tm, variables["params"])
    wt = ClusteringWrapper(tm)
    return wj, gj, variables, wt, lambda: build_model(name, **kw)


def _port_graph(wt, structure):
    g = wt.prepare_graph(t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    return prepare_spmm(g) if structure else g


def jax_pair_draws(key, gj):
    """The JAX link and clustering wrappers' split of a step ``key``: the
    model's key and the ``e_pad`` negative pairs."""
    r1, r2 = jax.random.split(key)
    nr = jax.random.randint(r2, (gj.e_pad,), 0, gj.num_nodes)
    nc = jax.random.randint(jax.random.fold_in(r2, 1), (gj.e_pad,), 0,
                            gj.num_nodes)
    return r1, np.asarray(nr), np.asarray(nc)


def jax_eps(monkeypatch, wj, gj, variables, key):
    """VGAE's noise inside the JAX wrapper's loss at ``key``, caught as the
    model draws it (an eager call)."""
    caught = []
    real = jax.random.normal

    def normal(*a, **kw):
        out = real(*a, **kw)
        caught.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "normal", normal)
    wj.loss(variables, gj, key)
    monkeypatch.setattr(jax.random, "normal", real)
    (eps,) = caught
    return eps


def assert_grads(tm, grads_j, build):
    ref = load_jax_params(build(), _host(grads_j))
    ref_params = dict(ref.named_parameters())
    assert set(ref_params) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        close(p.grad, ref_params[name].detach(), GRAD_RTOL, GRAD_ATOL, name)


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", sorted(CLUSTER_MODELS))
def test_cluster_models_match_jax(name, structure):
    """``embed``, the training forward at the JAX noise, ``decode_edges``,
    VGAE's ``kl``, DAEGC's ``cluster_q``, and the wrapper's loss."""
    wj, gj, v, wt, _ = _cluster_pair(name)
    jm, tm = wj.model, wt.model
    g = _port_graph(wt, structure)
    with torch.no_grad():
        close(tm.embed(g), jm.apply(v, gj, gj.x, method=jm.embed))
    key = jax.random.PRNGKey(7)
    r1, nr, nc = jax_pair_draws(key, gj)
    eps = None
    if name == "vgae":
        mp = pytest.MonkeyPatch()
        eps = _t(jax_eps(mp, wj, gj, v, key))
        mp.undo()
    kw = {} if eps is None else {"eps": eps}
    z_j = jm.apply(v, gj, gj.x, True, rngs={"dropout": r1})
    with torch.no_grad():
        z_t = tm(g, g.x, training=True, **kw)
        close(z_t, z_j)
        close(tm.decode_edges(z_t, _t(nr), _t(nc)),
              jm.apply(v, z_j, nr, nc, method=jm.decode_edges))
        if name == "vgae":
            close(tm.kl(g, g.x), jm.apply(v, gj, gj.x, method=jm.kl))
        if name == "daegc":
            close(tm.cluster_q(z_t), jm.apply(v, z_j, method=jm.cluster_q))
        close(wt.loss_at(g, (_t(nr), _t(nc), eps), True),
              wj.loss(v, gj, key)[0])


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", ["gae", "vgae", "daegc"])
def test_cluster_loss_grads_match_jax(name, structure):
    """The clustering loss's grads at the JAX draws (VGAE's KL through its
    second encode included); DAEGC's ``centers`` get none from it in
    either package."""
    wj, gj, v, wt, build = _cluster_pair(name)
    key = jax.random.PRNGKey(3)
    _, nr, nc = jax_pair_draws(key, gj)
    eps = None
    if name == "vgae":
        mp = pytest.MonkeyPatch()
        eps = _t(jax_eps(mp, wj, gj, v, key))
        mp.undo()
    grads = jax.grad(lambda p: wj.loss({"params": p}, gj, key)[0])(
        v["params"])
    g = _port_graph(wt, structure)
    wt.loss_at(g, (_t(nr), _t(nc), eps), True).backward()
    if name == "daegc":
        assert wt.model.centers.grad is None
        assert not np.asarray(grads["centers"]).any()
        wt.model.centers.grad = torch.zeros_like(wt.model.centers)
    assert_grads(wt.model, grads, build)


@pytest.mark.parametrize("structure", [False, True])
def test_link_loss_grads_and_auc_match_jax(structure):
    """GCN under the link wrapper: the loss and its grads at the JAX
    draws, and the evaluation's AUCs."""
    wj, gj, wt, gt = _link_pair(0)
    v = _host(wj.init(jax.random.PRNGKey(0), gj))
    load_jax_params(wt.model, v["params"])
    g = prepare_spmm(gt) if structure else gt
    key = jax.random.PRNGKey(11)
    _, nr, nc = jax_pair_draws(key, gj)
    loss_j, grads = jax.value_and_grad(
        lambda p: wj.loss({"params": p}, gj, key)[0])(v["params"])
    loss_t = wt.loss_at(g, (_t(nr), _t(nc)), True)
    close(loss_t, loss_j)
    loss_t.backward()
    assert_grads(wt.model, grads, lambda: build_model(
        "gcn", in_features=F_IN, out_features=8, hidden_size=16,
        dropout=0.0))
    auc_j, auc_t = wj.evaluate(v, gj), wt.evaluate(g)
    assert set(auc_t) == set(auc_j) == {"val_auc", "test_auc"}
    for k in auc_j:
        assert auc_t[k] == pytest.approx(auc_j[k], abs=1e-6), k


def test_cluster_evaluate_scores_kmeans_with_nmi():
    """The evaluation clusters the real nodes' embeddings (the port's
    KMeans) and reports NMI against the labels, as val and test."""
    _, _, _, wt, _ = _cluster_pair("agc")
    g = _port_graph(wt, False)
    out = wt.evaluate(g)
    assert set(out) == {"val_nmi", "test_nmi"}
    assert out["val_nmi"] == out["test_nmi"] > 0.5


# -- the trainer ---------------------------------------------------------------

def test_daegc_centers_step_as_optax_does():
    """``centers`` get no gradient from the loss; the trainer steps them
    with a zero one, as optax's ``add_decayed_weights`` + ``adam`` does:
    with weight decay they move, and by the JAX step's amount."""
    wj, gj, v, wt, _ = _cluster_pair("daegc")
    key = jax.random.PRNGKey(5)
    _, nr, nc = jax_pair_draws(key, gj)
    tx = j_build_optimizer(JTrainerConfig(lr=0.01, weight_decay=5e-4))
    grads = jax.grad(lambda p: wj.loss({"params": p}, gj, key)[0])(
        v["params"])
    upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    want = np.asarray(v["params"]["centers"]) + np.asarray(upd["centers"])
    cfg = TrainerConfig(lr=0.01, weight_decay=5e-4, device="cpu")
    from cogdl_tpu_torch.trainer.trainer import build_optimizer

    opt, sched = build_optimizer(cfg, wt.model.parameters())
    wt.draws = lambda graph, generator: (_t(nr), _t(nc), None)
    Trainer(cfg).train_step(wt, opt, sched, _port_graph(wt, False), None)
    close(wt.model.centers, want)
    assert not np.allclose(want, np.asarray(v["params"]["centers"]))


def test_agc_trains_without_parameters():
    """AGC has no parameters: ``build_optimizer`` gives none, a step
    computes the loss (the JAX trainer's at the same draws) and changes
    nothing, and ``experiment()`` runs it to its NMI."""
    wj, gj, v, wt, _ = _cluster_pair("agc")
    from cogdl_tpu_torch.trainer.trainer import build_optimizer

    cfg = TrainerConfig(device="cpu")
    assert build_optimizer(cfg, wt.model.parameters()) == (None, None)
    key = jax.random.PRNGKey(2)
    _, nr, nc = jax_pair_draws(key, gj)
    wt.draws = lambda graph, generator: (_t(nr), _t(nc), None)
    loss = Trainer(cfg).train_step(wt, None, None, _port_graph(wt, False),
                                   None)
    assert not loss.requires_grad
    close(loss, wj.loss(v, gj, key)[0])
    (res,) = experiment(dataset="sbm", model="agc", epochs=2, eval_step=1,
                        device="cpu")[("sbm", "agc")]
    assert np.isfinite(res["train_loss"]) and res["test_nmi"] > 0.5


def _jax_step_draws(seed, steps, gj):
    """The JAX trainer's step keys (``split`` after the init key) as the
    wrappers' negative pairs."""
    rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    out = []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        _, nr, nc = jax_pair_draws(key, gj)
        out.append((_t(nr), _t(nc)))
    return out


@pytest.mark.parametrize("model,wrapper,kw", [
    ("gae", "clustering", dict(hidden_size=16, emb_size=8)),
    ("agc", "clustering", dict(max_order=3)),
    ("gcn", "link_prediction", dict(hidden_size=16, dropout=0.0)),
])
def test_loss_curve_matches_the_jax_trainer(monkeypatch, model, wrapper, kw):
    """``experiment(model=...)`` against ``cogdl_tpu.experiments.train``
    from the JAX initial weights and with the JAX trainer's negative pairs
    at every step: the same train loss at every epoch."""
    epochs = 4
    run = dict(epochs=epochs, eval_step=1, patience=100, seed=0, **kw)
    if wrapper != "clustering":
        run["wrapper"] = wrapper
    rec = _Recorder()
    j_train("sbm", model, logger=rec, **run)
    jm = j_build_model(model, in_features=j_sbm().x.shape[1], out_features=4,
                       **kw)
    wj_kw = {"seed": 0} if wrapper == "link_prediction" else {}
    gj = j_fetch_wrapper(wrapper)(jm, **wj_kw).prepare_graph(j_sbm())
    # the JAX trainer's initial weights: the second half of split(key(0))
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    params = _host(jm.init({"params": init_rng, "dropout": init_rng}, gj,
                           gj.x, training=False)).get("params")
    queue = _jax_step_draws(0, epochs, gj)
    wt_cls = fetch_wrapper(wrapper)
    monkeypatch.setattr(
        wt_cls, "init", lambda self, gen, graph: load_jax_params(
            self.model, params) if params else None)
    if wrapper == "clustering":
        monkeypatch.setattr(wt_cls, "draws", lambda self, graph, gen: (
            *queue.pop(0), None))
    else:
        monkeypatch.setattr(wt_cls, "draws",
                            lambda self, graph, gen: queue.pop(0))
    steps = []
    real_step = Trainer.train_step

    def step(self, *a):
        loss = real_step(self, *a)
        steps.append(float(loss))
        return loss

    monkeypatch.setattr(Trainer, "train_step", step)
    (res,) = experiment(dataset="sbm", model=model, device="cpu",
                        **run)[("sbm", model)]
    assert len(steps) == epochs and not queue
    np.testing.assert_allclose(steps, rec.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("model", ["gae", "vgae", "agc", "daegc"])
def test_experiment_runs_each_clustering_name_on_the_cpu(model):
    """Each name on its default wrapper through ``experiment()``, no
    kernel launched on the CPU; the same call without ``device`` raises
    where torch sees no card."""
    sk.reset_launch_counts()
    (res,) = experiment(dataset="sbm", model=model, epochs=2, eval_step=1,
                        device="cpu", **CLUSTER_MODELS[model])[("sbm", model)]
    assert np.isfinite(res["train_loss"]) and 0.0 <= res["test_nmi"] <= 1.0
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            experiment(dataset="sbm", model=model, epochs=1)


def test_gcn_link_prediction_runs_and_raises_without_a_card():
    (res,) = experiment(dataset="sbm", model="gcn", wrapper="link_prediction",
                        epochs=3, eval_step=1, device="cpu")[("sbm", "gcn")]
    assert 0.5 < res["test_auc"] <= 1.0 and 0.0 <= res["val_auc"] <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            experiment(dataset="sbm", model="gcn", wrapper="link_prediction",
                       epochs=1)


def test_link_models_carry_the_kernel_flags():
    """GAE, VGAE and AGC normalise inside their forward (``adj_norm``), so
    the wrapper normalises before it builds the structure; AGC has no GCN
    layer and says it propagates (``calls_spmm``); DAEGC reads the graph
    as it is."""
    from cogdl_tpu_torch.wrappers.sampled_node_classification import (
        reads_kernel_structure,
    )

    for name in ("gae", "vgae", "agc", "daegc"):
        m = build_model(name, in_features=F_IN, **CLUSTER_MODELS[name])
        assert reads_kernel_structure(m), name
        assert getattr(m, "adj_norm", None) == (
            None if name == "daegc" else "sym"), name
        g = NodeClfWrapper(m).normalise(t_sbm(num_nodes=NODES,
                                              feat_dim=F_IN, seed=5))
        assert ("norm" in dict(g.meta)) == (name != "daegc"), name
