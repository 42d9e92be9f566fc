"""cogdl_tpu_torch's self-supervised wrappers against the JAX package on the
CPU: five optimizer steps of each wrapper in both packages from the same
weights with the same draws (the JAX wrapper's, handed to the port's
``loss_at``), the loss at every step within 1e-4 and the EMA teachers
(with BGRL's statistics and step) within 1e-5 after them; the
self-auxiliary wrapper's tasks array for array; and every name of the
slice through ``experiment(device="cpu")``."""

import jax
import numpy as np
import optax
import pytest
import torch

from cogdl_tpu.datasets import build_dataset as j_build_dataset
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.models import SUPPORTED_MODELS as JAX_MODELS
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.trainer.trainer import TrainerConfig as JTrainerConfig
from cogdl_tpu.trainer.trainer import build_optimizer as j_build_optimizer
from cogdl_tpu.wrappers import DEFAULT_WRAPPER as J_DEFAULT_WRAPPER
from cogdl_tpu.wrappers import fetch_wrapper as j_fetch_wrapper
from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.datasets import build_dataset
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.models import SUPPORTED_MODELS, build_model
from cogdl_tpu_torch.trainer.trainer import (
    Trainer,
    TrainerConfig,
    build_optimizer,
)
from cogdl_tpu_torch.wrappers import DEFAULT_WRAPPER, fetch_wrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)
from test_torch_ssl_models import (
    CASES,
    F_IN,
    NODES,
    close,
    jax_draws,
    load_variables,
    make_pair,
    port_graph,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

LOSS_TOL = 1e-4
STATE_TOL = 1e-5
STEPS = 5
LR, WD = 0.01, 5e-4
SSL_NAMES = ("dgi", "mvgrl", "grace", "graphmae", "graphmae2", "bgrl",
             "unsup_graphsage", "infograph")


def jax_steps(wj, batches, variables, draw=None, seed=1):
    """``STEPS`` steps of the JAX trainer's jitted ``train_step`` (Adam with
    decayed weights, the wrapper's updates into the model state), a step
    key split from ``PRNGKey(seed)`` each; returns the losses, each step's
    draws (``draw(batch, key)``) and the final variables."""
    tx = j_build_optimizer(JTrainerConfig(lr=LR, weight_decay=WD))
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    opt_state = tx.init(params)

    @jax.jit
    def step(params, state, opt_state, b, key):
        (loss, upd), grads = jax.value_and_grad(
            lambda p: wj.loss({"params": p, **state}, b, key),
            has_aux=True)(params)
        u, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, u), {**state, **upd}, opt_state,
                loss)

    rng = jax.random.PRNGKey(seed)
    losses, draws = [], []
    for i in range(STEPS):
        rng, key = jax.random.split(rng)
        b = batches[i % len(batches)]
        if draw is not None:
            draws.append(draw(b, key))
        params, state, opt_state, loss = step(params, state, opt_state, b,
                                              key)
        losses.append(float(loss))
    return losses, draws, {"params": params, **state}


def port_steps(wt, batches, draws=None):
    """``STEPS`` of the port trainer's ``train_step`` at the same settings;
    with ``draws``, each step's loss at the next of them."""
    cfg = TrainerConfig(lr=LR, weight_decay=WD, device="cpu")
    opt, sched = build_optimizer(cfg, wt.model.parameters())
    if draws is not None:
        queue = [to_torch(d) for d in draws]
        wt.draws = lambda graph, generator: queue.pop(0)
    gen = torch.Generator().manual_seed(0)
    return [float(Trainer(cfg).train_step(wt, opt, sched,
                                          batches[i % len(batches)], gen))
            for i in range(STEPS)]


def assert_state(model, variables, build, tol=STATE_TOL):
    """The port model's buffers (teacher, statistics, step) against the
    JAX variables'."""
    ref = load_variables(build(), variables)
    want = dict(ref.named_buffers())
    for k, v in model.named_buffers():
        close(v, want[k].detach(), tol, tol, k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_five_steps_match_jax(name):
    """At the wrappers' own EMA decays (BGRL 0.99, GraphMAE2 0.996): the
    teachers, which the steps moved by more than the tolerance, within
    1e-5 of the JAX package's."""
    wj, gj, variables, wt, build = make_pair(name)
    before = {k: v.clone() for k, v in wt.model.named_buffers()}
    losses_j, draws, final = jax_steps(
        wj, [gj], variables, lambda b, key: jax_draws(name, wj, b, key))
    losses_t = port_steps(wt, [port_graph(wt, True)], draws)
    np.testing.assert_allclose(losses_t, losses_j, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    if "teacher" in final:
        assert_state(wt.model, final, build)
        moved = max(float((v - before[k]).abs().max())
                    for k, v in wt.model.named_buffers()
                    if k.startswith("teacher."))
        assert moved > 10 * STATE_TOL
    if name == "bgrl":
        assert float(wt.model.ema_step) == STEPS


def _jax_library_walks(indptr, indices, starts, walk_length, seed=0,
                       **kw):
    """A stand-in for the JAX package's ``native.random_walk``: walks of
    its shape that stay at their starts. The test compares starts and
    negatives and feeds the JAX batches to both sides, so the walks need
    not be the library's."""
    return np.repeat(np.asarray(starts, np.int64)[:, None], walk_length, 1)


def test_unsup_graphsage_batches_and_steps_match_jax(monkeypatch):
    """The port wrapper's starts and negatives equal the JAX wrapper's draw
    for draw over five epochs (the walks are the port library's own); five
    steps over the JAX batches give the JAX losses. The JAX wrapper takes
    its library's branch (its walk seed one draw of ``2**62``, as the
    port's), whether or not its library builds in this process."""
    import cogdl_tpu.native as jnative

    monkeypatch.setattr(jnative, "available", lambda: True)
    monkeypatch.setattr(jnative, "random_walk", _jax_library_walks)
    kw = dict(in_features=F_IN, out_features=4, hidden_size=16, dropout=0.0)
    jm = j_build_model("unsup_graphsage", **kw)
    wj = j_fetch_wrapper("unsup_graphsage")(jm)
    gj = wj.prepare_graph(j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    variables = wj.init(jax.random.PRNGKey(0), gj)
    tm = load_variables(build_model("unsup_graphsage", **kw), variables)
    wt = fetch_wrapper("unsup_graphsage")(tm, num_threads=2)
    gt = wt.prepare_graph(t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    jb = [wj.train_batches(gj)[0] for _ in range(STEPS)]
    tb = [wt.train_batches(gt)[0] for _ in range(STEPS)]
    for (_, uj, vj, nj), (_, ut, vt, nt) in zip(jb, tb):
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        assert vt.shape == vj.shape
    losses_j, _, _ = jax_steps(wj, jb, variables)
    batches = [(gt, torch.from_numpy(np.array(u)),
                torch.from_numpy(np.array(v)),
                torch.from_numpy(np.array(n))) for _, u, v, n in jb]
    np.testing.assert_allclose(port_steps(wt, batches), losses_j,
                               rtol=LOSS_TOL, atol=LOSS_TOL)


def _self_aux_pair(task):
    kw = dict(in_features=F_IN, out_features=4, hidden_size=16, dropout=0.0)
    wj = j_fetch_wrapper("self_auxiliary")(j_build_model("gcn", **kw),
                                           auxiliary_task=task, num_pairs=300)
    gj = wj.prepare_graph(j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    wt = fetch_wrapper("self_auxiliary")(build_model("gcn", **kw),
                                         auxiliary_task=task, num_pairs=300)
    gt = wt.prepare_graph(t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    return wj, gj, wt, gt


TASKS = ("edgemask", "attributemask", "pairwise-distance")


@pytest.mark.parametrize("task", TASKS)
def test_self_auxiliary_task_matches_jax(task):
    """``prepare_graph`` builds the JAX wrapper's pairs, labels, masked
    nodes, targets and train-graph edges, array for array."""
    wj, gj, wt, gt = _self_aux_pair(task)
    if task == "attributemask":
        np.testing.assert_array_equal(wt._masked_nodes.numpy(),
                                      np.asarray(wj._masked_nodes))
        close(wt._feat_targets, wj._feat_targets, 0, 0)
        close(wt._train_graph.x, wj._train_graph.x, 0, 0)
    else:
        np.testing.assert_array_equal(wt._pairs.numpy(),
                                      np.asarray(wj._pairs))
        np.testing.assert_array_equal(wt._pair_labels.numpy(),
                                      np.asarray(wj._pair_labels))
    tg, jg_ = wt._train_graph, wj._train_graph
    assert (tg.num_edges, tg.e_pad) == (jg_.num_edges, jg_.e_pad)
    for f in ("row", "col"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg_, f)))
    close(tg.edge_weight, jg_.edge_weight)
    if task == "edgemask":
        assert tg.num_edges < gt.num_edges


@pytest.mark.parametrize("task", TASKS)
def test_self_auxiliary_steps_match_jax(task):
    """Five steps on the train graph from the JAX initial variables (the
    encoder's and the auxiliary head's), dropout 0."""
    wj, gj, wt, gt = _self_aux_pair(task)
    variables = wj.init(jax.random.PRNGKey(0), gj)
    wt.init(torch.Generator().manual_seed(0), gt)
    assert tuple(wt.model.aux.w.shape) == variables["params"]["aux"][
        "w"].shape
    load_variables(wt.model, variables)
    losses_j, _, _ = jax_steps(wj, [wj._train_graph], variables)
    np.testing.assert_allclose(port_steps(wt, [wt._train_graph]), losses_j,
                               rtol=LOSS_TOL, atol=LOSS_TOL)


def test_infograph_steps_match_jax():
    """Five steps over the wrapper's union batches (the same batches in
    both packages), from the JAX initial variables; the batch statistics
    after them within 1e-4. (Each GIN layer's ``fc1`` bias feeds batch
    norm, which cancels its gradient: float rounding alone gives it one,
    and Adam steps it by up to the learning rate in either package. The
    running means take 1% of that a step.)"""
    from cogdl_tpu.wrappers.graph_classification import (
        InfoGraphWrapper as JInfoGraphWrapper,
    )
    from cogdl_tpu_torch.wrappers.graph_classification import (
        InfoGraphWrapper,
    )

    jd = j_build_dataset("random-graphs", num_graphs=30)
    td = build_dataset("random-graphs", num_graphs=30)
    kw = dict(in_features=jd.num_features, out_features=2, hidden_size=8)
    wj = JInfoGraphWrapper(j_build_model("infograph", **kw), jd, batch_size=8)
    variables = wj.init(jax.random.PRNGKey(0))
    wt = InfoGraphWrapper(build_model("infograph", **kw), td, batch_size=8)
    wt.to_device("cpu")
    load_variables(wt.model, variables)
    losses_j, _, final = jax_steps(wj, wj._batches["train"], variables)
    np.testing.assert_allclose(port_steps(wt, wt.train_batches()), losses_j,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert_state(wt.model, final, lambda: build_model("infograph", **kw),
                 tol=1e-4)


@pytest.mark.parametrize("name", SSL_NAMES)
def test_each_name_trains_through_experiment(name):
    """Three epochs through ``experiment(device="cpu")`` at small widths:
    a finite loss and accuracies in [0, 1] from the probe (the SVC's
    cross-validated mean for InfoGraph)."""
    if name == "infograph":
        ds = build_dataset("random-graphs", num_graphs=36)
        kw = dict(batch_size=12, hidden_size=8)
    else:
        ds = build_dataset("sbm", num_nodes=150)
        kw = dict(hidden_size=16)
    (res,) = experiment(dataset=ds, model=name, epochs=3, seed=0,
                        device="cpu", **kw)[(ds.name, name)]
    assert np.isfinite(res["train_loss"])
    assert 0.0 <= res["test_acc"] <= 1.0 and 0.0 <= res["val_acc"] <= 1.0
    assert res["probe_ms"] > 0
    if name != "infograph":
        assert res["probe_iters"] > 0


@pytest.mark.parametrize("task", TASKS)
def test_self_auxiliary_trains_through_experiment(task):
    ds = build_dataset("sbm", num_nodes=150)
    (res,) = experiment(dataset=ds, model="gcn", wrapper="self_auxiliary",
                        auxiliary_task=task, num_pairs=300, epochs=3, seed=0,
                        device="cpu")[(ds.name, "gcn")]
    assert np.isfinite(res["train_loss"]) and 0.0 <= res["test_acc"] <= 1.0


def test_the_slice_is_registered_as_in_the_jax_package():
    for name in SSL_NAMES:
        assert SUPPORTED_MODELS[name].rsplit(".", 1)[1] == \
            JAX_MODELS[name].rsplit(".", 1)[1]
        assert DEFAULT_WRAPPER[name] == J_DEFAULT_WRAPPER[name]
        fetch_wrapper(DEFAULT_WRAPPER[name])
    fetch_wrapper("self_auxiliary")


def test_an_unknown_auxiliary_task_raises():
    wt = fetch_wrapper("self_auxiliary")(build_model(
        "gcn", in_features=F_IN, out_features=4), auxiliary_task="nope")
    with pytest.raises(ValueError, match="unknown auxiliary_task"):
        wt.prepare_graph(t_sbm(num_nodes=60, feat_dim=F_IN, seed=0))
