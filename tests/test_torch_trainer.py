"""cogdl_tpu_torch Trainer against the JAX package's Trainer on the CPU: the
optimizer/loss curve from the same initial weights, the schedules, early
stopping and best-epoch choice; plus nan_guard and checkpoints."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.models.nn.gcn import GCN as JGCN
from cogdl_tpu.trainer.trainer import Trainer as JTrainer
from cogdl_tpu.trainer.trainer import TrainerConfig as JTrainerConfig
from cogdl_tpu.trainer.trainer import build_optimizer as j_build_optimizer
from cogdl_tpu.wrappers.node_classification import NodeClfWrapper as JWrapper
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.trainer.checkpoint import load_checkpoint
from cogdl_tpu_torch.trainer.trainer import (
    Trainer,
    TrainerConfig,
    _schedule_factor,
    build_optimizer,
)
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 losses after up to 20 optimizer steps from identical weights: the
# per-step differences (1e-6 relative) compound through Adam's normalised
# updates
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
MODEL_KW = dict(in_features=16, out_features=4, hidden_size=12, dropout=0.0)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def raw_graphs():
    return (j_sbm(num_nodes=120, feat_dim=16, seed=4),
            t_sbm(num_nodes=120, feat_dim=16, seed=4))


class _InjectedWrapper(NodeClfWrapper):
    """The port's wrapper with JAX-initialised weights."""

    def __init__(self, model, params):
        super().__init__(model)
        self.params = params

    def init(self, generator, graph):
        load_jax_params(self.model, self.params)


@pytest.mark.parametrize("opt", [
    dict(optimizer="adam", weight_decay=5e-4),
    dict(optimizer="adam", weight_decay=5e-4, lr_schedule="cosine"),
    dict(optimizer="adam", weight_decay=0.0, grad_clip=0.05),
    dict(optimizer="adamw", weight_decay=1e-2),
    dict(optimizer="sgd", lr=0.2, lr_schedule="noam", warmup_steps=5),
])
def test_loss_curve_matches_jax_train_step(raw_graphs, opt):
    """20 steps of the JAX Trainer's train_step math (value_and_grad of the
    wrapper loss, then build_optimizer's update) against the port's
    Trainer.train_step from the same initial weights."""
    gj_raw, gt_raw = raw_graphs
    cfg_kw = {"epochs": 20, "lr": 0.01, **opt}
    jm = JGCN(**MODEL_KW)
    jw = JWrapper(jm)
    gj = jw.prepare_graph(gj_raw)
    params = jw.init(jax.random.PRNGKey(0), gj)["params"]
    tx = j_build_optimizer(JTrainerConfig(**cfg_kw))
    opt_state = tx.init(params)
    losses_j = []
    for _ in range(20):
        loss, grads = jax.value_and_grad(
            lambda p: jw.loss({"params": p}, gj, jax.random.PRNGKey(1))[0])(params)
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        losses_j.append(float(loss))

    tm = build_model("gcn", **MODEL_KW)
    tw = _InjectedWrapper(tm, None)
    gt = tw.prepare_graph(gt_raw)
    load_jax_params(tm, _host(jw.init(jax.random.PRNGKey(0), gj)["params"]))
    cfg = TrainerConfig(device="cpu", **cfg_kw)
    trainer = Trainer(cfg)
    optim, sched = build_optimizer(cfg, tm.parameters())
    gen = torch.Generator().manual_seed(0)
    losses_t = [float(trainer.train_step(tw, optim, sched, gt, gen))
                for _ in range(20)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "noam"])
def test_schedules_match_optax(schedule):
    cfg = TrainerConfig(epochs=30, lr=0.1, lr_schedule=schedule, warmup_steps=7,
                        device="cpu")
    factor = _schedule_factor(cfg)
    ref = {"cosine": optax.cosine_decay_schedule(0.1, decay_steps=30),
           "linear": optax.linear_schedule(0.1, 0.0, transition_steps=30)}.get(
        schedule, lambda s: 0.1 * jnp.minimum((s + 1.0) ** -0.5,
                                              (s + 1.0) * 7 ** -1.5) * 7 ** 0.5)
    for step in (0, 1, 6, 15, 29, 30, 45):
        np.testing.assert_allclose(0.1 * factor(step), float(ref(step)),
                                   rtol=1e-5, atol=1e-9)


def test_early_stopping_and_best_epoch_match(raw_graphs):
    """Both Trainers from the same weights stop at the same epoch choice and
    report the same final metrics."""
    gj_raw, gt_raw = raw_graphs
    kw = dict(epochs=60, patience=5, lr=0.05, seed=0)
    jw = JWrapper(JGCN(**MODEL_KW))
    res_j = JTrainer(JTrainerConfig(**kw)).run(jw, gj_raw)
    # the JAX Trainer initialises from the second half of split(PRNGKey(seed))
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    params = _host(jw.init(init_rng, jw.prepare_graph(gj_raw))["params"])
    tw = _InjectedWrapper(build_model("gcn", **MODEL_KW), params)
    res_t = Trainer(TrainerConfig(device="cpu", **kw)).run(tw, gt_raw)
    assert res_t["best_epoch"] == res_j["best_epoch"]
    assert res_t["best_epoch"] < kw["epochs"] - kw["patience"]  # it stopped early
    for k in ("train_acc", "val_acc", "test_acc"):
        assert res_t[k] == pytest.approx(res_j[k], abs=1e-6), k


class _NanWrapper(NodeClfWrapper):
    """Loss turns non-finite on the listed (0-based) steps."""

    def __init__(self, model, bad_steps):
        super().__init__(model)
        self.bad_steps, self.step = set(bad_steps), 0

    def loss(self, graph, generator=None, training=True):
        loss = super().loss(graph, generator, training)
        self.step += 1
        return loss * float("nan") if self.step - 1 in self.bad_steps else loss


def test_nan_guard_rolls_back_then_gives_up(raw_graphs):
    _, gt_raw = raw_graphs
    kw = dict(device="cpu", epochs=12, nan_guard_retries=2)
    res = Trainer(TrainerConfig(**kw)).run(
        _NanWrapper(build_model("gcn", **MODEL_KW), {5, 6}), gt_raw)
    assert np.isfinite(res["train_loss"]) and res["val_acc"] > 0.5
    with pytest.raises(RuntimeError, match="diverged"):
        Trainer(TrainerConfig(**kw)).run(
            _NanWrapper(build_model("gcn", **MODEL_KW), range(4, 12)), gt_raw)


def test_checkpoint_save_and_resume(raw_graphs, tmp_path):
    _, gt_raw = raw_graphs
    path = str(tmp_path / "ckpt" / "gcn.pkl")
    w = NodeClfWrapper(build_model("gcn", **MODEL_KW))
    res = Trainer(TrainerConfig(device="cpu", epochs=15,
                                checkpoint_path=path)).run(w, gt_raw)
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == res["best_epoch"]
    for k, v in res["_variables"].items():
        np.testing.assert_array_equal(ckpt["params"][k], v.numpy())
    res2 = Trainer(TrainerConfig(device="cpu", epochs=res["best_epoch"] + 1,
                                 checkpoint_path=path,
                                 resume_training=True)).run(
        NodeClfWrapper(build_model("gcn", **MODEL_KW)), gt_raw)
    assert res2["val_acc"] == pytest.approx(res["val_acc"])


class _ScriptedWrapper(NodeClfWrapper):
    """``val_acc`` rises over the first five evaluations and then drops, so
    the best epoch is 4 and ``patience=2`` stops the run after epoch 6."""

    def __init__(self, model):
        super().__init__(model)
        self.evals = 0

    def evaluate(self, graph):
        metrics = super().evaluate(graph)
        self.evals += 1
        return {**metrics, "val_acc": float(self.evals if self.evals <= 5
                                            else 0)}


class _LrTrainer(Trainer):
    """Records the learning rate of every optimizer step."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.lrs = []

    def train_step(self, wrapper, optimizer, scheduler, graph, generator):
        self.lrs.append(optimizer.param_groups[0]["lr"])
        return super().train_step(wrapper, optimizer, scheduler, graph,
                                  generator)


def test_resume_continues_the_lr_schedule(raw_graphs, tmp_path):
    """A run stopped at its best epoch 4 and resumed from its checkpoint
    steps on with the learning rates of the uninterrupted run, as the
    reference's restored optax count does (F1): steps 5, 6, ... of the
    schedule, not 0, 1, ...."""
    _, gt_raw = raw_graphs
    path = str(tmp_path / "gcn.pkl")
    kw = dict(device="cpu", epochs=10, lr=0.1, lr_schedule="linear")
    whole = _LrTrainer(TrainerConfig(**kw))
    whole.run(NodeClfWrapper(build_model("gcn", **MODEL_KW)), gt_raw)
    first = _LrTrainer(TrainerConfig(patience=2, checkpoint_path=path, **kw))
    res = first.run(_ScriptedWrapper(build_model("gcn", **MODEL_KW)), gt_raw)
    assert res["best_epoch"] == 4 and len(first.lrs) == 7
    assert load_checkpoint(path)["extra"]["sched_state"]["last_epoch"] == 5
    resumed = _LrTrainer(TrainerConfig(checkpoint_path=path,
                                       resume_training=True, **kw))
    resumed.run(NodeClfWrapper(build_model("gcn", **MODEL_KW)), gt_raw)
    factor = _schedule_factor(TrainerConfig(**kw))
    assert whole.lrs == pytest.approx([0.1 * factor(s) for s in range(10)])
    assert len(resumed.lrs) == 10 - 4
    assert resumed.lrs == pytest.approx([0.1 * factor(s)
                                         for s in range(5, 11)])
    assert resumed.lrs[:5] == pytest.approx(whole.lrs[5:])


def test_resume_drops_an_optimizer_state_that_does_not_fit(raw_graphs,
                                                           tmp_path):
    """An Adam state resumed into SGD, or into Adam over other shapes, is
    dropped for a fresh state and a fresh schedule, as the reference falls
    back (F1); the port's ``load_state_dict`` alone would take it and fail
    at the first step."""
    _, gt_raw = raw_graphs
    path = str(tmp_path / "gcn.pkl")
    kw = dict(device="cpu", epochs=6, lr=0.1, lr_schedule="linear",
              checkpoint_path=path)
    Trainer(TrainerConfig(**kw)).run(
        NodeClfWrapper(build_model("gcn", **MODEL_KW)), gt_raw)
    model = build_model("gcn", **MODEL_KW)
    sgd, _ = build_optimizer(TrainerConfig(optimizer="sgd", **kw),
                             model.parameters())
    saved = load_checkpoint(path)["opt_state"]
    from cogdl_tpu_torch.trainer.checkpoint import to_torch
    from cogdl_tpu_torch.trainer.trainer import _opt_state_fits

    adam, _ = build_optimizer(TrainerConfig(**kw), model.parameters())
    assert _opt_state_fits(adam, to_torch(saved))
    assert not _opt_state_fits(sgd, to_torch(saved))
    wide = build_model("gcn", **{**MODEL_KW, "hidden_size": 13})
    assert not _opt_state_fits(
        build_optimizer(TrainerConfig(**kw), wide.parameters())[0],
        to_torch(saved))
    trainer = _LrTrainer(TrainerConfig(optimizer="sgd", resume_training=True,
                                       **kw))
    res = trainer.run(NodeClfWrapper(model), gt_raw)
    assert np.isfinite(res["train_loss"])
    assert trainer.lrs[0] == pytest.approx(0.1)


@pytest.mark.parametrize("eval_step", [1, 7])
def test_progress_prints_every_20th_epoch(raw_graphs, capsys, eval_step):
    """``progress=True`` prints epochs 0, 20, 40 whatever ``eval_step`` is,
    with the last batch's loss, as the reference does (F2)."""
    _, gt_raw = raw_graphs
    res = Trainer(TrainerConfig(device="cpu", epochs=41, progress=True,
                                eval_step=eval_step, patience=100)).run(
        NodeClfWrapper(build_model("gcn", **MODEL_KW)), gt_raw)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("epoch ")]
    assert [ln.split(":")[0] for ln in lines] == ["epoch 0", "epoch 20",
                                                  "epoch 40"]
    assert all(np.isfinite(float(ln.split("loss=")[1])) for ln in lines)
    assert np.isfinite(res["train_loss"])


@pytest.mark.parametrize("option", [{"bf16": True}, {"attack": "fgsm"},
                                    {"profile_dir": "x"},
                                    {"activation_compression": True},
                                    {"logger": "print"}])
def test_unported_trainer_options_raise(option):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TrainerConfig(**option)


class _BatchCounting(NodeClfWrapper):
    """Two batches (the graph twice) per ``train_batches`` call, counted."""

    def __init__(self, model, refresh):
        super().__init__(model)
        self.refresh_per_epoch = refresh
        self.reads = 0

    def train_batches(self, graph):
        self.reads += 1
        return [graph, graph]


@pytest.mark.parametrize("refresh", [False, True])
def test_refresh_per_epoch_reads_the_batches_every_epoch(raw_graphs, refresh):
    """As the JAX trainer: the batch list is read once, or before every
    epoch when the wrapper asks for it."""
    _, gt_raw = raw_graphs
    w = _BatchCounting(build_model("gcn", **MODEL_KW), refresh)
    res = Trainer(TrainerConfig(device="cpu", epochs=4)).run(w, gt_raw)
    assert w.reads == (4 if refresh else 1)
    assert np.isfinite(res["train_loss"])


class _RowWrapper(NodeClfWrapper):
    """The epoch protocol: three rows an epoch, each made into the full
    graph's batch; ``train_batches`` must not be read."""

    def __init__(self, model):
        super().__init__(model)
        self.rows, self.losses = [], []

    def train_batches(self, graph):
        raise AssertionError("train_batches read under the epoch protocol")

    def epoch_xs(self, graph):
        return torch.arange(3)

    def make_batch(self, graph, x):
        self.rows.append(int(x))
        return graph

    def loss(self, graph, generator=None, training=True):
        loss = super().loss(graph, generator, training)
        self.losses.append(float(loss.detach()))
        return loss


def test_epoch_protocol_takes_one_step_a_row(raw_graphs):
    """One optimizer step (and one schedule step, as optax counts updates)
    per row of ``epoch_xs``; ``train_loss`` is the mean of the last epoch's
    losses."""
    _, gt_raw = raw_graphs
    w = _RowWrapper(build_model("gcn", **MODEL_KW))
    cfg = TrainerConfig(device="cpu", epochs=2, lr_schedule="linear",
                        eval_step=1, patience=10)
    trainer = Trainer(cfg)
    seen = []
    real_step = trainer.train_step

    def step(wrapper, optimizer, scheduler, batch, generator):
        out = real_step(wrapper, optimizer, scheduler, batch, generator)
        seen.append(scheduler.last_epoch)
        return out

    trainer.train_step = step
    res = trainer.run(w, gt_raw)
    assert w.rows == [0, 1, 2, 0, 1, 2]
    assert seen == [1, 2, 3, 4, 5, 6]
    assert res["train_loss"] == pytest.approx(np.mean(w.losses[3:]),
                                              rel=1e-6)


class _ScaledRowWrapper(_RowWrapper):
    """The epoch protocol with step losses far apart: row ``i``'s loss is
    scaled by ``i + 1``."""

    def loss(self, graph, generator=None, training=True):
        return NodeClfWrapper.loss(self, graph, generator, training) * (
            self.rows[-1] + 1)


def test_progress_prints_the_epoch_mean_under_the_epoch_protocol(
        raw_graphs, capsys):
    """F3: under the epoch protocol the printed loss is the mean over the
    epoch's steps, as the reference prints ``mean(losses[-1])`` of its
    scanned epoch (cogdl_tpu/trainer/trainer.py:357,411-413)."""
    _, gt_raw = raw_graphs
    w = _ScaledRowWrapper(build_model("gcn", **MODEL_KW))
    losses = []
    trainer = Trainer(TrainerConfig(device="cpu", epochs=1, progress=True,
                                    patience=10))
    real_step = trainer.train_step

    def step(*a):
        out = real_step(*a)
        losses.append(float(out))
        return out

    trainer.train_step = step
    trainer.run(w, gt_raw)
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("epoch ")]
    assert len(losses) == 3 and losses[2] > 2 * losses[0]
    assert float(line.split("loss=")[1]) == pytest.approx(np.mean(losses),
                                                          abs=5e-5)
