"""cogdl_tpu_torch's DisenGCN and SRGCN against the JAX package on the CPU.

Each model gets the JAX model's initial weights through
``load_jax_params``; logits are held at 1e-5 and the parameter gradients
of the masked cross-entropy at 1e-4, SRGCN under all 30 pairs of attention
type and normalisation; and each model's ``experiment()`` loss curve at
dropout 0 against the JAX trainer's at 1e-4. Neither model runs a kernel:
both propagate with index ops (DisenGCN's routing) or ``spmm_coo``
(SRGCN), as the JAX package does."""

import jax
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu_torch.data.graph as tg
from cogdl_tpu.datasets import build_dataset as j_build_dataset
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.models.nn import srgcn as j_srgcn
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu_torch.datasets import build_dataset
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.models.nn import srgcn as t_srgcn
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.trainer.trainer import Trainer
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from cogdl_tpu_torch.wrappers import DEFAULT_WRAPPER
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from cogdl_tpu_torch.wrappers.sampled_node_classification import (
    reads_kernel_structure,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 on both sides with the same weights, summed in other orders: logits
# 1e-5, grads 1e-4; per-epoch losses after a few Adam steps 1e-4
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-4
F_IN, CLASSES, NODES = 12, 4, 120
SRGCN_PAIRS = [(a, n) for a in t_srgcn.ATTENTION_TYPES
               for n in t_srgcn.NORM_TYPES]


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def graphs():
    """The same sbm graph in both packages, with self loops, as both
    wrappers prepare it."""
    return (jg.add_self_loops(j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5)),
            tg.add_self_loops(t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5)))


def _run_both(graphs, model, edit=None, **kw):
    """Logits and loss gradients of the JAX model and the port model that
    carries its initial weights (after ``edit`` of the JAX parameters, if
    given), on the same graph: held at the tolerances above."""
    gj, gt = graphs
    kw = dict(in_features=F_IN, out_features=CLASSES, dropout=0.0, **kw)
    jm = j_build_model(model, **kw)
    variables = _host(jm.init({"params": jax.random.PRNGKey(3),
                               "dropout": jax.random.PRNGKey(3)},
                              gj, gj.x, training=False))
    if edit is not None:
        edit(variables["params"])
    tm = load_jax_params(build_model(model, **kw), variables["params"])
    mask_j = gj.train_mask & gj.node_mask()

    def loss_j(params):
        logits = jm.apply({"params": params}, gj, gj.x, training=True)
        return j_mce(logits, gj.y, mask_j), logits

    (_, logits_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    logits_t = tm(gt, training=True)
    masked_cross_entropy(logits_t, gt.y, gt.train_mask & gt.node_mask()
                         ).backward()
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    ref = load_jax_params(build_model(model, **kw), _host(grads_j))
    ref_params = dict(ref.named_parameters())
    assert set(ref_params) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[name].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    return tm


@pytest.mark.parametrize("kw", [{}, dict(channels=3, channel_dim=5,
                                         num_layers=3, routing_iters=2)])
def test_disengcn_matches_jax(graphs, kw):
    tm = _run_both(graphs, "disengcn", **kw)
    assert {n for n, _ in tm.named_parameters()} >= {
        "layer0.proj.weight", "layer0.proj.bias", "out.weight", "out.bias"}


@pytest.mark.parametrize("attention,normalization", SRGCN_PAIRS)
def test_srgcn_matches_jax(graphs, attention, normalization):
    """Every attention type under every normalisation (30 pairs). Initial
    values moved: ``heat``'s ``heat_t`` off zero, where its weights are all
    1 whatever the graph; and under the two normalisations that divide an
    edge's weight by the row sum of its source (``col_uniform``,
    ``symmetry``), ``edge``'s ``att_p`` / ``att_q`` kernels scaled by 0.1
    and their biases set to 1, so that every ReLU score is positive. At
    the initial values a node whose own and neighbours' scores are all 0
    (about one in thirty here) has a row sum of 0, the 1e-12 floor then
    scales its weights by up to 1e12 in both packages, and float32
    rounding alone is 1e-4 of gradients of 1e10. The other three
    normalisations keep the scores' zero branch."""
    pos_scores = attention == "edge" and normalization in ("col_uniform",
                                                           "symmetry")

    def edit(params):
        for layer in params.values():
            for key in layer:
                if key.startswith("heat_t"):
                    layer[key] = np.full(1, 0.3, np.float32)
                if key.startswith(("att_p", "att_q")) and pos_scores:
                    layer[key]["kernel"] = layer[key]["kernel"] * 0.1
                    layer[key]["bias"] = np.ones(1, np.float32)

    tm = _run_both(graphs, "srgcn", edit=edit, hidden_size=8,
                   attention=attention, normalization=normalization)
    if attention == "heat":
        assert float(tm.layer0.heat_t0.detach()) == pytest.approx(0.3)


@pytest.mark.parametrize("model,kw", [
    ("disengcn", {}), ("srgcn", dict(attention="edge")),
    ("srgcn", dict(attention="heat"))])
def test_load_jax_params_refuses_a_leaf_left_over(graphs, model, kw):
    """DisenGCN's ``proj`` and ``out``, SRGCN's ``W{r}``, ``att_p{r}``,
    ``att_q{r}`` and ``heat_t{r}`` each have their place; one more leaf
    raises."""
    gj, _ = graphs
    kw = dict(in_features=F_IN, out_features=CLASSES, **kw)
    params = _host(j_build_model(model, **kw).init(
        jax.random.PRNGKey(0), gj, gj.x, training=False))["params"]
    load_jax_params(build_model(model, **kw), params)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(build_model(model, **kw),
                        dict(params, extra={"bias": np.zeros(2)}))


def test_srgcn_and_disengcn_read_no_kernel_structure():
    for name in ("disengcn", "srgcn"):
        net = build_model(name, in_features=F_IN, out_features=CLASSES)
        assert not reads_kernel_structure(net), name
        assert DEFAULT_WRAPPER[name] == "node_classification"


def test_srgcn_refuses_unknown_types_and_resets_heat():
    with pytest.raises(ValueError, match="attention"):
        build_model("srgcn", in_features=4, out_features=2, attention="x")
    with pytest.raises(ValueError, match="normalization"):
        build_model("srgcn", in_features=4, out_features=2,
                    normalization="x")
    net = build_model("srgcn", in_features=4, out_features=2,
                      attention="heat")
    with torch.no_grad():
        net.layer1.heat_t1.fill_(2.0)
    net.reset_parameters(torch.Generator().manual_seed(0))
    assert float(net.layer1.heat_t1) == 0.0


def test_gaussian_and_ppr_series_are_the_jax_packages():
    gj = jg.add_self_loops(j_sbm(num_nodes=40, feat_dim=4, seed=1))
    assert t_srgcn._ppr_series() == pytest.approx([0.4, 0.24, 0.144, 0.0864])
    from scipy.special import iv

    want = [iv(0, 1.0), 2 * iv(1, 1.0), -2 * iv(2, 1.0), 2 * iv(3, 1.0)]
    assert t_srgcn._gaussian_series() == pytest.approx(want)
    np.testing.assert_array_equal(
        np.asarray(j_srgcn._degrees(gj)),
        t_srgcn._degrees(tg.add_self_loops(
            t_sbm(num_nodes=40, feat_dim=4, seed=1))).numpy())


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


CURVES = {"disengcn": dict(channels=4, channel_dim=8),
          "srgcn": dict(hidden_size=16, attention="heat",
                        normalization="row_softmax")}


@pytest.mark.parametrize("model", sorted(CURVES))
def test_loss_curve_matches_the_jax_trainer(monkeypatch, model):
    """``experiment(model=...)`` against ``cogdl_tpu.experiments.train``
    from the JAX initial weights, dropout 0: the same train loss at every
    epoch, the same best epoch and test accuracy; no kernel launched."""
    kw = dict(epochs=4, eval_step=1, patience=100, seed=0, dropout=0.0,
              **CURVES[model])
    rec = _Recorder()
    jd = j_build_dataset("sbm", num_nodes=200)
    res_j = j_train(jd, model, logger=rec, **kw)
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    gj = jd.graph
    variables = _host(j_build_model(
        model, in_features=gj.x.shape[1], out_features=4, dropout=0.0,
        **CURVES[model]).init({"params": init_rng, "dropout": init_rng}, gj,
                              gj.x, training=False))
    monkeypatch.setattr(
        NodeClfWrapper, "init", lambda self, gen, graph: load_jax_params(
            self.model, variables["params"]))
    steps = []
    real_step = Trainer.train_step

    def step(self, *a):
        loss = real_step(self, *a)
        steps.append(float(loss))
        return loss

    monkeypatch.setattr(Trainer, "train_step", step)
    sk.reset_launch_counts()
    (res_t,) = experiment(dataset=build_dataset("sbm", num_nodes=200),
                          model=model, device="cpu", **kw)[("sbm", model)]
    assert len(steps) == 4
    np.testing.assert_allclose(steps, rec.losses, rtol=LOSS_RTOL)
    assert res_t["best_epoch"] == res_j["best_epoch"]
    assert res_t["test_acc"] == pytest.approx(res_j["test_acc"], abs=1e-6)
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)
