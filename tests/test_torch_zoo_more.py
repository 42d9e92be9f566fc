"""The rest of ROADMAP item 12's full-batch models in cogdl_tpu_torch
(``sign``, ``dropedge_gcn``, ``revgcn``, ``revgat``, ``revgen``, ``grand``,
``pprgo``, ``moe_gcn``, ``robustgcn``, ``gnnguard_gcn``, ``gdc_gcn``,
``actgcn``, ``autognn``) against the JAX package on the CPU.

Each model gets the JAX model's initial weights through
``load_jax_params``; logits are held at 1e-5 and the parameter gradients
of the masked cross-entropy at 1e-4, with and without ``prepare_spmm``'s
structure (which the in-forward reweights of DropEdge, RobustGCN and
GNNGuard then carry to K1's plain version). Draws torch cannot reproduce
from flax are held out: the models run in evaluation mode, GRAND's
training branch runs at ``dropnode_rate=0``, and DropEdge's training
branch runs with ``drop_edge`` patched to one fixed mask in both packages.
RevGCN and RevGAT's checkpointed blocks are held against themselves
without checkpointing at dropout 0.5, and one ``experiment()`` loss curve
a model against the JAX trainer's."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu.utils.transforms as j_transforms
import cogdl_tpu_torch.data.graph as tg
import cogdl_tpu_torch.utils.transforms as t_transforms
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from cogdl_tpu_torch.trainer.trainer import Trainer
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from cogdl_tpu_torch.wrappers.sampled_node_classification import (
    reads_kernel_structure,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 on both sides with the same weights, summed in other orders: logits
# 1e-5, grads 1e-4 (tests/test_torch_zoo_models.py); per-epoch losses after
# a few Adam steps from the same weights 1e-4
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-4
F_IN, CLASSES = 12, 4

NAMES = ("sign", "dropedge_gcn", "revgcn", "revgat", "revgen", "grand",
         "pprgo", "moe_gcn", "robustgcn", "gnnguard_gcn", "gdc_gcn",
         "actgcn", "autognn")
# registry name and small constructor arguments (dropout 0)
CASES = {
    "sign": ("sign", dict(hidden_size=8, num_hops=2)),
    "dropedge_gcn": ("dropedge_gcn", dict(hidden_size=8, num_layers=3)),
    "revgcn": ("revgcn", dict(hidden_size=8, num_layers=2)),
    "revgat": ("revgat", dict(hidden_size=8, num_layers=2, nhead=2)),
    "revgen": ("revgen", dict(hidden_size=8, num_layers=2)),
    "grand": ("grand", dict(hidden_size=8, order=3, input_dropout=0.0,
                            hidden_dropout=0.0, dropnode_rate=0.0)),
    "pprgo": ("pprgo", dict(hidden_size=8)),
    "moe_gcn": ("moe_gcn", dict(hidden_size=8, num_experts=3)),
    "moe_gcn-3": ("moe_gcn", dict(hidden_size=6, num_layers=3)),
    "robustgcn": ("robustgcn", dict(hidden_size=8)),
    "gnnguard_gcn": ("gnnguard_gcn", dict(hidden_size=8)),
    "gnnguard_gcn-3": ("gnnguard_gcn", dict(hidden_size=8, num_layers=3,
                                            threshold=0.2)),
    "gdc_gcn": ("gdc_gcn", dict(hidden_size=8)),
    "actgcn": ("actgcn", dict(hidden_size=8)),
    "actgcn-3": ("actgcn", dict(hidden_size=8, num_layers=3)),
    "autognn": ("autognn", dict(hidden_size=8)),
    "autognn-gat": ("autognn", dict(conv_type="gat", hidden_size=32)),
    "autognn-sage": ("autognn", dict(conv_type="sage", hidden_size=8)),
}
# the ones whose training branch draws nothing at dropout 0
TRAINING_CASES = ("sign", "revgcn", "revgen", "grand", "pprgo", "moe_gcn",
                  "gnnguard_gcn", "actgcn", "autognn")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _j_graph():
    return jg.add_self_loops(j_sbm(num_nodes=200, feat_dim=F_IN, seed=5))


@pytest.fixture(scope="module")
def graphs():
    """The same 200-node sbm graph in both packages, with self loops on the
    JAX side (the port's wrapper adds its own)."""
    return _j_graph(), t_sbm(num_nodes=200, feat_dim=F_IN, seed=5)


def _pair(name, seed=0, **extra):
    """The JAX model with its initial variables, and the port model
    carrying them."""
    model, cfg = CASES[name]
    kw = dict(in_features=F_IN, out_features=CLASSES, dropout=0.0, **cfg)
    kw.update(extra)
    gj = _j_graph()
    jm = j_build_model(model, **kw)
    variables = _host(jm.init({"params": jax.random.PRNGKey(seed),
                               "dropout": jax.random.PRNGKey(seed)},
                              gj, gj.x, training=False))
    tm = build_model(model, **kw)
    load_jax_params(tm, variables["params"], variables.get("batch_stats"))
    return jm, variables, tm, lambda: build_model(model, **kw)


def _port_graph(tm, gt, structure):
    g = NodeClfWrapper(tm).normalise(gt)
    return prepare_spmm(g) if structure else g


def _assert_grads(tm, grads_j, build):
    ref = build()
    load_jax_params(ref, _host(grads_j))
    ref_params = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[name].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _run_both(name, graphs, structure, training, **extra):
    """Logits and loss gradients of both models on the same graph."""
    gj, gt = graphs
    jm, variables, tm, build = _pair(name, **extra)
    mask_j = gj.train_mask & gj.node_mask()

    def loss_j(params):
        logits = jm.apply({**variables, "params": params}, gj, gj.x,
                          training=training,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return j_mce(logits, gj.y, mask_j), logits

    (_, logits_j), grads_j = jax.value_and_grad(
        loss_j, has_aux=True)(variables["params"])
    g = _port_graph(tm, gt, structure)
    logits_t = tm(g, training=training,
                  generator=torch.Generator().manual_seed(0))
    masked_cross_entropy(logits_t, g.y, g.train_mask & g.node_mask()
                         ).backward()
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    _assert_grads(tm, grads_j, build)
    return tm


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_jax(graphs, name, structure):
    _run_both(name, graphs, structure, training=False)


@pytest.mark.parametrize("name", TRAINING_CASES)
def test_training_branch_matches_jax_at_dropout_0(graphs, name):
    """The training forward where it draws nothing at dropout 0: GRAND's
    DropNode at ``dropnode_rate=0``, RevGCN's blocks under checkpoint, the
    rest as in evaluation; over the kernel structure."""
    _run_both(name, graphs, structure=True, training=True)


@pytest.mark.parametrize("structure", [False, True])
def test_dropedge_training_matches_jax_under_one_mask(graphs, monkeypatch,
                                                      structure):
    """DropEdge's training branch with ``drop_edge`` patched in both
    packages to one fixed keep mask: the dropped weights normalised again
    (over the structure, K1's plain version reads them) give the JAX
    logits and grads. The JAX forward imports ``drop_edge`` at call time,
    so the patch reaches it."""
    gj, _ = graphs
    rate = 0.3
    keep = np.random.default_rng(0).uniform(size=gj.e_pad) >= rate

    def j_drop(graph, r, rng):
        w = graph.edge_weight * jnp.asarray(keep) / (1.0 - r)
        return graph.replace(edge_weight=w, meta=tuple(
            (k, v) for k, v in graph.meta if k != "norm"))

    def t_drop(graph, r, generator=None):
        w = graph.edge_weight * torch.from_numpy(keep) / (1.0 - r)
        return graph.replace(edge_weight=w, meta=tuple(
            (k, v) for k, v in graph.meta if k != "norm"))

    monkeypatch.setattr(j_transforms, "drop_edge", j_drop)
    monkeypatch.setattr(t_transforms, "drop_edge", t_drop)
    _run_both("dropedge_gcn", graphs, structure, training=True,
              dropedge_rate=rate)


def test_dropedge_trains_over_the_wrappers_raw_weights(graphs):
    """No ``adj_norm``: the wrapper leaves the self-loop graph's raw
    weights; a training forward over the structure reads dropped weights
    (another generator seed, other logits) and leaves the graph as it
    was."""
    _, gt = graphs
    tm = _pair("dropedge_gcn")[2]
    assert getattr(tm, "adj_norm", None) is None
    g = _port_graph(tm, gt, structure=True)
    assert "norm" not in dict(g.meta)
    w0 = g.extras["spmm_fw_w"].clone()
    a = tm(g, training=True, generator=torch.Generator().manual_seed(1))
    b = tm(g, training=True, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a, b)
    assert torch.equal(g.extras["spmm_fw_w"], w0)


# -- RevGCN and RevGAT under checkpoint -----------------------------------------

def _grads(model, g, seed):
    gen = torch.Generator().manual_seed(seed)
    model.zero_grad()
    logits = model(g, training=True, generator=gen)
    masked_cross_entropy(logits, g.y, g.train_mask & g.node_mask()).backward()
    return logits, {n: p.grad.clone() for n, p in model.named_parameters()}, gen


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", ["revgcn", "revgat"])
def test_rev_checkpoint_grads_equal_the_unchecked_grads_under_dropout(
        graphs, name, structure):
    """At dropout 0.5 from one generator seed, the checkpointed blocks give
    the logits and grads the same blocks give without checkpointing: every
    draw (GCN dropout masks; GAT's K3 seed over the structure, its keep mask
    without) is made outside the checkpointed call, so the recompute drops
    what the forward dropped, and the generator ends in the same state."""
    _, gt = graphs
    m = build_model(name, in_features=F_IN, out_features=CLASSES,
                    hidden_size=8, num_layers=2, dropout=0.5)
    m.reset_parameters(torch.Generator().manual_seed(1))
    assert m.remat
    plain = copy.deepcopy(m)
    plain.remat = False
    g = _port_graph(m, gt, structure)
    lr, gr, gen_r = _grads(m, g, seed=3)
    lp, gp, gen_p = _grads(plain, g, seed=3)
    assert torch.equal(lr, lp)
    for key in gr:
        torch.testing.assert_close(gr[key], gp[key], rtol=0, atol=0,
                                   msg=key)
    assert torch.equal(gen_r.get_state(), gen_p.get_state())
    other, _, _ = _grads(m, g, seed=4)
    assert not torch.equal(other, lr)


def test_revgat_runs_the_fused_route_over_the_structure(graphs, monkeypatch):
    """Over the structure each GAT layer of a block takes the fused route
    (K3's plain version here), and the checkpointed backward recomputes
    it: a train step calls it twice per layer."""
    from cogdl_tpu_torch.layers import gat_layer

    _, gt = graphs
    m = _pair("revgat")[2]
    g = _port_graph(m, gt, structure=True)
    calls = []
    real = gat_layer.maybe_cuda_gat_fused

    def record(*a, **kw):
        out = real(*a, **kw)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(gat_layer, "maybe_cuda_gat_fused", record)
    masked_cross_entropy(m(g, training=True), g.y, g.train_mask).backward()
    assert calls == [True] * 8


# -- the in-forward reweights over the structure --------------------------------

def test_robustgcn_views_share_the_structure_with_their_own_weights(graphs):
    from cogdl_tpu_torch.models.nn.robustgcn import dual_norm_weights

    _, gt = graphs
    tm = _pair("robustgcn")[2]
    g = _port_graph(tm, gt, structure=True)
    assert "norm" not in dict(g.meta)
    w0, w1 = dual_norm_weights(g)
    v0, v1 = g.replace(edge_weight=w0), g.replace(edge_weight=w1)
    assert v0.extras["spmm_fw_ptr"] is v1.extras["spmm_fw_ptr"]
    E = g.num_edges
    assert torch.equal(v0.extras["spmm_fw_w"], w0[:E])
    assert torch.equal(v1.extras["spmm_fw_w"], w1[:E])


def test_gnnguard_weights_reach_k1_with_their_gradient(graphs):
    """The reweight of the second layer carries the first layer's output
    gradient: the structure's ``spmm_fw_w`` requires it, and the model's
    grads over the structure equal those without (K1's ``dw``)."""
    from cogdl_tpu_torch.utils.grb import gnnguard_reweight

    _, gt = graphs
    tm = _pair("gnnguard_gcn")[2]
    g = _port_graph(tm, gt, structure=True)
    h = torch.randn(g.n_pad, 8, requires_grad=True)
    rg = gnnguard_reweight(g, h)
    assert rg.extras["spmm_fw_w"].requires_grad
    assert not rg.extras["spmm_bw_w"].requires_grad


@pytest.mark.parametrize("name", ["sign", "grand", "moe_gcn", "actgcn",
                                  "revgcn", "autognn"])
def test_in_model_sym_norm_keeps_the_wrappers_structure(graphs, name):
    """The models that normalise inside their forward carry ``adj_norm =
    "sym"`` (AutoGNN its GCN backbone's), so the wrapper normalises before
    ``prepare_spmm`` and the forward's own ``sym_norm`` is a no-op."""
    _, gt = graphs
    tm = _pair(name)[2]
    assert tm.adj_norm == "sym"
    g = _port_graph(tm, gt, structure=True)
    assert tg.sym_norm(g) is g


@pytest.mark.parametrize("name,norm", [("gdc_gcn", "none"),
                                       ("pprgo", None), ("robustgcn", None),
                                       ("gnnguard_gcn", None),
                                       ("autognn-gat", None)])
def test_models_that_read_the_raw_self_loop_weights(graphs, name, norm):
    _, gt = graphs
    tm = _pair(name)[2]
    assert getattr(tm, "adj_norm", None) == norm
    g = NodeClfWrapper(tm).normalise(gt)
    assert torch.equal(g.edge_weight, tg.add_self_loops(gt).edge_weight)


def test_reads_kernel_structure_knows_the_slice():
    for name in NAMES:
        net = build_model(name, in_features=F_IN, out_features=CLASSES)
        assert reads_kernel_structure(net) == (name != "revgen"), name


@pytest.mark.parametrize("name", NAMES)
def test_reset_parameters_is_seeded_and_resets_everything(name):
    kw = dict(in_features=F_IN, out_features=CLASSES)
    a, b = build_model(name, **kw), build_model(name, **kw)
    with torch.no_grad():
        for p in b.parameters():
            p.fill_(7.0)
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(9))
    for (pname, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), pname


# -- experiment() ----------------------------------------------------------------

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


CURVES = {
    "sign": dict(hidden_size=16, num_hops=2),
    "revgcn": dict(hidden_size=8, num_layers=2),
    "grand": dict(hidden_size=16, order=3, dropnode_rate=0.0,
                  input_dropout=0.0, hidden_dropout=0.0),
    "gnnguard_gcn": dict(hidden_size=16),
    "actgcn": dict(hidden_size=16),
}


@pytest.mark.parametrize("model", sorted(CURVES))
def test_loss_curve_matches_the_jax_trainer(monkeypatch, model):
    """``experiment(model=...)`` against ``cogdl_tpu.experiments.train``
    from the JAX initial weights, no draw in the step: the same train loss
    at every epoch (the wrapper's graph, the model, Adam with weight decay;
    for ActGCN its quantised weight gradients)."""
    kw = dict(epochs=4, eval_step=1, patience=100, seed=0, dropout=0.0,
              **CURVES[model])
    rec = _Recorder()
    res_j = j_train("sbm", model, logger=rec, **kw)
    # the JAX trainer's initial weights: the second half of split(key(seed))
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    gj = j_sbm()
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
    (res_t,) = experiment(dataset="sbm", model=model, device="cpu",
                          **kw)[("sbm", model)]
    assert len(steps) == 4
    np.testing.assert_allclose(steps, rec.losses, rtol=LOSS_RTOL)
    assert res_t["best_epoch"] == res_j["best_epoch"]
    assert res_t["test_acc"] == pytest.approx(res_j["test_acc"], abs=1e-6)


@pytest.mark.parametrize("model", NAMES)
def test_experiment_runs_every_model_of_the_slice_on_the_cpu(model):
    """Each registry name trains through ``experiment()`` on the CPU, its
    default wrapper and default widths, and launches no kernel there."""
    sk.reset_launch_counts()
    (res,) = experiment(dataset="sbm", model=model, epochs=2, eval_step=1,
                        device="cpu")[("sbm", model)]
    assert np.isfinite(res["train_loss"]) and 0.0 <= res["test_acc"] <= 1.0
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)
