"""cogdl_tpu_torch's full-batch node-classification zoo (``gcnii``,
``appnp`` / ``ppnp``, ``mixhop``, ``sgc``, ``mlp``, ``deepergcn``,
``drgcn``, ``drgat``) against the JAX package on the CPU.

Each model gets the JAX model's initial weights through
``load_jax_params``; logits are held at 1e-5 and the parameter gradients
of the masked cross-entropy at 1e-4, with and without ``prepare_spmm``'s
structure. The JAX model runs on the graph the JAX wrapper prepares (self
loops only: the model normalises inside its forward), the port model on
the port wrapper's (self loops and the model's ``adj_norm``). Batch norm's
training-mode logits and running statistics are held against flax's;
DeeperGCN's ``remat`` against the JAX ``remat=True`` and against itself
without checkpointing at dropout 0.5; and one ``experiment()`` loss curve
a model family against the JAX trainer's."""

import copy

import jax
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
import cogdl_tpu_torch.data.graph as tg
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.experiments import train as j_train
from cogdl_tpu.models import SUPPORTED_MODELS as JAX_MODELS
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.experiments import experiment
from cogdl_tpu_torch.models import SUPPORTED_MODELS, build_model
from cogdl_tpu_torch.models import load_jax_params
from cogdl_tpu_torch.ops.cuda import prepare_spmm
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
# 1e-5, grads 1e-4 (tests/test_torch_gcn.py); per-epoch losses after a few
# Adam steps from the same weights 1e-4 (tests/test_torch_sampling.py)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-4
F_IN, CLASSES = 12, 4

ZOO = ("gcnii", "appnp", "ppnp", "mixhop", "sgc", "mlp", "deepergcn",
       "drgcn", "drgat")
# registry name and small constructor arguments (dropout 0); the ones that
# propagate keep a few layers so that K1's plain version runs several times
CASES = {
    "gcnii": ("gcnii", dict(hidden_size=16, num_layers=4)),
    "appnp": ("appnp", dict(hidden_size=16, propagation_steps=3)),
    "ppnp": ("ppnp", dict(hidden_size=8, num_layers=3)),
    "mixhop": ("mixhop", dict(hidden_size=8)),
    "mixhop-13": ("mixhop", dict(hidden_size=6, powers=(1, 3),
                                 num_layers=3)),
    "sgc": ("sgc", dict(order=3)),
    "mlp": ("mlp", dict(hidden_size=16, num_layers=3)),
    "mlp-batchnorm": ("mlp", dict(hidden_size=16, norm="batchnorm")),
    "mlp-layernorm": ("mlp", dict(hidden_size=16, norm="layernorm")),
    "deepergcn": ("deepergcn", dict(hidden_size=16, num_layers=3)),
    "deepergcn-powermean": ("deepergcn", dict(hidden_size=8, num_layers=2,
                                              aggr="powermean")),
    "drgcn": ("drgcn", dict(hidden_size=16)),
    "drgcn-3": ("drgcn", dict(hidden_size=8, num_layers=3)),
    "drgat": ("drgat", dict(hidden_size=4, nhead=2)),
}
BATCHNORM_CASES = ("mlp-batchnorm", "deepergcn", "deepergcn-powermean")
PROPAGATING = ("gcnii", "appnp", "ppnp", "mixhop", "sgc", "drgcn", "drgat")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def graphs():
    """The same 200-node sbm graph in both packages (the port's generator
    draws the JAX package's arrays), with self loops."""
    return (jg.add_self_loops(j_sbm(num_nodes=200, feat_dim=F_IN, seed=5)),
            t_sbm(num_nodes=200, feat_dim=F_IN, seed=5))


def _pair(name, seed=0, **extra):
    """The JAX model with its initial variables, and the port model
    carrying them."""
    model, cfg = CASES[name]
    kw = dict(in_features=F_IN, out_features=CLASSES, dropout=0.0, **cfg,
              **extra)
    gj = jg.add_self_loops(j_sbm(num_nodes=200, feat_dim=F_IN, seed=5))
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
    """Logits and loss gradients of both models on the same graph; returns
    the port model and the JAX variables after the call."""
    gj, gt = graphs
    jm, variables, tm, build = _pair(name, **extra)
    mask_j = gj.train_mask & gj.node_mask()
    mutable = ["batch_stats"] if training and "batch_stats" in variables \
        else False

    def loss_j(params):
        out = jm.apply({**variables, "params": params}, gj, gj.x,
                       training=training, mutable=mutable,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        logits, upd = out if mutable else (out, {})
        return j_mce(logits, gj.y, mask_j), (logits, upd)

    (_, (logits_j, upd)), grads_j = jax.value_and_grad(
        loss_j, has_aux=True)(variables["params"])
    g = _port_graph(tm, gt, structure)
    logits_t = tm(g, training=training)
    masked_cross_entropy(logits_t, g.y, g.train_mask & g.node_mask()
                         ).backward()
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    _assert_grads(tm, grads_j, build)
    return tm, {**variables, **_host(upd)}


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_jax(graphs, name, structure):
    _run_both(name, graphs, structure, training=False)


@pytest.mark.parametrize("name", BATCHNORM_CASES)
def test_batchnorm_models_in_training_match_flax(graphs, name):
    """Training mode at dropout 0: batch statistics in the forward (over all
    rows for the MLP, over the real nodes for DeeperGCN's blocks), and the
    running statistics the call leaves equal to flax's updated
    ``batch_stats``."""
    tm, variables = _run_both(name, graphs, structure=True, training=True)
    ref = CASES[name][0]
    stats = build_model(ref, in_features=F_IN, out_features=CLASSES,
                        **CASES[name][1])
    load_jax_params(stats, variables["params"], variables["batch_stats"])
    buffers = dict(stats.named_buffers())
    assert buffers
    for key, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), buffers[key].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


# -- DeeperGCN under remat -------------------------------------------------------

@pytest.mark.parametrize("training", [False, True])
def test_deepergcn_remat_matches_jax_remat(graphs, training):
    """``remat=True``: LayerNorm blocks, each checkpointed, against the JAX
    model's ``nn.remat`` blocks (flax ``LayerNorm`` ``scale`` → ``weight``)."""
    tm, _ = _run_both("deepergcn", graphs, structure=False,
                      training=training, remat=True)
    assert isinstance(tm.block0.norm, torch.nn.LayerNorm)


def _deepergcn_grads(model, g, seed):
    gen = torch.Generator().manual_seed(seed)
    model.zero_grad()
    logits = model(g, training=True, generator=gen)
    masked_cross_entropy(logits, g.y, g.train_mask & g.node_mask()).backward()
    return logits, {n: p.grad.clone() for n, p in model.named_parameters()}, gen


def test_deepergcn_remat_grads_equal_the_unchecked_grads_under_dropout(
        graphs):
    """At dropout 0.5 from one generator seed, the checkpointed blocks give
    the logits and grads the same blocks give without checkpointing: the
    dropout masks are drawn outside the checkpointed call, so the
    recompute drops the same elements, and the generator ends in the same
    state. Checkpointing keeps fewer bytes for the backward."""
    _, gt = graphs
    m = build_model("deepergcn", in_features=F_IN, out_features=CLASSES,
                    hidden_size=16, num_layers=3, dropout=0.5, remat=True)
    m.reset_parameters(torch.Generator().manual_seed(1))
    plain = copy.deepcopy(m)
    plain.remat = False
    g = NodeClfWrapper(m).prepare_graph(gt)
    saved = {}
    for label, net in (("remat", m), ("plain", plain)):
        total = [0]

        def pack(t, total=total):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            saved[label] = _deepergcn_grads(net, g, seed=3)
        saved[label] += (total[0],)
    (lr, gr, gen_r, bytes_r), (lp, gp, gen_p, bytes_p) = (saved["remat"],
                                                          saved["plain"])
    assert torch.equal(lr, lp)
    assert gr.keys() == gp.keys()
    for name in gr:
        torch.testing.assert_close(gr[name], gp[name], rtol=0, atol=0,
                                   msg=name)
    assert torch.equal(gen_r.get_state(), gen_p.get_state())
    assert bytes_r < bytes_p / 2
    # and the masks were drawn: another seed gives other logits
    other, _, _ = _deepergcn_grads(m, g, seed=4)
    assert not torch.equal(other, lr)


# -- the wrapper's normalisation and the kernel structure ----------------------

@pytest.mark.parametrize("name", ["gcnii", "appnp", "mixhop", "sgc", "drgcn"])
def test_in_model_sym_norm_keeps_the_wrappers_structure(graphs, name,
                                                        monkeypatch):
    """The models that normalise inside their forward carry ``adj_norm =
    "sym"`` as a class attribute, so the wrapper normalises before
    ``prepare_spmm``; the forward's own ``sym_norm`` is then a no-op by the
    graph's tag and every ``spmm`` reads the structure (K1's route), whose
    weights are the graph's."""
    from cogdl_tpu_torch.ops import cuda

    _, gt = graphs
    tm = _pair(name)[2]
    assert type(tm).adj_norm == "sym"
    g = prepare_spmm(NodeClfWrapper(tm).normalise(gt))
    assert tg.sym_norm(g) is g
    torch.testing.assert_close(g.extras["spmm_fw_w"],
                               g.edge_weight[: g.num_edges], rtol=0, atol=0)
    routes = []
    real = cuda.maybe_cuda_spmm

    def record(graph, x):
        out = real(graph, x)
        routes.append(out is not None)
        return out

    monkeypatch.setattr(cuda, "maybe_cuda_spmm", record)
    tm(g)
    assert routes and all(routes)


def test_drgat_reads_the_graph_unnormalised(graphs):
    _, gt = graphs
    tm = _pair("drgat")[2]
    assert getattr(tm, "adj_norm", None) is None
    g = NodeClfWrapper(tm).normalise(gt)
    assert "norm" not in dict(g.meta)
    assert torch.equal(g.edge_weight, tg.add_self_loops(gt).edge_weight)


def test_reads_kernel_structure_knows_the_zoo():
    for name in ZOO:
        net = build_model(name, in_features=F_IN, out_features=CLASSES)
        assert reads_kernel_structure(net) == (name in PROPAGATING), name


# -- the registry ------------------------------------------------------------------

def test_registry_and_defaults_name_the_zoo():
    for name in ZOO:
        assert SUPPORTED_MODELS[name].rsplit(".", 1)[1] == \
            JAX_MODELS[name].rsplit(".", 1)[1]
        assert DEFAULT_WRAPPER[name] == "node_classification"


def test_every_jax_name_the_port_lacks_is_not_yet_ported():
    """No name of the JAX registry is missing from the port any more: the
    families below cover it, each name builds, and a name of neither
    registry raises."""
    first_slices = {"gcn", "gat", "graphsage", "sage", "graphsaint"}
    rest_of_zoo = {"sign", "dropedge_gcn", "revgcn", "revgat", "revgen",
               "grand", "pprgo", "moe_gcn", "robustgcn", "gnnguard_gcn",
               "gdc_gcn", "actgcn", "autognn", "disengcn", "srgcn"}
    graph_clf = {"gin", "sortpool", "diffpool"}
    hetero = {"han", "gtn", "rgcn", "compgcn", "simple_hgn"}
    stragglers = {"graph_unet", "unet", "gcnmix", "sagn", "m3s",
                  "correct_smooth_mlp", "patchy_san"}
    self_supervised = {"dgi", "mvgrl", "grace", "graphmae", "graphmae2",
                       "bgrl", "unsup_graphsage", "infograph"}
    link_and_kg = {"gae", "vgae", "agc", "daegc", "transe", "distmult",
                   "rotate", "complex"}
    rec_and_traffic = {"lightgcn", "stgcn", "stgat"}
    embeddings = {"deepwalk", "node2vec", "line", "netmf", "netsmf",
                  "prone", "prone++", "hope", "grarep", "spectral", "sdne",
                  "dngr"}
    hetero_and_graph_emb = {"metapath2vec", "hin2vec", "pte", "gatne",
                            "graph2vec", "dgk", "gcc"}
    missing = sorted(set(JAX_MODELS) - set(SUPPORTED_MODELS))
    assert missing == []
    families = [first_slices, set(ZOO), rest_of_zoo, graph_clf, hetero,
                stragglers, self_supervised, link_and_kg, rec_and_traffic,
                embeddings, hetero_and_graph_emb]
    assert sum(len(f) for f in families) == len(set().union(*families))
    assert set().union(*families) == set(JAX_MODELS) == set(SUPPORTED_MODELS)
    for name in JAX_MODELS:
        assert build_model(name, in_features=4, out_features=2) is not None
    with pytest.raises(ValueError, match="not yet ported"):
        build_model("no_such_model", in_features=4, out_features=2)


def test_best_configs_are_the_jax_packages():
    from cogdl_tpu.configs import BEST_CONFIGS as J
    from cogdl_tpu_torch.configs import BEST_CONFIGS as T

    for name in ("gcnii", "appnp", "sgc", "mixhop", "deepergcn", "sign",
                 "grand", "dropedge_gcn", "revgcn", "gin"):
        assert T[name] == J[name], name


@pytest.mark.parametrize("name", ZOO)
def test_reset_parameters_is_seeded_and_resets_everything(name):
    kw = dict(in_features=F_IN, out_features=CLASSES)
    if name == "deepergcn":
        kw.update(num_layers=2)
    a, b = build_model(name, **kw), build_model(name, **kw)
    with torch.no_grad():
        for p in b.parameters():
            p.fill_(7.0)
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(9))
    for (pname, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), pname


def test_genconv_scalars_reset_to_their_constants():
    from cogdl_tpu_torch.layers import GENConv
    from cogdl_tpu_torch.layers.utils import reset_parameters

    conv = GENConv(4, 4, aggr="powermean", p=2.5, learn_p=True,
                   use_msg_norm=True)
    with torch.no_grad():
        conv.p.fill_(0.0)
        conv.s.fill_(0.0)
    reset_parameters(conv)
    assert float(conv.p.detach()) == 2.5 and float(conv.s.detach()) == 1.0


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
    "gcnii": dict(hidden_size=16, num_layers=4),
    "appnp": dict(hidden_size=16, propagation_steps=4),
    "deepergcn": dict(hidden_size=16, num_layers=3),
    "drgat": dict(hidden_size=4, nhead=2),
}


@pytest.mark.parametrize("model", sorted(CURVES))
def test_loss_curve_matches_the_jax_trainer(monkeypatch, model):
    """``experiment(model=...)`` against ``cogdl_tpu.experiments.train``
    from the JAX initial weights (batch statistics included), dropout 0:
    the same train loss at every epoch, which holds the wrapper's
    normalisation, the model, Adam with weight decay and, for DeeperGCN,
    the running statistics through the evaluations."""
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
            self.model, variables["params"], variables.get("batch_stats")))
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


@pytest.mark.parametrize("model", ZOO)
def test_experiment_runs_every_zoo_model_on_the_cpu(model):
    """Each registry name trains through ``experiment()`` on the CPU, its
    default wrapper and default widths, and launches no kernel there."""
    sk.reset_launch_counts()
    (res,) = experiment(dataset="sbm", model=model, epochs=3, eval_step=1,
                        device="cpu")[("sbm", model)]
    assert np.isfinite(res["train_loss"]) and 0.0 <= res["test_acc"] <= 1.0
    assert not any(fn.launches for fn in sk.COUNTED_WRAPPERS)
