"""cogdl_tpu_torch's node-classification stragglers (``graph_unet`` /
``unet``, ``gcnmix``, ``sagn``, ``m3s``, ``correct_smooth_mlp``) and
PATCHY-SAN against the JAX package on the CPU.

Each model gets the JAX model's initial weights through
``load_jax_params``; logits are held at 1e-5 and the parameter gradients
of the loss at 1e-4, with and without ``prepare_spmm``'s structure (the
CPU runs K1's plain version over it). Also: Graph U-Net's keep masks at
every level; GCNMix's ``mixup_forward``, its wrapper's loss and grads at
the ``(perm, lam)`` the JAX ``mixup_forward`` drew, and the port's own
draws; C&S's ``postprocess``; ``assemble_fields`` array for array; and
``load_jax_params`` on a conv kernel without a deprecation warning."""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cogdl_tpu.data.graph as jg
from cogdl_tpu.datasets.synthetic import random_graphs_dataset as j_graphs
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.models import SUPPORTED_MODELS as JAX_MODELS
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.models.nn.patchy_san import assemble_fields as j_fields
from cogdl_tpu.utils.evaluator import masked_cross_entropy as j_mce
from cogdl_tpu.wrappers.node_classification import (
    GCNMixWrapper as JGCNMixWrapper,
)
from cogdl_tpu_torch.datasets.synthetic import random_graphs_dataset as t_graphs
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.models import SUPPORTED_MODELS, build_model
from cogdl_tpu_torch.models import load_jax_params
from cogdl_tpu_torch.models.nn.correct_smooth import one_hot
from cogdl_tpu_torch.models.nn.patchy_san import assemble_fields
from cogdl_tpu_torch.ops.cuda import maybe_cuda_spmm, prepare_spmm
from cogdl_tpu_torch.utils.evaluator import masked_cross_entropy
from cogdl_tpu_torch.wrappers import DEFAULT_WRAPPER
from cogdl_tpu_torch.wrappers.node_classification import (
    GCNMixWrapper,
    NodeClfWrapper,
)
from cogdl_tpu_torch.wrappers.sampled_node_classification import (
    reads_kernel_structure,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# fp32 on both sides with the same weights, summed in other orders: logits
# 1e-5, grads 1e-4 (tests/test_torch_zoo_models.py)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
F_IN, CLASSES, NODES = 12, 4, 200
# registry name and small constructor arguments, dropout 0
CASES = {
    "graph_unet": ("graph_unet", dict(hidden_size=16)),
    "unet-3": ("unet", dict(hidden_size=8, pooling_rates=(0.7, 0.3, 0.5))),
    "gcnmix": ("gcnmix", dict(hidden_size=16)),
    "sagn": ("sagn", dict(hidden_size=16, num_hops=3, attn_drop=0.0)),
    "m3s": ("m3s", dict(hidden_size=16)),
    "correct_smooth_mlp": ("correct_smooth_mlp", dict(hidden_size=16)),
}
STRAGGLERS = ("graph_unet", "unet", "gcnmix", "sagn", "m3s",
              "correct_smooth_mlp", "patchy_san")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def graphs():
    """The same sbm graph in both packages, with self loops on the JAX
    side as its wrapper prepares it (the JAX models normalise in their
    forward); the port's raw, for its wrapper's ``normalise``."""
    return (jg.add_self_loops(j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5)),
            t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))


def _pair(name, seed=0, edit=None, **extra):
    """The JAX model with its initial variables (after ``edit`` of the
    parameters, if given), the port model carrying them, and a function
    that makes more port models at the same settings."""
    model, cfg = CASES[name]
    kw = dict(in_features=F_IN, out_features=CLASSES, dropout=0.0, **cfg,
              **extra)
    gj = jg.add_self_loops(j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    jm = j_build_model(model, **kw)
    variables = _host(jm.init({"params": jax.random.PRNGKey(seed),
                               "dropout": jax.random.PRNGKey(seed)},
                              gj, gj.x, training=False))
    if edit is not None:
        edit(variables["params"])
    tm = load_jax_params(build_model(model, **kw), variables["params"])
    return jm, variables, tm, lambda: build_model(model, **kw)


def _port_graph(tm, gt, structure):
    g = NodeClfWrapper(tm).normalise(gt)
    return prepare_spmm(g) if structure else g


def _assert_grads(tm, grads_j, build):
    ref = load_jax_params(build(), _host(grads_j))
    ref_params = dict(ref.named_parameters())
    assert set(ref_params) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[name].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_jax(graphs, name, structure):
    """Logits (training mode at dropout 0) and the grads of the masked
    cross-entropy, from the JAX model's weights."""
    gj, gt = graphs
    jm, variables, tm, build = _pair(name)
    mask_j = gj.train_mask & gj.node_mask()

    def loss_j(params):
        logits = jm.apply({"params": params}, gj, gj.x, training=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return j_mce(logits, gj.y, mask_j), logits

    (_, logits_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    g = _port_graph(tm, gt, structure)
    logits_t = tm(g, training=True)
    masked_cross_entropy(logits_t, g.y, g.train_mask & g.node_mask()
                         ).backward()
    _close(logits_t, logits_j)
    _assert_grads(tm, grads_j, build)


# -- Graph U-Net's pooling -------------------------------------------------------

def _jax_keep_masks(jm, variables, gj):
    """The JAX model's keep mask at each level, from its own hidden states
    (the captured outputs of ``in_gcn`` and ``down_gcn{d}``) by the JAX
    forward's lines: score, ``jax.lax.top_k``'s k-th value, ties kept."""
    _, state = jm.apply(variables, gj, gj.x, training=False,
                        capture_intermediates=True)
    inter = state["intermediates"]
    mask = gj.node_mask().astype(jnp.float32)[:, None]
    masks = []
    for d, rate in enumerate(jm.pooling_rates):
        # level d pools in_gcn's output, or down_gcn{d - 1}'s
        h = inter["in_gcn" if d == 0 else f"down_gcn{d - 1}"]["__call__"][0]
        p = variables["params"][f"pool_w{d}"]
        score = (h @ p).squeeze(-1) * jax.lax.rsqrt(jnp.sum(p ** 2) + 1e-12)
        score = jnp.where(mask.squeeze(-1) > 0, score, -1e30)
        k = max(int(rate * gj.num_nodes), 1)
        thresh = jax.lax.top_k(score, k)[0][-1]
        keep = (score >= thresh).astype(jnp.float32)[:, None] * mask
        masks.append(np.asarray(keep[:, 0]))
        mask = keep
    return masks


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("name", ["graph_unet", "unet-3"])
def test_graph_unet_keep_masks_match_jax_at_every_level(graphs, name, tie):
    """The port's keep mask at each level equals the JAX model's; with
    ``pool_w0`` zero every real node ties at score 0 and all are kept, as
    ``score >= thresh`` keeps ties in both packages. ``k`` counts the real
    nodes at every level, so a level that asks for more nodes than the mask
    holds keeps the whole mask."""
    gj, gt = graphs

    def zero_pool(params):
        params["pool_w0"] = np.zeros_like(params["pool_w0"])

    jm, variables, tm, _ = _pair(name, edit=zero_pool if tie else None)
    want = _jax_keep_masks(jm, variables, gj)
    g = _port_graph(tm, gt, structure=True)
    with torch.no_grad():
        _, levels = tm(g, return_levels=True)
    assert len(levels) == len(want)
    kept = []
    for (score, thresh, keep), w in zip(levels, want):
        np.testing.assert_array_equal(keep[:, 0].numpy(), w)
        kept.append(int(keep.sum()))
    rate = CASES[name][1].get("pooling_rates", (0.5, 0.5))
    assert kept[0] == (NODES if tie else int(rate[0] * NODES))
    assert all(a >= b for a, b in zip(kept, kept[1:]))


# -- GCNMix ------------------------------------------------------------------------

def _gcnmix_jax_draw(jm, variables, gj, key):
    """``(logits, perm, lam)`` of the JAX ``mixup_forward`` at ``key``."""
    logits, perm, lam = jm.apply(variables, gj, gj.x, True,
                                 method=jm.mixup_forward,
                                 rngs={"dropout": key})
    return np.asarray(logits), np.asarray(perm), float(lam)


@pytest.mark.parametrize("structure", [False, True])
def test_gcnmix_mixup_forward_loss_and_grads_match_jax(graphs, structure):
    """At the ``(perm, lam)`` the JAX ``mixup_forward`` drew for a key: the
    port's ``mixup_forward`` logits, and its wrapper's loss and grads
    against the JAX wrapper's for the same key."""
    gj, gt = graphs
    jm, variables, tm, build = _pair("gcnmix")
    key = jax.random.PRNGKey(7)
    logits_j, perm, lam = _gcnmix_jax_draw(jm, variables, gj, key)
    assert 0.5 <= lam <= 1.0
    g = _port_graph(tm, gt, structure)
    perm_t = torch.from_numpy(perm.copy()).long()
    with torch.no_grad():
        _close(tm.mixup_forward(g, g.x, perm_t, lam), logits_j)

    jw = JGCNMixWrapper(jm)
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jw.loss({"params": p}, gj, key), has_aux=True)(
            variables["params"])
    wrapper = GCNMixWrapper(tm, seed=0)
    tm.draw_mixup = lambda graph, rng, generator=None: (perm_t, lam)
    loss_t = wrapper.loss(g, torch.Generator().manual_seed(0))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=FWD_RTOL)
    _assert_grads(tm, grads_j, build)


def test_gcnmix_draws_are_seeded_and_leave_the_global_generators_alone(
        graphs):
    """``lam`` in [0.5, 1] from the wrapper's host generator, ``perm`` a
    permutation of the real rows with the pad rows in place; one seed
    gives the same draws, another other ones; torch's and numpy's global
    generators are not touched."""
    _, gt = graphs
    g = NodeClfWrapper(None).normalise(gt)
    n = g.num_nodes
    assert g.n_pad > n

    # (building a module draws torch's default initialisation from the
    # global generator: the models are built before its state is read)
    net = build_model("gcnmix", in_features=F_IN, out_features=CLASSES)
    wrappers = [GCNMixWrapper(net, seed=s) for s in (3, 3, 4)]
    torch_state = torch.get_rng_state()
    np_state = np.random.get_state()[1].copy()
    a, b, c = ([w.model.draw_mixup(g, w.rng,
                                   torch.Generator().manual_seed(s))
                for _ in range(4)]
               for w, s in zip(wrappers, (3, 3, 4)))
    assert torch.equal(torch.get_rng_state(), torch_state)
    assert np.array_equal(np.random.get_state()[1], np_state)
    for (perm, lam), (perm_b, lam_b) in zip(a, b):
        assert 0.5 <= lam <= 1.0 and lam == lam_b
        assert torch.equal(perm, perm_b)
        assert torch.equal(torch.sort(perm[:n]).values, torch.arange(n))
        assert torch.equal(perm[n:], torch.arange(n, g.n_pad))
    assert [lam for _, lam in a] != [lam for _, lam in c]
    assert not all(torch.equal(p, q) for (p, _), (q, _) in zip(a, c))
    assert len({lam for _, lam in a}) == len(a)


def test_gcnmix_step_launches_nothing_that_waits(graphs, monkeypatch):
    """The wrapper's loss calls no ``.item()`` and no ``float()`` of a
    tensor: the step never waits for the card."""
    _, gt = graphs
    tm = build_model("gcnmix", in_features=F_IN, out_features=CLASSES)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    g = NodeClfWrapper(tm).normalise(gt)
    waited = []
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: waited.append("item"))
    monkeypatch.setattr(torch.Tensor, "__float__",
                        lambda self: waited.append("float") or 0.0)
    GCNMixWrapper(tm, seed=0).loss(g, torch.Generator().manual_seed(0))
    assert waited == []


def test_gcnmix_sharpen_matches_jax():
    """``sharpen`` (no caller in either package) at temperature 0.1."""
    jm, _, tm, _ = _pair("gcnmix")
    probs = np.random.default_rng(1).dirichlet(np.ones(CLASSES), 6)
    probs = probs.astype(np.float32)
    _close(tm.sharpen(torch.from_numpy(probs)),
           jm.sharpen(jnp.asarray(probs)))


# -- Correct & Smooth --------------------------------------------------------------

@pytest.mark.parametrize("structure", [False, True])
def test_postprocess_matches_jax(graphs, structure):
    """``postprocess`` at the JAX defaults (50 correct and 50 smooth steps,
    alpha 0.8) over the same logits."""
    gj, gt = graphs
    jm, variables, tm, _ = _pair("correct_smooth_mlp")
    logits = np.random.default_rng(0).normal(
        size=(gj.n_pad, CLASSES)).astype(np.float32) * 3.0
    want = jm.apply(variables, gj, jnp.asarray(logits),
                    method=jm.postprocess)
    g = _port_graph(tm, gt, structure)
    got = tm.postprocess(g, torch.from_numpy(logits))
    _close(got, want)


def test_one_hot_gives_a_zero_row_for_a_label_outside_the_classes():
    labels = torch.tensor([0, 3, -1, 4, 2])
    np.testing.assert_array_equal(
        one_hot(labels, 4).numpy(),
        np.asarray(jax.nn.one_hot(jnp.asarray(labels.numpy()), 4)))


def test_sagn_and_correct_smooth_say_they_propagate_and_raise_on_the_card(
        graphs):
    """``calls_spmm`` makes the wrappers build the kernels' structure for
    SAGN and for C&S's MLP, which has no GCN layer; over a graph without
    it, K1's dispatcher raises for a CUDA tensor (a stand-in with what it
    reads of one) and takes the plain route for a CPU tensor."""
    _, gt = graphs
    for name in ("sagn", "correct_smooth_mlp", "graph_unet", "gcnmix",
                 "m3s"):
        net = build_model(name, in_features=F_IN, out_features=CLASSES)
        assert reads_kernel_structure(net), name
        # M3S is a GCN, whose adj_norm is its argument's
        assert getattr(type(net), "adj_norm", net.adj_norm) == "sym"
    assert not reads_kernel_structure(build_model(
        "patchy_san", in_features=F_IN, out_features=CLASSES))
    bare = NodeClfWrapper(build_model("sagn", in_features=F_IN,
                                      out_features=CLASSES)).normalise(gt)
    on_card = types.SimpleNamespace(is_cuda=True, ndim=2)
    with pytest.raises(RuntimeError, match="prepare_spmm"):
        maybe_cuda_spmm(bare, on_card)
    h = torch.zeros(bare.n_pad, CLASSES)
    assert maybe_cuda_spmm(bare, h) is None
    assert maybe_cuda_spmm(prepare_spmm(bare), h).shape == h.shape


# -- PATCHY-SAN ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph_sets():
    kw = dict(num_graphs=24, min_nodes=4, max_nodes=30, feat_dim=5, seed=2)
    return j_graphs(**kw), t_graphs(**kw)


@pytest.mark.parametrize("width,k", [(16, 8), (4, 3), (40, 2)])
def test_assemble_fields_equals_jax(graph_sets, width, k):
    """Array for array, empty slots pointing at node 0, also where the
    width exceeds a graph's nodes."""
    (jgr, _), (tgr, _) = graph_sets
    got = assemble_fields(tgr, width=width, k=k)
    np.testing.assert_array_equal(got, j_fields(jgr, width=width, k=k))
    assert got.shape == (len(tgr), width, k) and got.dtype == np.int64


def _patchy_inputs(graph_sets, width=6, k=4):
    (jgr, labels), (tgr, _) = graph_sets
    fields = assemble_fields(tgr, width=width, k=k)
    feats = np.stack([np.asarray(g.x)[f] for g, f in zip(jgr, fields)])
    return feats.astype(np.float32), labels


def test_patchy_san_matches_jax_and_loads_without_warnings(graph_sets):
    """Logits and the mean-NLL grads from the JAX weights (conv kernels
    ``[k, in, out]`` permuted to ``[out, in, k]``), loaded with every
    warning an error; ``fc``'s rows in the JAX order (the conv output
    transposed back before the flatten)."""
    feats, labels = _patchy_inputs(graph_sets)
    kw = dict(in_features=5, out_features=2, hidden_size=7, width=6, k=4,
              dropout=0.0)
    jm = j_build_model("patchy_san", **kw)
    variables = _host(jm.init(jax.random.PRNGKey(1), jnp.asarray(feats),
                              training=False))
    assert variables["params"]["conv1"]["kernel"].shape == (4, 5, 7)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tm = load_jax_params(build_model("patchy_san", **kw),
                             variables["params"])
    assert tm.conv1.weight.shape == (7, 5, 4)
    y = jnp.asarray(labels)

    def loss_j(params):
        logits = jm.apply({"params": params}, jnp.asarray(feats),
                          training=True)
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1)), logits

    (loss_v, logits_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        logits_t = tm(torch.from_numpy(feats), training=True)
    logp = torch.log_softmax(logits_t, -1)
    loss_t = -logp.gather(1, torch.from_numpy(labels).long()[:, None]).mean()
    loss_t.backward()
    _close(logits_t, logits_j)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_v),
                               rtol=FWD_RTOL)
    ref = load_jax_params(build_model("patchy_san", **kw), _host(grads_j))
    ref_params = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[name].detach().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_load_jax_params_keeps_the_transpose_for_dense_kernels(graph_sets):
    """2-D kernels still become their transposes; a leaf with no place in
    the model still raises."""
    feats, _ = _patchy_inputs(graph_sets)
    kw = dict(in_features=5, out_features=2, hidden_size=7, width=6, k=4)
    params = _host(j_build_model("patchy_san", **kw).init(
        jax.random.PRNGKey(2), jnp.asarray(feats), training=False))["params"]
    tm = load_jax_params(build_model("patchy_san", **kw), params)
    np.testing.assert_array_equal(tm.fc.weight.detach().numpy(),
                                  params["fc"]["kernel"].T)
    np.testing.assert_array_equal(tm.conv2.weight.detach().numpy(),
                                  params["conv2"]["kernel"].transpose(2, 1, 0))
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(build_model("patchy_san", **kw),
                        dict(params, extra={"bias": np.zeros(2)}))


# -- initialisation and the registry -------------------------------------------------

@pytest.mark.parametrize("name", STRAGGLERS)
def test_reset_parameters_is_seeded_and_resets_everything(name):
    """Every parameter drawn again from the generator: one seed gives the
    same weights, another other ones, and nothing keeps torch's own
    initialisation."""
    def weights(seed, net=None):
        net = net or build_model(name, in_features=F_IN, out_features=CLASSES)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return {k: v.detach().clone() for k, v in net.state_dict().items()}

    net = build_model(name, in_features=F_IN, out_features=CLASSES)
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(7.0)
    a, b, c = weights(0), weights(0, net), weights(1)
    for key in a:
        assert torch.equal(a[key], b[key]), key
        assert not (b[key] == 7.0).any(), key
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_registry_and_default_wrappers_name_the_stragglers():
    for name in STRAGGLERS:
        assert SUPPORTED_MODELS[name].rsplit(".", 1)[1] == \
            JAX_MODELS[name].rsplit(".", 1)[1]
    assert {n: DEFAULT_WRAPPER[n] for n in STRAGGLERS} == {
        "graph_unet": "node_classification", "unet": "node_classification",
        "gcnmix": "gcnmix", "sagn": "sagn_staged", "m3s": "m3s_staged",
        "correct_smooth_mlp": "correct_smooth", "patchy_san": "patchy_san"}
