"""cogdl_tpu_torch's self-supervised models (DGI, MVGRL, GRACE, GraphMAE,
GraphMAE2, BGRL, InfoGraph) against the JAX package on the CPU.

Each port model carries the JAX wrapper's initial variables
(``load_jax_params``, the EMA teachers included) and gets the JAX
wrapper's random draws for the same key (the DGI permutation, GRACE's and
BGRL's keep masks, GraphMAE's and GraphMAE2's node masks). Every method the
wrapper calls is held at 1e-5 and the grads of the wrapper's loss at
1e-4, over the plain graph and over ``prepare_spmm``'s structure (the CPU
runs K1's plain version over it); one step's teacher update and batch
statistics at 1e-5."""

import jax
import numpy as np
import pytest
import torch

from cogdl_tpu.data.batch import union_batch as j_union_batch
from cogdl_tpu.datasets import build_dataset as j_build_dataset
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.wrappers import fetch_wrapper as j_fetch_wrapper
from cogdl_tpu_torch.data.batch import union_batch
from cogdl_tpu_torch.data.graph import sym_norm
from cogdl_tpu_torch.datasets import build_dataset
from cogdl_tpu_torch.datasets.synthetic import sbm_graph as t_sbm
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.ops.cuda import prepare_spmm
from cogdl_tpu_torch.wrappers import fetch_wrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
F_IN, CLASSES, NODES = 12, 4, 120
# registry name → (its default wrapper, small constructor arguments)
CASES = {
    "dgi": ("dgi", dict(hidden_size=16)),
    "mvgrl": ("dgi", dict(hidden_size=16)),
    "grace": ("grace", dict(hidden_size=16, proj_size=8)),
    "graphmae": ("graphmae", dict(hidden_size=16)),
    "graphmae2": ("graphmae2", dict(hidden_size=16)),
    "bgrl": ("bgrl", dict(hidden_size=16)),
}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(name, wj, gj, rng):
    """The draws the JAX wrapper ``wj`` makes inside its loss at ``rng``,
    in the port's ``draws`` layout (numpy)."""
    jm = wj.model
    if name in ("dgi", "mvgrl"):
        r1, _ = jax.random.split(rng)
        return np.concatenate([np.asarray(jax.random.permutation(
            r1, gj.num_nodes)), np.arange(gj.num_nodes, gj.x.shape[0])])
    if name == "grace":
        out = []
        for i, r in enumerate(jax.random.split(rng, 3)[:2]):
            ra, rb = jax.random.split(r)
            out.append((np.asarray(jax.random.bernoulli(
                ra, 1.0 - jm.drop_edge_rates[i], gj.edge_weight.shape)),
                np.asarray(jax.random.bernoulli(
                    rb, 1.0 - jm.drop_feature_rates[i],
                    (1, gj.x.shape[1])))))
        return tuple(out)
    if name == "graphmae":
        r1, _ = jax.random.split(rng)
        return np.asarray(jax.random.bernoulli(
            r1, jm.mask_rate, (gj.x.shape[0], 1))
            & gj.node_mask()[:, None])
    if name == "graphmae2":
        r1, r2, _ = jax.random.split(rng, 3)
        mask = np.asarray(jax.random.bernoulli(
            r1, jm.mask_rate, (gj.x.shape[0], 1)) & gj.node_mask()[:, None])
        return mask, [np.asarray(jax.random.bernoulli(
            jax.random.fold_in(r2, i), jm.remask_rate, (gj.x.shape[0], 1)))
            for i in range(jm.num_remasking)]
    if name == "bgrl":
        rv, _ = jax.random.split(rng)
        rs = jax.random.split(rv, 4)
        return tuple((np.asarray(jax.random.bernoulli(
            rs[2 * i], 1.0 - wj.drop_edge_rates[i], gj.edge_weight.shape)),
            np.asarray(jax.random.bernoulli(
                rs[2 * i + 1], 1.0 - wj.drop_feature_rates[i],
                (1, gj.x.shape[1]))))
            for i in range(2))
    raise KeyError(name)


def to_torch(draws):
    """Numpy draws (nested tuples and lists) as torch tensors."""
    if isinstance(draws, (tuple, list)):
        return type(draws)(to_torch(d) for d in draws)
    return _t(draws)


def load_variables(model, variables):
    return load_jax_params(model, _host(variables["params"]),
                           _host(variables.get("batch_stats")),
                           teacher=_host(variables.get("teacher")),
                           ema=_host(variables.get("ema")))


def make_pair(name, seed=0, **extra):
    """The JAX wrapper with its prepared graph and initial variables, the
    port wrapper with the port model carrying them, and a function that
    makes more port models at the same settings."""
    wname, cfg = CASES[name]
    kw = dict(in_features=F_IN, out_features=CLASSES, **cfg, **extra)
    jm = j_build_model(name, **kw)
    wj = j_fetch_wrapper(wname)(jm)
    gj = wj.prepare_graph(j_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    variables = wj.init(jax.random.PRNGKey(seed), gj)
    tm = load_variables(build_model(name, **kw), variables)
    wt = fetch_wrapper(wname)(tm)
    return wj, gj, variables, wt, lambda: build_model(name, **kw)


def port_graph(wt, structure):
    g = wt.prepare_graph(t_sbm(num_nodes=NODES, feat_dim=F_IN, seed=5))
    return prepare_spmm(g) if structure else g


def close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def assert_grads(tm, grads_j, build):
    ref = load_jax_params(build(), _host(grads_j))
    ref_params = dict(ref.named_parameters())
    assert set(ref_params) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        close(p.grad, ref_params[name].detach(), GRAD_RTOL, GRAD_ATOL, name)


def test_prepared_graphs_match_edge_for_edge():
    """The keep masks index edges: the port's prepared graph (self loops,
    raw weights for GRACE and BGRL) lays them out as the JAX wrapper's."""
    for name in ("grace", "bgrl"):
        wj, gj, _, wt, _ = make_pair(name)
        g = port_graph(wt, False)
        assert g.e_pad == gj.e_pad and g.n_pad == gj.x.shape[0]
        np.testing.assert_array_equal(g.row.numpy(), np.asarray(gj.row))
        np.testing.assert_array_equal(g.col.numpy(), np.asarray(gj.col))
        close(g.edge_weight, gj.edge_weight, 0, 0)


def _methods_jax(name, wj, gj, v, key):
    """Each method the wrapper calls, in the JAX package, with the wrapper's
    own split of ``key`` (so at the draws of :func:`jax_draws`)."""
    jm = wj.model
    x = gj.x
    # GRACE's embedding is its encoder's (below)
    out = {} if name == "grace" else {
        "embed": jm.apply(v, gj, x, method=jm.embed)}
    if name in ("dgi", "mvgrl"):
        perm = jax_draws(name, wj, gj, key)
        pos, neg = jm.apply(v, gj, x, x[perm], False,
                            method=jm.infomax_logits)
        out.update(pos=pos, neg=neg)
    elif name == "grace":
        jv = {"params": v["params"]}
        for i, r in enumerate(jax.random.split(key, 3)[:2]):
            z = jm.apply(jv, gj, x, r, i, False, method=jm.view)
            out[f"z{i}"] = z
            out[f"h{i}"] = jm.apply(jv, z, method=jm.project)
        out["nt_xent"] = jm.apply(jv, out["h0"], out["h1"], gj.node_mask(),
                                  method=jm.nt_xent)
        out["embed"] = jm.apply(jv, gj, x, False, method=jm.encode)
    elif name == "graphmae":
        r1, _ = jax.random.split(key)
        out["rec"] = jm.apply(v, gj, x, r1, False,
                              method=jm.reconstruction_loss)
    elif name == "graphmae2":
        r1, r2, _ = jax.random.split(key, 3)
        sv = {"params": v["params"]}
        xm, mask = jm.apply(sv, x, gj.node_mask(), r1, method=jm.mask_inputs)
        out["x_masked"] = xm
        h = jm.apply(sv, gj, xm, False, method=jm.encode)
        out["enc"] = h
        out["student_latent"] = jm.apply(sv, h, method=jm.student_latent)
        tv = {"params": {**v["teacher"],
                         "mask_token": v["params"]["mask_token"],
                         "dec_mask_token": v["params"]["dec_mask_token"]}}
        out["teacher_latent"] = jm.apply(tv, gj, x, method=jm.teacher_latent)
        out["remask_decode"] = jm.apply(sv, gj, h, mask, r2, False,
                                        method=jm.remask_decode)
    elif name == "bgrl":
        rv, _ = jax.random.split(key)
        sv = {"params": v["params"], "batch_stats": v["batch_stats"]}
        tv = {"params": {"enc": v["teacher"]["params"]},
              "batch_stats": {"enc": v["teacher"]["batch_stats"]}}
        for i, (g, xv) in enumerate(wj._views(gj, rv)):
            out[f"student{i}"], _ = jm.apply(sv, g, xv, True,
                                             method=jm.student,
                                             mutable=["batch_stats"])
            out[f"teacher{i}"] = jm.apply(tv, g, xv, False, method=jm.embed)
    return out


def _methods_port(name, wt, g, d):
    m = wt.model
    x = g.x
    with torch.no_grad():
        out = {} if name == "grace" else {"embed": m.embed(g)}
        if name in ("dgi", "mvgrl"):
            out["pos"], out["neg"] = m.infomax_logits(g, x, x[d], False)
        elif name == "grace":
            for i, (e, f) in enumerate(d):
                out[f"z{i}"] = m.view(g, x, e, f, False)
                out[f"h{i}"] = m.project(out[f"z{i}"])
            out["nt_xent"] = m.nt_xent(out["h0"], out["h1"], g.node_mask())
            out["embed"] = m.encode(g, x, False)
        elif name == "graphmae":
            out["rec"] = m.reconstruction_loss(g, x, d, False)
        elif name == "graphmae2":
            mask, rms = d
            out["x_masked"] = m.mask_inputs(x, mask)
            out["enc"] = m.encode(g, out["x_masked"], False)
            out["student_latent"] = m.student_latent(out["enc"])
            out["teacher_latent"] = m.teacher_latent(g, x)
            out["remask_decode"] = m.remask_decode(g, out["enc"], mask, rms,
                                                   False)
    if name == "bgrl":
        for i, (gv, xv) in enumerate(wt.views(g, d)):
            with torch.no_grad():
                out[f"student{i}"] = m.student(gv, xv, True)
                out[f"teacher{i}"] = m.teacher_embed(gv, xv)
    return out


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_methods_match_jax(name, structure):
    """Every method the wrapper calls, at the JAX wrapper's draws for one
    key, from the same variables (BGRL's students each from the initial
    statistics)."""
    wj, gj, variables, wt, _ = make_pair(name)
    key = jax.random.PRNGKey(3)
    d = jax_draws(name, wj, gj, key)
    want = _methods_jax(name, wj, gj, variables, key)
    g = port_graph(wt, structure)
    if name == "bgrl":
        got = {}
        for i in range(2):
            # each view's student from the initial statistics, as above
            load_variables(wt.model, variables)
            got.update({k: v for k, v in _methods_port(
                name, wt, g, to_torch(d)).items() if k.endswith(str(i))
                or k == "embed"})
    else:
        got = _methods_port(name, wt, g, to_torch(d))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], msg=k)


@pytest.mark.parametrize("structure", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_loss_grads_and_state_match_jax(name, structure):
    """The JAX wrapper's loss at a key against the port's ``loss_at`` at
    the same draws: the loss at 1e-5, every parameter's grad at 1e-4; the
    EMA teacher (BGRL: with its statistics and step; the student's
    statistics after both views) at 1e-5 after the step's update."""
    wj, gj, variables, wt, build = make_pair(name)
    key = jax.random.PRNGKey(11)
    state = {k: v for k, v in variables.items() if k != "params"}

    def loss_j(p):
        return wj.loss({"params": p, **state}, gj, key)

    (loss_jv, upd), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    g = port_graph(wt, structure)
    loss_t = wt.loss_at(g, to_torch(jax_draws(name, wj, gj, key)))
    loss_t.backward()
    close(loss_t, loss_jv)
    assert_grads(wt.model, grads_j, build)
    if "teacher" in upd:
        ref = build()
        load_variables(ref, {"params": variables["params"],
                             "batch_stats": upd.get("batch_stats"),
                             "teacher": upd["teacher"],
                             "ema": upd.get("ema")})
        want = dict(ref.named_buffers())
        got = dict(wt.model.named_buffers())
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k].detach(), msg=k)
    if name == "bgrl":
        assert float(wt.model.ema_step) == 1.0


def test_flax_prelu_starts_at_001_and_learns():
    from cogdl_tpu_torch.layers.utils import PReLU

    act = PReLU()
    assert float(act.negative_slope.detach()) == pytest.approx(0.01)
    x = torch.tensor([-2.0, 0.0, 3.0])
    y = act(x)
    assert y.tolist() == pytest.approx([-0.02, 0.0, 3.0])
    y.sum().backward()
    assert float(act.negative_slope.grad) == pytest.approx(-2.0)
    m = build_model("bgrl", in_features=4, hidden_size=8)
    names = {n for n, _ in m.named_parameters()}
    assert {"enc.PReLU_0.negative_slope", "enc.PReLU_1.negative_slope",
            "pred.layers_1.negative_slope"} <= names


@pytest.mark.parametrize("name", ["bgrl", "graphmae2"])
def test_teacher_is_state_not_parameter(name):
    """The teacher sits in the ``state_dict`` (snapshots carry it), not in
    ``parameters()`` (no optimizer sees it); ``reset_parameters`` sets it
    to the student, and a load without a teacher tree leaves it alone."""
    m = build_model(name, in_features=6, hidden_size=8)
    params = {n for n, _ in m.named_parameters()}
    assert not any(n.startswith("teacher.") for n in params)
    teacher = [k for k in m.state_dict() if k.startswith("teacher.")]
    assert teacher and all(k not in params for k in teacher)
    m.reset_parameters(torch.Generator().manual_seed(0))
    sd = m.state_dict()
    for k in teacher:
        student = k.split(".", 1)[1]
        if name == "bgrl":      # the teacher is the encoder's twin
            student = "enc." + student
        assert torch.equal(sd[k], sd[student]), k


def test_mvgrl_diffusion_view_is_the_adjacency_without_one():
    wj, gj, variables, wt, _ = make_pair("mvgrl")
    g = port_graph(wt, False)
    a, d = wt.model.views(g)
    assert a is d and a.meta_get("norm") == "sym"
    diff = sym_norm(g).replace(edge_weight=sym_norm(g).edge_weight * 0.5)
    a2, d2 = wt.model.views(g.replace(extras={"diffusion_graph": diff}))
    assert d2 is diff and a2 is not diff


# -- InfoGraph ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def infograph_batches():
    jd = j_build_dataset("random-graphs", num_graphs=12)
    td = build_dataset("random-graphs", num_graphs=12)
    return (j_union_batch(jd.graphs[:6], jd.labels[:6]),
            union_batch(td.graphs[:6], td.labels[:6]), jd.num_features)


@pytest.mark.parametrize("structure", [False, True])
def test_infograph_matches_jax(infograph_batches, structure):
    """``mi_scores``, the graph embeddings, and the wrapper's Jensen-Shannon
    loss with its grads and the batch statistics, over one union batch in
    training mode."""
    from cogdl_tpu.wrappers.graph_classification import (
        InfoGraphWrapper as JInfoGraphWrapper,
    )
    from cogdl_tpu_torch.wrappers.graph_classification import (
        InfoGraphWrapper,
    )

    bj, bt, f_in = infograph_batches
    kw = dict(in_features=f_in, out_features=2, hidden_size=8, num_layers=3)
    jm = j_build_model("infograph", **kw)
    v = _host(jm.init({"params": jax.random.PRNGKey(0),
                       "dropout": jax.random.PRNGKey(0)}, bj, bj.x, False,
                      method=jm.mi_scores))
    tm = load_jax_params(build_model("infograph", **kw), v["params"],
                         v["batch_stats"])
    b = prepare_spmm(bt) if structure else bt
    with torch.no_grad():
        close(tm.mi_scores(b, b.x, False),
              jm.apply(v, bj, bj.x, False, method=jm.mi_scores))
        close(tm(b, training=False), jm.apply(v, bj, bj.x, training=False))
    wj = object.__new__(JInfoGraphWrapper)
    wj.model = jm
    wt = object.__new__(InfoGraphWrapper)
    wt.model = tm

    def loss_j(p):
        return wj.loss({"params": p, "batch_stats": v["batch_stats"]}, bj,
                       jax.random.PRNGKey(0))

    (lj, upd), gj_ = jax.value_and_grad(loss_j, has_aux=True)(v["params"])
    lt = wt.loss(b)
    lt.backward()
    close(lt, lj)
    assert_grads(tm, gj_, lambda: build_model("infograph", **kw))
    for i in range(3):
        for k in ("mean", "var"):
            close(getattr(getattr(tm, f"gin{i}").bn, k),
                  upd["batch_stats"][f"gin{i}"]["bn"][k], msg=f"gin{i}.{k}")
