"""cogdl_tpu_torch's knowledge-graph link prediction against the JAX package
on the CPU: ``random_triples`` array for array; the TransE-family scores,
the initial tables of a seed (bit for bit), two epochs of
``train_triples`` (the same numpy draws, tables within 1e-4), the
wrapper's whole run, and the filtered, mean-rank-tied ranks
(the JAX package's Python loop against the port's one search over sorted
keys); the DistMult and ConvE scorers and ``KGLinkPredictor`` over RGCN and
CompGCN encoders with the JAX weights (1e-5, grads 1e-4); the
``kg_link_prediction`` wrapper's graph, loss at the JAX draws and raw and
filtered MRR / hits; and every name through ``experiment(device="cpu")``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogdl_tpu.datasets import build_dataset as j_build_dataset
from cogdl_tpu.datasets.synthetic import random_triples as j_random_triples
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu.models.nn import kg_gnn as j_kg
from cogdl_tpu.wrappers.kg_link_prediction import (
    KGLinkPredictionWrapper as JKGWrapper,
)
from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.datasets import build_dataset
from cogdl_tpu_torch.datasets.dataset import Dataset
from cogdl_tpu_torch.datasets.synthetic import random_triples
from cogdl_tpu_torch.models import build_model, load_jax_params
from cogdl_tpu_torch.models.nn import kg_gnn as t_kg
from cogdl_tpu_torch.wrappers.kg_link_prediction import (
    KGLinkPredictionWrapper,
)
from cogdl_tpu_torch.wrappers.triple_link_prediction import (
    TripleLinkPredictionWrapper,
)
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
TABLE_TOL = 1e-4
KGE = ("transe", "distmult", "rotate", "complex")
SMALL = dict(num_entities=30, num_relations=3, num_triples=300, seed=2)
KGE_KW = dict(hidden_size=16, negative_size=8, batch_size=64, epochs=2,
              lr=0.01, seed=1)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# -- the triples ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, SMALL, dict(num_entities=500,
                                                num_relations=20,
                                                num_triples=4000,
                                                structured=0.5, seed=7)])
def test_random_triples_equal_jax(kw):
    got, want = random_triples(**kw), j_random_triples(**kw)
    assert set(got) == set(want)
    for k in ("train", "valid", "test"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert got["num_entities"] == want["num_entities"]
    assert got["num_relations"] == want["num_relations"]


def test_random_kg_dataset_has_no_graph():
    ds, dj = build_dataset("random-kg"), j_build_dataset("random-kg")
    assert ds.metric == dj.metric == "mrr"
    assert ds.num_features == dj.num_features == 0
    assert ds.num_classes is None and dj.num_classes is None
    np.testing.assert_array_equal(ds.triples["test"], dj.triples["test"])
    assert "KG triples" in repr(ds)


# -- the triple embeddings --------------------------------------------------------

def _kge_pair(name, **kw):
    t = random_triples(**SMALL)
    cfg = dict(num_entities=t["num_entities"],
               num_relations=t["num_relations"], **KGE_KW)
    cfg.update(kw)
    return t, j_build_model(name, **cfg), build_model(name, **cfg)


@pytest.mark.parametrize("name", KGE)
def test_kge_scores_match_jax(name):
    _, jm, tm = _kge_pair(name)
    rng = np.random.default_rng(0)
    h, t = (rng.normal(size=(5, 7, jm.entity_dim())).astype(np.float32)
            for _ in range(2))
    r = rng.normal(size=(5, 1, jm.relation_dim())).astype(np.float32)
    close(tm.score(_t(h), _t(r), _t(t)),
          jm.score(jnp.asarray(h), jnp.asarray(r), jnp.asarray(t)))


@pytest.mark.parametrize("seed", [0, 1, 5, 2 ** 31 - 1])
def test_threefry_draws_equal_jax(seed):
    """The numpy Threefry-2x32 against ``jax.random``: the key of a seed,
    ``split`` and float32 ``uniform``, bit for bit."""
    from cogdl_tpu_torch.utils import threefry

    key = jax.random.PRNGKey(seed)
    assert np.array_equal(jax.random.key_data(key),
                          np.array(threefry.prng_key(seed)))
    want = jax.random.split(key, 3)
    got = threefry.split(threefry.prng_key(seed), 3)
    assert np.array_equal(jax.random.key_data(want), np.array(got))
    for shape, lo, hi in (((30, 16), -0.75, 0.75), ((7,), 0.0, 1.0),
                          ((3, 4, 5), -12.0 / 500, 12.0 / 500)):
        w = np.asarray(jax.random.uniform(want[1], shape, minval=lo,
                                          maxval=hi))
        g = threefry.uniform(got[1], shape, lo, hi)
        assert g.dtype == np.float32 and np.array_equal(g, w)


@pytest.mark.parametrize("name", KGE)
def test_kge_initial_tables_equal_jax(name):
    """A seed's initial tables are the JAX package's, bit for bit."""
    _, jm, tm = _kge_pair(name)
    want = _host(jm.init_params(jax.random.PRNGKey(jm.seed)))
    got = tm.init_params()
    for k in ("ent", "rel"):
        assert np.array_equal(got[k].numpy(), want[k]), k


@pytest.mark.parametrize("init", ["injected", "own"])
@pytest.mark.parametrize("name", KGE)
def test_train_triples_matches_jax(name, init):
    """Two epochs from the JAX initial tables, handed over or drawn by the
    port: the same batches and negatives (numpy, the JAX order), torch
    Adam against optax's, TransE's projection; the tables within 1e-4."""
    triples, jm, tm = _kge_pair(name)
    init = (_host(jm.init_params(jax.random.PRNGKey(jm.seed)))
            if init == "injected" else None)
    want = jm.train_triples(triples)
    got = tm.train_triples(triples, device="cpu", init=init)
    init = _host(jm.init_params(jax.random.PRNGKey(jm.seed)))
    for k in ("ent", "rel"):
        moved = np.abs(want[k] - init[k]).max()
        assert moved > 100 * TABLE_TOL, (k, moved)
        close(got[k], want[k], TABLE_TOL, TABLE_TOL, k)
    if name == "transe":
        assert float(got["ent"].norm(dim=1).max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("collapsed", [False, True])
@pytest.mark.parametrize("name", KGE)
def test_filtered_ranks_equal_the_jax_loop(name, collapsed):
    """The port's filtered evaluation against the JAX package's loop over
    contenders, on the same tables: trained ones, and a collapsed model
    (all-zero tables, every score level) where the mean-rank tie-breaking
    decides every rank."""
    triples, jm, tm = _kge_pair(name)
    params = _host(jm.init_params(jax.random.PRNGKey(3)))
    if collapsed:
        params = {k: np.zeros_like(v) for k, v in params.items()}
    jm.params = params
    tm.params = {k: _t(v) for k, v in params.items()}
    for split in ("valid", "test"):
        want, got = jm.evaluate(triples, split), tm.evaluate(triples, split)
        assert set(got) == set(want)
        assert got == want
    if collapsed:
        assert tm.evaluate(triples, "test")["mrr"] < 0.5


def test_filtered_ranks_skip_known_triples_in_small_batches(monkeypatch):
    """Row batches of one (the evaluation cuts its rows by the score
    tensor's size) give the numbers of one batch: the ranks come in the
    JAX loop's order, each triple's tail rank then its head rank."""
    from cogdl_tpu_torch.models.emb import knowledge_base

    triples, jm, tm = _kge_pair("distmult")
    tm.params = {k: _t(v) for k, v in _host(
        jm.init_params(jax.random.PRNGKey(4))).items()}
    whole = tm.evaluate(triples, "test")
    monkeypatch.setattr(knowledge_base, "EVAL_ELEMENTS", 1)
    assert tm.evaluate(triples, "test") == whole


# -- the GNN scorers and KGLinkPredictor -----------------------------------------

def test_distmult_scorer_matches_jax():
    rng = np.random.default_rng(1)
    s, r, o = (rng.normal(size=(6, 10)).astype(np.float32) for _ in range(3))
    allo = rng.normal(size=(9, 10)).astype(np.float32)
    dm = j_kg.DistMult()
    close(t_kg.DistMult()(_t(s), _t(r), _t(o)),
          dm.apply({}, jnp.asarray(s), jnp.asarray(r), jnp.asarray(o)))
    close(t_kg.DistMult()(_t(s), _t(r), _t(allo), all_entities=True),
          dm.apply({}, jnp.asarray(s), jnp.asarray(r), jnp.asarray(allo),
                   all_entities=True))


@pytest.mark.parametrize("dim,k_w", [(20, 10), (30, 5)])
@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_conve_matches_jax(norm, dim, k_w):
    """The channels-last grid, the convolution (kernel mapped [kh, kw, in,
    out] → [out, in, kh, kw]), the three norms (batch statistics made
    non-trivial), against every entity and per triple; the grads."""
    rng = np.random.default_rng(2)
    sub, rel, obj = (rng.normal(size=(5, dim)).astype(np.float32)
                     for _ in range(3))
    allo = rng.normal(size=(11, dim)).astype(np.float32)
    jc = j_kg.ConvE(dim, num_filter=6, kernel_size=3, k_w=k_w, norm=norm)
    v = jc.init(jax.random.PRNGKey(0), jnp.asarray(sub), jnp.asarray(rel),
                jnp.asarray(obj))
    v = _host(v)
    v["params"] = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1,
        v["params"])
    if norm == "batch":
        v["batch_stats"] = jax.tree.map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            v["batch_stats"])
    tc = t_kg.ConvE(dim, num_filter=6, kernel_size=3, k_w=k_w, norm=norm)
    load_jax_params(tc, v["params"], v.get("batch_stats"))
    args = (jnp.asarray(sub), jnp.asarray(rel))
    close(tc(_t(sub), _t(rel), _t(obj)), jc.apply(v, *args,
                                                   jnp.asarray(obj)))
    close(tc(_t(sub), _t(rel), _t(allo), all_entities=True),
          jc.apply(v, *args, jnp.asarray(allo), all_entities=True))
    grads = jax.jit(jax.grad(lambda p: jc.apply(
        {**v, "params": p}, *args, jnp.asarray(obj)).sum()))(v["params"])
    tc(_t(sub), _t(rel), _t(obj)).sum().backward()
    ref = load_jax_params(t_kg.ConvE(dim, num_filter=6, kernel_size=3,
                                     k_w=k_w, norm=norm), _host(grads))
    want = dict(ref.named_parameters())
    for name, p in tc.named_parameters():
        close(p.grad, want[name].detach(), GRAD_RTOL, GRAD_ATOL, name)


def _kg_pair(model, score_func="distmult", protocol="raw", hidden=16,
             **kw):
    """The JAX and port KG wrappers over the small triples, with the port's
    predictor carrying the JAX initial variables."""
    t = random_triples(**SMALL)
    cfg = dict(in_features=0, out_features=hidden, hidden_size=hidden,
               dropout=0.0, **kw)
    wj = JKGWrapper(j_build_model(model, **cfg),
                    j_build_dataset("random-kg", **SMALL),
                    score_func=score_func, batch_size=64, neg_ratio=2,
                    protocol=protocol)
    gj = wj.prepare_graph()
    v = _host(wj.init(jax.random.PRNGKey(0), gj))
    wt = KGLinkPredictionWrapper(build_model(model, **cfg),
                                 Dataset.from_triples(t), score_func=score_func,
                                 batch_size=64, neg_ratio=2,
                                 protocol=protocol)
    gt = wt.prepare_graph()
    load_jax_params(wt.model, v["params"], v.get("batch_stats"))
    return wj, gj, v, wt, gt


@pytest.mark.parametrize("model", ["rgcn", "compgcn"])
def test_kg_graph_and_encoder_equal_jax(model):
    """The typed graph (forward, inverse, self loops) edge for edge; the
    encoder rebuilt with 2R + 1 relations at the hidden width (CompGCN
    returning its relations, no entity table of its own)."""
    wj, gj, _, wt, gt = _kg_pair(model)
    assert gt.e_pad == gj.e_pad and gt.n_pad == gj.n_pad
    for k in ("row", "col", "edge_type"):
        np.testing.assert_array_equal(getattr(gt, k).numpy(),
                                      np.asarray(getattr(gj, k)), k)
    assert gt.meta_get("num_relations") == 2 * SMALL["num_relations"] + 1
    enc = wt.model.encoder
    assert enc.build_kwargs["num_relations"] == 7
    assert enc.build_kwargs["in_features"] == 16
    if model == "compgcn":
        assert enc.return_rel and not enc.num_entities


@pytest.mark.parametrize("score_func", ["distmult", "conve"])
@pytest.mark.parametrize("model", ["rgcn", "compgcn"])
def test_kg_predictor_matches_jax(model, score_func):
    """``loss_logits`` (logits and penalty) and ``rank_scores`` at 1e-5,
    the wrapper's loss at the JAX draws and its grads at 1e-4 (training
    off for ConvE, whose dropout draws differ)."""
    hidden = 20 if score_func == "conve" else 16
    wj, gj, v, wt, gt = _kg_pair(model, score_func, hidden=hidden)
    jm, tm = wj.model, wt.model
    rng = np.random.default_rng(3)
    h, r, t = (rng.integers(0, n, 40) for n in (30, 7, 30))
    lj, regj = jm.apply(v, gj, jnp.asarray(h), jnp.asarray(r), jnp.asarray(t),
                        method="loss_logits")
    with torch.no_grad():
        lt, regt = tm.loss_logits(gt, _t(h), _t(r), _t(t))
        close(lt, lj)
        close(regt, regj)
        close(tm.rank_scores(gt, _t(h), _t(r)),
              jm.apply(v, gj, jnp.asarray(h), jnp.asarray(r),
                       method="rank_scores"))
    training = score_func != "conve"
    key = jax.random.PRNGKey(9)
    r1, r2, r3, _ = jax.random.split(key, 4)
    B, K = wj.batch_size, wj.neg_ratio
    draws = (np.asarray(jax.random.randint(r1, (B,), 0,
                                           wj._train_triples.shape[0])),
             np.asarray(jax.random.randint(r2, (B * K,), 0, 30)),
             np.asarray(jax.random.bernoulli(r3, 0.5, (B * K,))))
    loss_j, grads = jax.jit(jax.value_and_grad(lambda p: wj.loss(
        {**v, "params": p}, gj, key, training=training)[0]))(v["params"])
    loss_t = wt.loss_at(gt, tuple(_t(d) for d in draws), training)
    close(loss_t, loss_j)
    loss_t.backward()
    ref = load_jax_params(
        KGLinkPredictionWrapper(
            build_model(model, in_features=0, out_features=hidden,
                        hidden_size=hidden, dropout=0.0),
            Dataset.from_triples(random_triples(**SMALL)),
            score_func=score_func).model, _host(grads))
    want = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        close(g, want[name].detach(), GRAD_RTOL, GRAD_ATOL, name)


@pytest.mark.parametrize("protocol", ["raw", "filtered"])
@pytest.mark.parametrize("model", ["rgcn", "compgcn"])
def test_kg_ranks_equal_jax(model, protocol):
    """The wrapper's MRR and hits@{1, 3, 10} on val and test at the JAX
    weights: every rank as the JAX wrapper's (raw, and filtered by the
    known triples of every split), so the numbers agree to 1e-12."""
    wj, gj, v, wt, gt = _kg_pair(model, protocol=protocol)
    want, got = wj.evaluate(v, gj), wt.evaluate(gt)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_filtered_mrr_is_at_least_the_raw():
    _, _, _, wt, gt = _kg_pair("rgcn", protocol="filtered")
    filt = wt.evaluate(gt)
    wt.protocol = "raw"
    raw = wt.evaluate(gt)
    assert filt["test_mrr"] >= raw["test_mrr"] - 1e-12
    assert filt["test_hits10"] >= raw["test_hits10"] - 1e-12


def test_kg_wrapper_needs_triples_and_a_registry_model():
    m = build_model("rgcn", in_features=4, out_features=4)
    with pytest.raises(ValueError, match="triples"):
        KGLinkPredictionWrapper(m, build_dataset("sbm"))
    from cogdl_tpu_torch.models.nn.rgcn import RGCN

    with pytest.raises(ValueError, match="registry"):
        KGLinkPredictionWrapper(RGCN(4, 4), build_dataset("random-kg"))


# -- experiment() --------------------------------------------------------------

@pytest.mark.parametrize("model", ["rgcn", "compgcn"])
def test_kg_gnns_run_through_experiment(model):
    """On ``kg_link_prediction`` with the graph built by the wrapper (the
    trainer hands it the device), and raising without ``device="cpu"``
    where torch sees no card."""
    (res,) = experiment(dataset="random-kg", model=model,
                        wrapper="kg_link_prediction", epochs=2, eval_step=1,
                        hidden_size=16, batch_size=128,
                        device="cpu")[("random-kg", model)]
    assert np.isfinite(res["train_loss"]) and 0.0 < res["test_mrr"] <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            experiment(dataset="random-kg", model=model,
                       wrapper="kg_link_prediction", epochs=1)


@pytest.mark.parametrize("model", KGE)
def test_run_embedding_equals_jax(model):
    """The wrapper's whole run, training from the seed's own tables and
    the filtered evaluation of both splits, against the JAX wrapper's at
    the same seed and settings."""
    from cogdl_tpu.wrappers.triple_link_prediction import (
        TripleLinkPredictionWrapper as JTripleWrapper,
    )

    kw = {k: v for k, v in KGE_KW.items() if k != "seed"}
    want = JTripleWrapper(model, j_build_dataset("random-kg", **SMALL),
                          seed=3, **kw).run_embedding()
    got = TripleLinkPredictionWrapper(
        model, build_dataset("random-kg", **SMALL), seed=3,
        **kw).run_embedding("cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k


def test_kge_seeds_script_rehearsal():
    """``scripts/kge_seeds.py`` on the CPU for one seed: with the model's
    own tables it reports the wrapper's MRR; with tables from torch's
    generator another run."""
    from cogdl_tpu_torch.scripts import kge_seeds

    argv = ["--models", "distmult", "--seeds", "1", "--epochs", "2",
            "--device", "cpu"]
    (own,) = kge_seeds.main(argv)
    (drawn,) = kge_seeds.main(argv + ["--init", "torch"])
    want = TripleLinkPredictionWrapper(
        "distmult", build_dataset("random-kg"), seed=0, epochs=2,
        lr=0.01).run_embedding("cpu")["test_mrr"]
    assert own["mrr"] == [want] and own["mean"] == own["min"] == want
    assert drawn["init"] == "torch" and drawn["mrr"] != [want]


@pytest.mark.parametrize("model", KGE)
def test_kge_runs_through_run_embedding(model):
    """Each name on ``triple_link_prediction`` through ``experiment()``:
    ``epochs`` and ``lr`` are the trainer's keys and never reach the model
    (it keeps its own 50 and 1e-3, as in the JAX package); without
    ``device="cpu"`` and a card the call raises."""
    (res,) = experiment(dataset="random-kg", model=model, epochs=1,
                        lr=0.5, hidden_size=8, batch_size=256,
                        device="cpu")[("random-kg", model)]
    assert 0.0 < res["test_mrr"] <= 1.0 and res["val_acc"] == res["val_mrr"]
    w = TripleLinkPredictionWrapper(model, build_dataset("random-kg"),
                                    hidden_size=8, epochs=1, lr=0.5)
    assert (w.model.epochs, w.model.lr) == (1, 0.5)
    from cogdl_tpu_torch.experiments import _setup_variant

    w, mdl, trainer_kw = _setup_variant(build_dataset("random-kg"), model, 0,
                                        None, {"epochs": 9, "lr": 0.5,
                                               "hidden_size": 8})
    assert mdl is None and (w.model.epochs, w.model.lr) == (50, 1e-3)
    assert trainer_kw["epochs"] == 9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            experiment(dataset="random-kg", model=model, hidden_size=8)
