"""CPU rehearsal of chip_smoke.py's network-embedding phases (emb-kernel,
emb-main, emb-parity, emb-quality) at a tiny size, the generator of the
BlogCatalog- and PPI-scale networks, and the K1 launches the phases
expect against the products the same runs make over the kernel's
structure on the CPU.

Run as a script, it computes the JAX package's reference for
``chip_smoke.EMB_JAX_MICRO_F1``: the mean micro-F1 of ``MODEL`` over
seeds ``FIRST`` (0 by default) to ``FIRST + SEEDS - 1`` through the JAX
package's ``train`` on the CPU, on the PPI-scale network, at its
BEST_CONFIGS::

    PYTHONPATH=. python tests/test_torch_chip_smoke_emb.py MODEL SEEDS [FIRST]
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.models.emb import prone as tprone
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "device_ms"}
# the BlogCatalog- and PPI-scale networks cut to 150 nodes, 900 edges
# and 6 labels
TINY = {"num_nodes": 150, "num_edges": 900, "num_labels": 6}


@pytest.mark.parametrize("cell", ["blogcatalog", "ppi"])
def test_the_networks_are_blogcatalog_and_ppi_scale(cell, tmp_path):
    """The counts the phases' records name, 1-3 labels a node, a heavy
    tail, the same network from the seed, and the loader's view of the
    file the phases write."""
    emb_set = {"blogcatalog": cs.EMB_BLOGCATALOG, "ppi": cs.EMB_PPI}[cell]
    A, groups = cs.embedding_network(**emb_set)
    N = emb_set["num_nodes"]
    assert A.shape == (N, N) and A.nnz == 2 * emb_set["num_edges"]
    assert (A != A.T).nnz == 0 and A.diagonal().sum() == 0
    per = np.asarray(groups.sum(1)).ravel()
    assert groups.shape == (N, emb_set["num_labels"])
    assert per.min() >= 1 and per.max() <= 3
    deg = np.asarray(A.sum(1)).ravel()
    assert deg.max() > 20 * deg.mean()
    B, _ = cs.embedding_network(**emb_set)
    assert (A != B).nnz == 0
    name = {"blogcatalog": "blogcatalog", "ppi": "ppi-ne"}[cell]
    path = cs.write_network_mat(str(tmp_path), name, A, groups)
    from cogdl_tpu_torch.datasets.matlab import build

    g = build(name, os.path.dirname(os.path.dirname(path))).graph
    assert (g.num_nodes, g.num_edges) == (N, 2 * emb_set["num_edges"])


def test_emb_kernel_check_phase_rehearsal():
    entries = cs.phase_emb_kernel_check(CPU, emb_set=TINY, iters=1)
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=128,D^-1A,n150]", "spmm_csr[csr,F=128,A,n150]"]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["err_over_tol"] == 0.0
        assert e["case"] == ["spmm_csr", "csr", 128]
        assert e["nnz"] == 2 * TINY["num_edges"]
        assert e["library_ms"] is not None and e["bound_by"] in (
            "bytes", "operations")


def test_emb_launches_expected():
    """On the card ProNE launches K1 eleven times and ProNE++ 66, every
    launch at F=128 over the CSR; no other model launches it."""
    assert cs._emb_expected("prone", True) == {
        "spmm_csr": {("csr", 128): 11}}
    assert cs._emb_expected("prone++", True) == {
        "spmm_csr": {("csr", 128): 66}}
    for m in cs.EMB_MODELS:
        assert cs._emb_expected(m, False) == {}
        if m not in ("prone", "prone++"):
            assert cs._emb_expected(m, True) == {}


def test_emb_main_phase_rehearsal(monkeypatch):
    """Every model through experiment() on the tiny .mat network; the
    products ProNE and ProNE++ make all read the K1 structure (on the
    card each is a K1 launch) and number as the phase expects."""
    seen = []
    spmm = tprone.spmm

    def counted(graph, x):
        seen.append(("spmm_fw_w" in (graph.extras or {}), x.shape[1]))
        return spmm(graph, x)

    monkeypatch.setattr(tprone, "spmm", counted)
    info = cs.phase_emb_main(CPU, emb_set=TINY, model_kw={
        "walk_num": 2, "walk_length": 10, "num_samples": 5000})
    assert set(cs.EMB_MODELS) <= set(info)
    assert info["products"] == [70, 7]
    assert seen == [(True, 128)] * 77
    assert info["launches_by"] == {}
    for m in cs.EMB_MODELS:
        r = info[m]
        assert 0 < r["test_micro_f1"] <= 1 and r["probe_ms"] > 0
        assert r["seconds"] >= r["embed_s"] > 0
    assert info["deepwalk"]["stats"]["sgns_steps"] > 0
    assert {"walks_s", "pairs_s", "train_s"} <= set(info["node2vec"]["stats"])
    assert info["sdne"]["stats"]["ae_steps"] == 200
    assert info["sgns_profile"]["busy_ms"] is None


def test_emb_parity_set_takes_the_ppi_runs_branches():
    """The smaller network of emb-parity's models other than the SGNS
    ones takes every size-dependent branch they took at PPI's scale."""
    assert cs.emb_parity_branches(cs.EMB_PARITY_SET) == \
        cs.emb_parity_branches(cs.EMB_PPI) == {"netmf": "dense"}
    assert cs.EMB_PARITY_SET["num_nodes"] < cs.EMB_PPI["num_nodes"]
    assert cs.EMB_PARITY_SET["num_labels"] == cs.EMB_PPI["num_labels"]


def test_emb_parity_phase_rehearsal():
    errs = cs.phase_emb_parity(CPU, emb_set=TINY, sgns_set=TINY)
    assert set(errs) == set(cs.EMB_MODELS) | {"f1_probe"}
    # ARPACK's start vector is its own: HOPE agrees by its invariants
    assert all(v <= 1.0 for v in errs.values()), errs
    assert all(v == 0.0 for m, v in errs.items() if m != "hope"), errs


def test_emb_quality_phase_rehearsal(monkeypatch):
    models = ("prone", "line")
    monkeypatch.setattr(cs, "EMB_JAX_MICRO_F1", {m: 0.0 for m in models})
    scores = cs.phase_emb_quality(CPU, emb_set=TINY, models=models, seeds=2)
    assert set(scores) == set(models)
    monkeypatch.setattr(cs, "EMB_JAX_MICRO_F1", {m: 1.5 for m in models})
    with pytest.raises(AssertionError, match="below the JAX"):
        cs.phase_emb_quality(CPU, emb_set=TINY, models=models[:1])


def test_every_model_has_a_quality_reference():
    assert set(cs.EMB_JAX_MICRO_F1) == set(cs.EMB_MODELS)
    assert all(0 < v < 1 for v in cs.EMB_JAX_MICRO_F1.values())


def test_columns_match_up_to_sign_and_rotation():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(40, 6)))
    Q = torch.from_numpy(Q)
    vals = torch.tensor([0.1, 0.2, 0.3, 0.3, 0.5, 0.6], dtype=torch.float64)
    c, s = np.cos(0.7), np.sin(0.7)
    R = torch.eye(6, dtype=torch.float64)
    R[2:4, 2:4] = torch.tensor([[c, -s], [s, c]])
    flipped = Q @ R * torch.tensor([1, -1, 1, 1, -1, 1.0])
    assert cs._columns_match(flipped, Q, vals, 1e-4) < 1e-6
    bad = Q.clone()
    bad[:, 1] = -bad[:, 1] + 1e-3
    assert cs._columns_match(bad, Q, vals, 1e-4) > 1.0


def test_cpu_draws_are_the_same_on_any_device():
    a = cs.CpuDraws("x", 3, "cpu")
    b = cs.emb_walks.Draws("x", 3, "cpu")
    assert torch.equal(a.permutation(10), b.permutation(10))
    p = torch.tensor([0.2, 0.3, 0.5], dtype=torch.float64)
    assert torch.equal(a.choice(p, 7), b.choice(p, 7))
    assert torch.equal(a.bernoulli(0.8, (4, 4)), b.bernoulli(0.8, (4, 4)))


def test_emb_routes_script_agrees_at_a_small_size(capsys):
    """HOPE's two singular-value routes and Spectral's two eigenvalue
    routes agree (``python -m cogdl_tpu_torch.scripts.emb_routes``)."""
    from cogdl_tpu_torch.scripts import emb_routes

    out = emb_routes.main(["--device", "cpu", "--nodes", "160", "--edges",
                           "900", "--labels", "4"])
    assert out["hope_sigma_max_diff"] < 1e-10
    assert out["spectral_lambda_max_diff"] < 1e-10
    assert {"hope_svds_s", "hope_dense_svd_s", "spectral_eigh_s",
            "spectral_eigsh_s"} <= set(out)
    assert capsys.readouterr().out.startswith("{")


def quality_reference(model: str, seeds: int, first: int = 0) -> float:
    """The JAX package's mean micro-F1 of ``model`` over seeds ``first``
    to ``first + seeds - 1`` on the PPI-scale network, on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import cogdl_tpu.datasets as jdatasets
    from cogdl_tpu.experiments import train

    with tempfile.TemporaryDirectory() as root:
        cs.write_network_mat(root, "ppi-ne",
                             *cs.embedding_network(**cs.EMB_PPI))
        jdatasets.DATA_ROOT = root
        scores = [train("ppi-ne", model, seed=s, use_best_config=True)[
            "test_micro_f1"] for s in range(first, first + seeds)]
    print(f"{model} seeds {first}-{first + seeds - 1}: {scores}; mean "
          f"{float(np.mean(scores)):.6f}")
    return float(np.mean(scores))


if __name__ == "__main__":
    quality_reference(sys.argv[1], int(sys.argv[2]),
                      int(sys.argv[3]) if len(sys.argv) > 3 else 0)
