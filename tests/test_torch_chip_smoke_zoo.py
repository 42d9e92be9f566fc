"""CPU rehearsal of chip_smoke.py's phases of the full-batch
node-classification zoo (K1 at its widths, K3 at (8, 8), the main path's
launch counts, parity and quality) at a tiny size."""

import pytest
import torch

import chip_smoke as cs
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def test_zoo_kernel_check_phase_rehearsal():
    entries = cs.phase_zoo_kernel_check(CPU, num_nodes=300, iters=1)
    assert [e["name"] for e in entries] == [
        "spmm_csr[csr,F=64]", "spmm_csr[csr,F=192]", "spmm_csr[csc,F=64]",
        "spmm_csr[csc,F=192]"] + [f"gat_pass[{m},H=8,D=8]"
                                  for m in ("fwd", "dsd", "dsrc")]
    for e in entries:
        assert KERNEL_KEYS <= set(e) and e["err_over_tol"] == 0.0
        assert e["bound_by"] == "bytes"
        assert (e["library_ms"] is None) == (e["case"][0] == "gat_pass")
    assert [e["case"] for e in entries[:4]] == [
        ["spmm_csr", s, f] for s in ("csr", "csc") for f in (64, 192)]


def test_zoo_kernel_check_catches_a_kernel_that_disagrees(monkeypatch):
    real = cs.sk.spmm_csr

    def off(ptr, col, w, x, *a, **kw):
        out = real(ptr, col, w, x, *a, **kw)
        return out + 1e-3 if x.shape[1] == 192 else out

    monkeypatch.setattr(cs.sk, "spmm_csr", off)
    with pytest.raises(AssertionError, match="F=192"):
        cs.phase_zoo_kernel_check(CPU, num_nodes=300, iters=1)


def test_zoo_launches_expected_per_step_and_evaluation():
    """Per train step and evaluation at the zoo's widths (F_in 100, 47
    classes): GCNII 16 CSR + 16 CSC at F=64, 16 CSR an evaluation; APPNP
    10 + 10 at F=47; MixHop CSR F=100 x2 (no CSC: the features take no
    gradient), CSR and CSC F=192 x2; SGC CSR F=100 x2; DrGCN CSR and CSC at
    F=64 and F=47; DrGAT K3 fwd, dsd, dsrc at (8, 8) and (1, 47), fwd an
    evaluation; MLP and DeeperGCN nothing."""
    one_step = {m: cs._zoo_expected(m, 1, 0, True) for m in cs.ZOO_KW}
    one_eval = {m: cs._zoo_expected(m, 0, 1, True) for m in cs.ZOO_KW}
    assert one_step["gcnii"] == {"spmm_csr": {("csr", 64): 16,
                                              ("csc", 64): 16}}
    assert one_eval["gcnii"] == {"spmm_csr": {("csr", 64): 16}}
    assert one_step["appnp"] == {"spmm_csr": {("csr", 47): 10,
                                              ("csc", 47): 10}}
    assert one_step["mixhop"] == {"spmm_csr": {
        ("csr", 100): 2, ("csr", 192): 2, ("csc", 192): 2}}
    assert one_step["sgc"] == {"spmm_csr": {("csr", 100): 2}}
    assert one_step["drgcn"] == {"spmm_csr": {
        ("csr", 64): 1, ("csc", 64): 1, ("csr", 47): 1, ("csc", 47): 1}}
    assert one_step["drgat"] == {"gat_pass": {
        (m, h, d): 1 for m in ("fwd", "dsd", "dsrc")
        for h, d in ((8, 8), (1, 47))}}
    assert one_eval["drgat"] == {"gat_pass": {("fwd", 8, 8): 1,
                                              ("fwd", 1, 47): 1}}
    assert one_step["mlp"] == one_step["deepergcn"] == {}
    assert cs._zoo_expected("gcnii", 5, 6, False) == {}


def test_zoo_main_path_phase_rehearsal():
    info = cs.phase_zoo_main_path(CPU, num_nodes=300, epochs=2)
    assert info.pop("launches_by") == {}
    assert list(info) == list(cs.ZOO_KW) + ["deepergcn-remat"]
    for run in info.values():
        assert run["launches"] == {} and run["peak_hbm_bytes"] is None
        assert run["train_step_ms"] > 0 and run["eval_ms"] > 0


def test_zoo_main_path_catches_a_launch_count_off(monkeypatch):
    real = NodeClfWrapper.loss

    def loss_and_count(self, *a, **kw):
        cs.sk.gat_pass.launches += 1
        cs.sk.gat_pass.launches_by[("fwd", 8, 8)] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(NodeClfWrapper, "loss", loss_and_count)
    with pytest.raises(AssertionError, match="zoo-main mlp"):
        cs.phase_zoo_main_path(CPU, num_nodes=300, epochs=1, models=("mlp",))
    cs.sk.reset_launch_counts()


def test_zoo_parity_and_quality_phase_rehearsal():
    assert set(cs.phase_zoo_parity(CPU, num_nodes=300).values()) == {0.0}
    accs = cs.phase_zoo_quality(CPU, models=("sgc", "mlp"))
    assert all(a >= cs.ZOO_JAX_SBM_ACC[m] - cs.ZOO_QUALITY_MARGIN
               for m, a in accs.items())


def test_zoo_quality_holds_each_model_to_the_jax_packages_accuracy(
        monkeypatch):
    monkeypatch.setitem(cs.ZOO_JAX_SBM_ACC, "mlp", 1.03)
    with pytest.raises(AssertionError, match="mlp"):
        cs.phase_zoo_quality(CPU, models=("mlp",), epochs=5)
