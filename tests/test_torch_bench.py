"""``cogdl_tpu_torch.bench`` on the CPU at a small size: every route prints
one JSON line with the fields that carry over from the JAX package's
``bench.py`` and none of those that compare with other hardware."""

import json

import pytest
import torch

from cogdl_tpu_torch import bench
from cogdl_tpu_torch.ops import cache_propagation
from cogdl_tpu_torch.ops.cuda import SCHEDULE_KEYS
from cogdl_tpu_torch.ops.cuda import segment_kernels as sk
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

SMALL = ["--device", "cpu", "--nodes", "2000", "--avg-degree", "10",
         "--steps", "2", "--warmup", "1", "--repeats", "1"]
FIELDS = {"metric", "value", "unit", "step_ms", "device", "blocked_layout",
          "prop_cache", "panel_rows"}


def _run(capsys, *flags):
    payload = bench.main(SMALL + list(flags))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    assert json.loads(lines[0]) == payload
    assert FIELDS <= set(payload)
    assert not {"vs_baseline", "vs_gather_floor"} & set(payload)
    assert "peak_hbm_bytes" not in payload        # a CPU run has none
    assert payload["unit"] == "edges/sec" and payload["device"] == "cpu"
    assert payload["value"] > 0 and payload["step_ms"] > 0
    return payload


def test_gcn_reports_cached_and_uncached_steps(capsys):
    p = _run(capsys, "--model", "gcn")
    assert p["prop_cache"] and not p["blocked_layout"]
    assert p["panel_rows"] == 0
    assert p["step_ms_no_cache"] > 0 and p["edges_per_sec_no_cache"] > 0
    assert p["metric"].startswith("GCN train-step edges/sec")
    assert "2000n x10, F=100" in p["metric"]


def test_gcn_without_the_propagation_cache(capsys):
    p = _run(capsys, "--model", "gcn", "--no-prop-cache")
    assert not p["prop_cache"]
    assert "step_ms_no_cache" not in p and "edges_per_sec_no_cache" not in p


def test_gat_with_attention_dropout(capsys):
    p = _run(capsys, "--model", "gat", "--attn-drop", "0.5")
    assert not p["prop_cache"] and "step_ms_no_cache" not in p
    assert p["metric"].startswith("GAT")


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_blocked_builds_the_panel_structure_on_the_device(capsys, model):
    p = _run(capsys, "--model", model, "--blocked", "--panel-rows", "512",
             "--attn-drop", "0.5")
    assert p["blocked_layout"] and p["panel_rows"] == 512
    assert p["prop_cache"] == (model == "gcn")


def test_blocked_sizes_its_panels_by_default(capsys):
    # no height named: the structure K1/K2 read gets two panels, K2's route
    assert _run(capsys, "--blocked")["panel_rows"] == 1024


def test_blocked_gat_gets_two_panels_by_default(capsys):
    # fused GAT's structure is sized like K1/K2's: K3 is cut by edges too
    p = _run(capsys, "--model", "gat", "--blocked", "--attn-drop", "0.5")
    assert p["panel_rows"] == 1024


def test_out_file_holds_the_same_line(capsys, tmp_path):
    out = tmp_path / "bench.json"
    p = _run(capsys, "--no-prop-cache", "--out", str(out))
    assert json.loads(out.read_text()) == p


def test_products_sets_the_published_shape():
    args = bench.parse_args(["--products", "--model", "gat"])
    assert (args.nodes, args.avg_degree) == (2_450_000, 50)
    assert (args.feat_dim, args.hidden) == (100, 128)
    assert bench.parse_args([]).nodes == 100_000


def test_unported_flags_are_refused():
    for flag in ("--bf16", "--remat", "--act-compress", "--r-tile",
                 "--reorder"):
        with pytest.raises(SystemExit):
            bench.parse_args([flag])


SAMPLED = ["--sampled", "--device", "cpu", "--nodes", "2000",
           "--avg-degree", "10", "--batch-size", "8", "--fanouts", "2,2",
           "--steps", "2", "--warmup", "1", "--repeats", "1"]
SAMPLED_FIELDS = {"metric", "value", "unit", "step_ms", "seeds_per_sec",
                  "edge_slots_per_step", "loss", "device", "setup_s"}


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_sampled_emits_its_fields(capsys, model):
    sk.reset_launch_counts()
    payload = bench.main(SAMPLED + ["--model", model])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == payload
    assert set(payload) == SAMPLED_FIELDS       # a CPU run: no peak_hbm_bytes
    # edge slots a step: 8·2 + 24·2 (plan_sizes 8, 24, 72)
    assert payload["edge_slots_per_step"] == 64
    # both rates are rounded to integers
    assert payload["value"] == pytest.approx(
        64 * 1000 / payload["step_ms"], abs=0.5)
    assert payload["seeds_per_sec"] == pytest.approx(
        8 * 1000 / payload["step_ms"], abs=0.5)
    assert payload["metric"].startswith(f"{model.upper()} sampled-train")
    assert "fanouts 2,2, B=8" in payload["metric"]
    assert payload["device"] == "cpu" and payload["unit"] == "edges/sec"
    assert payload["loss"] > 0 and "vs_baseline" not in payload
    # no sampled step runs a hand-written kernel
    assert (sk.spmm_csr.launches, sk.spmm_csr_accum.launches,
            sk.gat_pass.launches) == (0, 0, 0)


def test_sampled_model_names():
    assert bench.parse_args(["--sampled"]).model == "sage"   # as bench.py
    assert bench.parse_args(["--sampled", "--model", "gat"]).model == "gat"
    args = bench.parse_args(["--sampled", "--products"])
    assert (args.nodes, args.batch_size, args.fanouts) == (
        2_450_000, 1024, "15,10")
    with pytest.raises(SystemExit):
        bench.parse_args(["--model", "sage"])    # full batch has no sage


def test_sampled_graph_carries_features_on_the_device():
    args = bench.parse_args(SAMPLED)
    g = bench.make_sampled_graph(args, torch.device("cpu"))
    assert g.x.shape == (g.n_pad, 100) and g.meta_get("num_classes") == 47
    E = g.num_edges
    assert int((g.row[:E] == g.col[:E]).sum()) == 2000   # one self loop each


HOST_FIELDS = {"metric", "value", "unit", "step_ms", "seeds_per_sec",
               "edge_slots_per_step", "timed_steps", "loss", "device",
               "setup_s", "host_threads", "host_sample_ms",
               "host_structure_ms"}


def test_host_sampler_emits_its_fields(capsys):
    """GraphSAGE-mean over the host sampler's blocks: padded block edges a
    step, the worker's own sampling time a batch, no structure built and
    no kernel launched."""
    sk.reset_launch_counts()
    payload = bench.main(SAMPLED + ["--host-sampler", "--steps", "3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == payload
    assert set(payload) == HOST_FIELDS          # a CPU run: no peak_hbm_bytes
    # e_pad of the blocks: _bucket(24·2) + _bucket(8·2)
    assert payload["edge_slots_per_step"] == 48 + 16
    assert payload["timed_steps"] == 3
    assert payload["value"] == pytest.approx(
        64 * 1000 / payload["step_ms"], abs=0.5)
    assert payload["metric"].startswith("SAGE sampled-train")
    assert "host sampler" in payload["metric"]
    assert payload["host_sample_ms"] > 0 and payload["host_threads"] >= 1
    assert payload["host_structure_ms"] is None      # mean reads none
    assert payload["loss"] > 0 and "vs_baseline" not in payload
    assert (sk.spmm_csr.launches, sk.gat_pass.launches) == (0, 0)


def test_host_sampler_refuses_gat():
    # the JAX script's host bench builds GraphSAGE only
    with pytest.raises(ValueError, match="GraphSAGE"):
        bench.main(SAMPLED + ["--host-sampler", "--model", "gat"])


def test_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--nodes", "2000"])


def test_blocked_graph_frees_the_raw_edges_and_shares_the_structure():
    args = bench.parse_args(SMALL + ["--model", "gat", "--blocked",
                                     "--panel-rows", "512"])
    g = bench.make_graph(args, torch.device("cpu"))
    assert g.row.numel() == g.col.numel() == g.edge_weight.numel() == 1
    assert g.num_edges == 2000 * 10 + 2000
    ex = g.extras
    # the structure and the schedule K3 cuts it by, shared by the directions
    keys = ("ptr", "col") + SCHEDULE_KEYS
    assert sorted(ex) == sorted(f"spmm_{d}_{k}" for d in ("fw", "bw")
                                for k in keys)
    assert all(ex[f"spmm_bw_{k}"] is ex[f"spmm_fw_{k}"] for k in keys)
    assert ex["spmm_fw_ptr"].shape == (4, g.n_pad + 1)
    assert int(ex["spmm_fw_ptr"][-1, -1]) == g.num_edges


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_train_steps_lower_the_loss(model):
    args = bench.parse_args(SMALL + ["--model", model, "--blocked",
                                     "--panel-rows", "512"])
    dev = torch.device("cpu")
    g = bench.make_graph(args, dev)
    if model == "gcn":
        g = cache_propagation(g)
    net, opt = bench.make_model(args, g, dev)
    sk.reset_launch_counts()
    losses = bench.train_steps(net, opt, g, 4, torch.Generator().manual_seed(0))
    assert len(losses) == 4 and losses[-1] < losses[0]
    # CPU tensors take the plain versions: no kernel is launched
    assert (sk.spmm_csr.launches, sk.spmm_csr_accum.launches,
            sk.gat_pass.launches) == (0, 0, 0)
