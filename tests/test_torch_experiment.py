"""cogdl_tpu_torch's one-call API and CLI on the CPU, against the JAX
package's accuracy on the same synthetic dataset."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cogdl_tpu.experiments import experiment as j_experiment
from cogdl_tpu_torch import experiment
from cogdl_tpu_torch.options import main, parse_args_and_kwargs
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

# every test on one torch thread (a measure of Tier-1 time only; see
# test_torch_chip_smoke.one_cpu_thread)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# both packages train the same GCN on the same sbm graph from different
# initial weights and dropout draws: accuracy agrees within a band, not
# exactly
ACC_BAND = 0.05


def _mean_test_acc(results):
    (runs,) = results.values()
    return float(np.mean([r["test_acc"] for r in runs]))


def test_experiment_matches_jax_accuracy_band():
    kw = dict(dataset="sbm", model="gcn", epochs=60, seed=[0, 1])
    acc_t = _mean_test_acc(experiment(device="cpu", **kw))
    acc_j = _mean_test_acc(j_experiment(**kw))
    assert acc_t >= 0.95
    assert abs(acc_t - acc_j) <= ACC_BAND, (acc_t, acc_j)


def test_experiment_result_keys_and_seeds_alias():
    res = experiment(dataset="sbm-small", model="gcn", epochs=5, seeds=3,
                     device="cpu", hidden_size=8, use_best_config=True)
    (key, runs), = res.items()
    assert key == ("sbm-small", "gcn") and len(runs) == 1
    r = runs[0]
    for k in ("train_acc", "val_acc", "test_acc", "best_epoch", "train_time",
              "train_step_ms", "eval_ms", "train_loss"):
        assert k in r, k
    assert "_variables" not in r and "_graph" not in r


def test_experiment_without_card_raises(monkeypatch):
    """With no card and no explicit device the entry points raise; nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment(dataset="sbm", model="gcn", epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment(dataset="sbm", model="gcn", epochs=1, device="cuda")


@pytest.mark.parametrize("kwargs", [{"export_path": "m.bin"},
                                    {"vmap_seeds": True}])
def test_unported_experiment_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        experiment(dataset="sbm", model="gcn", epochs=1, device="cpu", **kwargs)


def test_cli_parses():
    args, kw = parse_args_and_kwargs(
        ["--dataset", "sbm", "powerlaw-2k", "--model", "gcn", "--seed", "0",
         "1", "--epochs", "7", "--device", "cpu", "--weight-decay", "0.001",
         "--use-best-config", "norm='layernorm'", "--hidden-size=32"])
    assert args.dataset == ["sbm", "powerlaw-2k"] and args.seed == [0, 1]
    assert kw == {"epochs": 7, "device": "cpu", "weight_decay": 0.001,
                  "use_best_config": True, "norm": "layernorm",
                  "hidden_size": 32}
    with pytest.raises(SystemExit):
        parse_args_and_kwargs(["stray"])


def test_cli_main_trains_on_cpu():
    res = main(["--dataset", "sbm", "--model", "gcn", "--epochs", "20",
                "--seed", "0", "--device", "cpu"])
    assert _mean_test_acc(res) > 0.8


def test_module_entry_point_runs():
    r = subprocess.run(
        [sys.executable, "-m", "cogdl_tpu_torch", "--epochs", "3", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "('sbm', 'gcn')" in r.stdout
