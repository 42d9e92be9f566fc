"""``cogdl_tpu_torch.scripts.deepergcn_seed``, the diagnosis of DeeperGCN's
accuracy at one seed on the card, rehearsed on the CPU: its ``.npz`` of
JAX variables loads into the port's model and gives the JAX forward, its
shared CPU masks make two runs one computation, its readings are the
trainer's, and its trajectory compares logits epoch by epoch.

Run as a script, it writes the JAX package's initial variables of the
zoo-quality run (DeeperGCN's defaults on ``sbm``, the JAX trainer's
initialising key for ``SEED``) into ``PATH``, flattened as the script's
``--weights`` reads them::

    PYTHONPATH=. python tests/test_torch_deepergcn_seed.py PATH [SEED]
"""

import sys

import jax
import numpy as np
import pytest
import torch

from cogdl_tpu.data import graph as jg
from cogdl_tpu.datasets.synthetic import sbm_graph as j_sbm
from cogdl_tpu.models import build_model as j_build_model
from cogdl_tpu_torch.datasets import build_dataset
from cogdl_tpu_torch.models import build_model
from cogdl_tpu_torch.scripts import deepergcn_seed as ds_script
from cogdl_tpu_torch.wrappers.node_classification import NodeClfWrapper
from test_torch_chip_smoke import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CPU = torch.device("cpu")


def jax_variables(seed: int = 0, **kw):
    """The JAX trainer's initial variables of DeeperGCN on ``sbm``: the
    model initialised with the second half of ``split(PRNGKey(seed))``."""
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    gj = j_sbm()
    model = j_build_model("deepergcn", in_features=gj.x.shape[1],
                          out_features=4, **kw)
    return jax.tree.map(np.asarray, model.init(
        {"params": init_rng, "dropout": init_rng}, gj, gj.x,
        training=False)), model, gj


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def write_weights(path: str, seed: int = 0, **kw) -> None:
    variables, _, _ = jax_variables(seed, **kw)
    np.savez(path, **flatten(jax.tree.map(np.asarray, dict(variables))))


def test_weights_file_loads_the_jax_forward(tmp_path):
    """The flattened file read back and put in by ``load_jax_params``
    gives the JAX model's eval logits within 1e-5."""
    kw = dict(hidden_size=16, num_layers=3)
    path = str(tmp_path / "w.npz")
    write_weights(path, **kw)
    variables, jm, gj = jax_variables(**kw)
    want = np.asarray(jm.apply(variables, jg.add_self_loops(gj),
                               training=False))
    read = ds_script.read_weights(path)
    assert set(read) == {"params", "batch_stats"}
    ds = build_dataset("sbm")
    tm = build_model("deepergcn", in_features=ds.num_features,
                     out_features=4, **kw)
    w = NodeClfWrapper(tm)
    with ds_script.injected(read):
        w.init(None, None)
    tm.eval()
    got = tm(w.prepare_graph(ds.graph), training=False).detach().numpy()
    n = ds.graph.num_nodes
    np.testing.assert_allclose(got[:n], want[:n], atol=1e-5, rtol=1e-5)


def test_shared_cpu_masks_replace_the_generators_draws():
    """Under ``cpu_draws`` every mask comes from the one CPU stream,
    whatever generator the caller hands in; after it the caller's
    generator draws again."""
    from cogdl_tpu_torch.layers.utils import dropout

    x = torch.ones(64, 8)
    with ds_script.cpu_draws(3):
        a = dropout(x, 0.5, torch.Generator().manual_seed(1))
    with ds_script.cpu_draws(3):
        b = dropout(x, 0.5, torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    c = dropout(x, 0.5, torch.Generator().manual_seed(1))
    d = dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert torch.equal(c, d) and not torch.equal(a, c)


def test_readings_and_trajectory_on_the_cpu(capsys):
    """The readings are the trainer's (the shared masks on the CPU are its
    own generator's stream), and a trajectory of two copies on one device
    has no difference."""
    plain = ds_script.reading(CPU, 3, 0, "cpu")
    same = ds_script.reading(CPU, 3, 0, "same-draws", same_draws=True)
    assert plain["test_acc"] == same["test_acc"]
    assert plain["best_epoch"] == same["best_epoch"]
    for opt in ("adam", "sgd"):
        first, *rows = ds_script.trajectory(CPU, 2, 0, optimizer=opt)
        assert first["epoch"] == 0 and first["grad_sign_flips"] == 0
        assert first["logits_err_over_tol"] == first["grad_err_over_tol"] \
            == first["loss_diff"] == 0.0
        assert [r["epoch"] for r in rows] == [1, 2]
        assert all(r["err_over_tol"] == 0.0 for r in rows)
    assert ds_script.main(["--device", "cpu", "--epochs", "2", "--runs",
                           "1", "--no-cpu", "--trajectory", "0"]) == 0
    assert "[deepergcn-seed]" in capsys.readouterr().out


if __name__ == "__main__":
    write_weights(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 0)
