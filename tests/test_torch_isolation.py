"""cogdl_tpu_torch and chip_smoke.py import nothing of jax, flax, optax,
scikit-learn (absent on the card's machine) or the JAX package. A static
scan: this process already holds jax, so a runtime ``sys.modules`` check
would prove nothing."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cogdl_tpu", "sklearn")


def _sources():
    pkg = os.path.join(REPO, "cogdl_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def forbidden(module: str) -> bool:
    """Exact module match: ``cogdl_tpu`` and ``cogdl_tpu.x`` are forbidden,
    ``cogdl_tpu_torch`` is not."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # registry paths resolved by importlib at run time
            if node.value.count(".") >= 2 and " " not in node.value:
                yield node.value


def test_forbidden_matches_exact_modules():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("optax")
    assert forbidden("cogdl_tpu") and forbidden("cogdl_tpu.ops.spmm")
    assert not forbidden("cogdl_tpu_torch") and not forbidden("cogdl_tpu_torch.ops")
    assert not forbidden("jaxtyping") and not forbidden("flaxen")


def test_scan_covers_the_bench_and_the_kernel_wrappers():
    scanned = {os.path.relpath(p, REPO) for p in _sources()}
    assert {"cogdl_tpu_torch/bench.py",
            "cogdl_tpu_torch/ops/cuda/segment_kernels.py",
            "cogdl_tpu_torch/ops/cuda/device_layout.py",
            "cogdl_tpu_torch/ops/cuda/gather_kernels.py",
            "cogdl_tpu_torch/scripts/microbench_gather.py",
            "cogdl_tpu_torch/layers/sage_layer.py",
            "cogdl_tpu_torch/layers/saint_layer.py",
            "cogdl_tpu_torch/models/nn/graphsage.py",
            "cogdl_tpu_torch/models/nn/graphsaint.py",
            "cogdl_tpu_torch/utils/timing.py",
            "cogdl_tpu_torch/data/device_sampling.py",
            "cogdl_tpu_torch/data/sampling.py",
            "cogdl_tpu_torch/native.py",
            "cogdl_tpu_torch/wrappers/sampled_node_classification.py",
            "chip_smoke.py"} <= scanned


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_nothing_of_jax(path):
    bad = sorted({m for m in imported_modules(path) if forbidden(m)})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
