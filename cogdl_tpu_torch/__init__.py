"""cogdl_tpu_torch — the PyTorch/CUDA port of cogdl_tpu for NVIDIA Hopper.

It mirrors ``cogdl_tpu``'s module paths and public names; plain tensor code is
PyTorch and each Pallas TPU kernel on a ported path becomes a hand-written
CUDA kernel (``csrc/``). Entry points run on the card unless the caller asks
for ``device="cpu"``. The package imports nothing of jax or cogdl_tpu.
"""

__version__ = "0.1.0"

from .data import Graph, from_coo  # noqa: F401


def experiment(*args, **kwargs):
    from .experiments import experiment as _experiment

    return _experiment(*args, **kwargs)


def pipeline(*args, **kwargs):
    from .pipelines import pipeline as _pipeline

    return _pipeline(*args, **kwargs)
