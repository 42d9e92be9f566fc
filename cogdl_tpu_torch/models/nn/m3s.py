"""M3S — the port of ``cogdl_tpu/models/nn/m3s.py``: a GCN (K1 on the
card); its penultimate embeddings (``embed``) feed the multi-stage label
expansion of the ``m3s_staged`` wrapper (``wrappers/staged.py``)."""

from __future__ import annotations

from .gcn import GCN


class M3S(GCN):
    """GCN backbone; the stage logic lives in the wrapper's ``pre_stage``."""
