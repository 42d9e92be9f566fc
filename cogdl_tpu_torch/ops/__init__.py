"""Message-passing ops: the plain tier on torch index ops (``segment``,
``spmm``) and the hand-written CUDA kernel tier (``cuda``)."""

from .segment import (
    gather,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
from .spmm import (
    aggregate,
    cache_propagation,
    edge_softmax,
    gather_src,
    mh_sddmm,
    mh_spmm,
    sddmm,
    source_table,
    spmm,
    spmm_coo,
)

__all__ = [
    "gather", "segment_sum", "segment_mean", "segment_max",
    "segment_softmax", "spmm", "spmm_coo", "source_table",
    "cache_propagation", "gather_src", "sddmm", "edge_softmax", "mh_spmm",
    "mh_sddmm", "aggregate",
]
