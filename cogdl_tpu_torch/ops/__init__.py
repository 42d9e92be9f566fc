"""Message-passing ops: the plain tier on torch index ops (``segment``,
``spmm``) and the hand-written CUDA kernel tier (``cuda``)."""

from .segment import (
    gather,
    scatter_max_with_argmax,
    segment_max,
    segment_mean,
    segment_min,
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
    s_add_e_mean,
    s_add_e_sum,
    s_dot_t,
    s_mul_e_mean,
    s_mul_e_sum,
    s_sub_e_sum,
    sddmm,
    source_table,
    spmm,
    spmm_coo,
)

__all__ = [
    "gather", "segment_sum", "segment_mean", "segment_max", "segment_min",
    "segment_softmax", "scatter_max_with_argmax", "spmm", "spmm_coo",
    "source_table", "cache_propagation", "gather_src", "sddmm",
    "edge_softmax", "mh_spmm", "mh_sddmm", "s_add_e_sum", "s_mul_e_sum",
    "s_sub_e_sum", "s_add_e_mean", "s_mul_e_mean", "s_dot_t", "aggregate",
]
