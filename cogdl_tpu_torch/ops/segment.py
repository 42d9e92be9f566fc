"""Segment / message-passing primitives on torch index ops — the port of
``cogdl_tpu/ops/segment.py``.

``segment_ids`` may be int32 (the graph's dtype) or int64. Sums use
``index_add_``, maxima ``scatter_reduce``. The ``sorted`` flag is accepted
for signature parity with the JAX package; the torch ops do not need it.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "scatter_max_with_argmax",
    "gather",
]

_NEG_INF = -1e30


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis (per-edge source feature gather)."""
    return x.index_select(0, idx)


def _expand_ids(segment_ids: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    ids = segment_ids.long().reshape((-1,) + (1,) * (like.ndim - 1))
    return ids.expand_as(like)


def segment_sum(data, segment_ids, num_segments: int, sorted: bool = True):
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def segment_mean(data, segment_ids, num_segments: int, sorted: bool = True):
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[0]), segment_ids, num_segments)
    cnt = cnt.clamp_min(1.0)
    return s / cnt.reshape((-1,) + (1,) * (s.ndim - 1))


def _segment_max_raw(data, segment_ids, num_segments: int):
    """Per-segment max with ``-inf`` in empty segments."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), float("-inf"))
    return out.scatter_reduce(0, _expand_ids(segment_ids, data), data, "amax",
                              include_self=False)


def segment_max(data, segment_ids, num_segments: int, sorted: bool = True,
                empty_value: float = 0.0):
    """Max-aggregation; empty segments get ``empty_value``."""
    m = _segment_max_raw(data, segment_ids, num_segments)
    return torch.where(m <= _NEG_INF / 2, torch.full_like(m, empty_value), m)


def segment_min(data, segment_ids, num_segments: int, sorted: bool = True,
                empty_value: float = 0.0):
    """Min-aggregation; empty segments get ``empty_value``."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), float("inf"))
    m = out.scatter_reduce(0, _expand_ids(segment_ids, data), data, "amin",
                           include_self=False)
    return torch.where(m >= -_NEG_INF / 2, torch.full_like(m, empty_value), m)


def scatter_max_with_argmax(data, segment_ids, num_segments: int,
                            sorted: bool = True):
    """Per-segment max and the lowest index of an element that attains it
    (``-1`` in an empty segment, whose max is 0); the gradient flows
    through the max only."""
    m = segment_max(data, segment_ids, num_segments, empty_value=_NEG_INF)
    is_max = data == m.index_select(0, segment_ids.long())
    eidx = torch.arange(data.shape[0], device=data.device)
    eidx = eidx.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    big = torch.iinfo(torch.int32).max
    cand = torch.where(is_max, eidx, torch.full_like(eidx, big))
    amax = cand.new_full((num_segments,) + tuple(data.shape[1:]), big)
    amax = amax.scatter_reduce(0, _expand_ids(segment_ids, data), cand,
                               "amin", include_self=True)
    amax = torch.where(amax == big, torch.full_like(amax, -1), amax)
    m = torch.where(m <= _NEG_INF / 2, torch.zeros_like(m), m)
    return m, amax.to(torch.int32)


def segment_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    sorted: bool = True,
) -> torch.Tensor:
    """Numerically stable per-segment softmax of edge scores ``[E]`` or
    ``[E, H]``; ``segment_ids`` is the per-edge destination. Masked-out edges
    get zero weight."""
    m = None
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (scores.ndim - mask.ndim))
        scores = torch.where(m, scores, torch.full_like(scores, _NEG_INF))
    seg_max = _segment_max_raw(scores, segment_ids, num_segments)
    seg_max = torch.where(seg_max <= _NEG_INF / 2, torch.zeros_like(seg_max),
                          seg_max)
    ex = torch.exp(scores - seg_max.index_select(0, segment_ids))
    if m is not None:
        ex = torch.where(m, ex, torch.zeros_like(ex))
    denom = segment_sum(ex, segment_ids, num_segments).clamp_min(1e-16)
    return ex / denom.index_select(0, segment_ids)
