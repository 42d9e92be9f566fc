"""Graph and feature transforms — the port of
``cogdl_tpu/utils/transforms.py``: dropout and augmentation helpers with
static shapes (a drop is a weight or feature mask, never a shape change).
Every draw comes from an explicit ``torch.Generator`` on the data's
device."""

from __future__ import annotations

from typing import Optional

import torch

from ..data.graph import Graph
from ..layers.utils import dropout_keep as _keep


def drop_edge(graph: Graph, rate: float,
              generator: Optional[torch.Generator] = None,
              keep: Optional[torch.Tensor] = None) -> Graph:
    """DropEdge as a weight mask, the kept weights scaled by ``1 /
    (1 - rate)``; clears the norm tag. A kernel structure on the graph takes
    the new weights (``Graph.with_edge_weight``). ``keep``: the mask, drawn
    ahead (``[e_pad]`` bool), instead of a draw from ``generator``."""
    if keep is None:
        keep = _keep(graph.edge_weight.shape, rate, graph.device, generator)
    w = graph.edge_weight * keep / max(1.0 - rate, 1e-6)
    return graph.with_edge_weight(w).replace(
        meta=tuple((k, v) for k, v in graph.meta if k != "norm"))


def drop_node(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DropNode (GRAND): zero whole feature rows, rescale the rest."""
    keep = _keep((x.shape[0], 1), rate, x.device, generator)
    return x * keep / max(1.0 - rate, 1e-6)


def drop_feature(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator] = None,
                 keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column-wise feature masking (GRACE augmentation), unscaled.
    ``keep``: the ``[1, F]`` mask, drawn ahead, instead of a draw."""
    if keep is None:
        keep = _keep((1, x.shape[1]), rate, x.device, generator)
    return x * keep


def add_gaussian_noise(x: torch.Tensor, sigma: float,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    return x + sigma * torch.randn(x.shape, generator=generator,
                                   device=x.device)


def normalize_features(x: torch.Tensor) -> torch.Tensor:
    """Row L1 normalisation (planetoid preprocessing)."""
    return x / x.abs().sum(1, keepdim=True).clamp_min(1e-12)
