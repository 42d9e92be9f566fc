"""GAT layer: multi-head additive attention over edges, edge softmax and
multi-head aggregation — the port of ``cogdl_tpu/layers/gat_layer.py``.

Three routes, chosen by the graph as in the JAX layer:

  * regular fanout: a block of the device sampler (``meta["fanout"]``),
    where every destination owns exactly ``f`` dst-major slots, so softmax
    and aggregation are ``[n, f, ...]`` reshape-reduces in plain torch on
    every device (the JAX package computes them outside any kernel too);
  * fused: when the graph carries the kernel structure (``prepare_spmm``),
    scores, softmax, attention dropout and aggregation run in K3 through
    :func:`cogdl_tpu_torch.ops.cuda.maybe_cuda_gat_fused` (the plain K3 on
    CPU tensors), so no per-edge tensor is kept;
  * unfused: otherwise, ``gather`` + ``edge_softmax`` + ``mh_spmm`` in plain
    torch, which a CUDA tensor never takes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.graph import Graph
from ..ops import edge_softmax, gather, gather_src, mh_spmm
from ..ops.cuda import draw_gat_seed, has_gat_structure, maybe_cuda_gat_fused
from .utils import (
    CDense,
    MaskedBatchNorm,
    dropout,
    dropout_keep,
    get_activation,
    glorot_uniform_,
)


class GATLayer(nn.Module):
    """``out_features`` is the per-head size. Parameters as in the JAX
    layer: ``W`` (no bias), ``a_src`` and ``a_dst`` ``[1, H, D]``, and
    ``res_proj``/``norm`` when asked for.

    ``exact_scores`` is accepted for signature parity: the port always
    computes the scores in fp32, with TF32 off (PyTorch's default for fp32
    matrix products)."""

    def __init__(self, in_features: int, out_features: int, nhead: int = 1,
                 alpha: float = 0.2, attn_drop: float = 0.5,
                 activation: Optional[str] = None, residual: bool = False,
                 norm: Optional[str] = None, concat: bool = True,
                 exact_scores: bool = False):
        super().__init__()
        self.nhead = nhead
        self.out_features = out_features
        self.alpha = alpha
        self.attn_drop = attn_drop
        self.activation = activation
        self.residual = residual
        self.norm_type = norm
        self.concat = concat
        self.exact_scores = exact_scores
        H, D = nhead, out_features
        self.W = CDense(in_features, H * D, bias=False)
        self.a_dst = nn.Parameter(torch.empty(1, H, D))
        self.a_src = nn.Parameter(torch.empty(1, H, D))
        width = H * D if concat else D
        if residual and in_features != width:
            self.res_proj = CDense(in_features, width, bias=False)
        if norm == "batchnorm":
            self.norm = MaskedBatchNorm(width)
        elif norm == "layernorm":
            self.norm = nn.LayerNorm(width, eps=1e-6)  # flax default
        elif norm is not None:
            raise ValueError(f"unknown norm {norm!r}: batchnorm | layernorm")
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-initialise from ``generator``: ``W`` (and ``res_proj``)
        LeCun-normal as flax ``Dense``, ``a_dst`` then ``a_src`` Glorot
        uniform."""
        self.W.reset_parameters(generator)
        self.reset_own_parameters(generator)
        if hasattr(self, "res_proj"):
            self.res_proj.reset_parameters(generator)
        if self.norm_type == "batchnorm":
            self.norm.reset_parameters(generator)
        elif self.norm_type == "layernorm":
            self.norm.reset_parameters()

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """``a_dst`` then ``a_src``, Glorot uniform: the parameters that are
        the layer's own rather than a child module's."""
        glorot_uniform_(self.a_dst, generator)
        glorot_uniform_(self.a_src, generator)

    def draw_attn_drop(self, graph: Graph, device,
                       generator: Optional[torch.Generator] = None,
                       training: bool = True) -> Optional[torch.Tensor]:
        """The attention-dropout draw :meth:`forward` would make on a full
        graph, made now: K3's seed on the fused route, the ``[e_pad, H]``
        keep mask on the unfused one; None without dropout. A checkpointed
        caller draws it outside the recomputed call and passes it as
        ``attn_rand``, so that the recompute drops the same edges."""
        if not training or self.attn_drop <= 0.0:
            return None
        if has_gat_structure(graph):
            return draw_gat_seed(generator, device)
        return dropout_keep((graph.e_pad, self.nhead), self.attn_drop, device,
                            generator)

    def forward(self, graph: Graph, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None,
                attn_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attn_rand``: the attention-dropout draw made ahead by
        :meth:`draw_attn_drop` for a full graph, used instead of a draw
        from ``generator``."""
        H, D = self.nhead, self.out_features
        h = self.W(x).view(-1, H, D)
        # additive attention split into dst and src halves (aᵀ[Wh_i || Wh_j])
        score_dst = (h * self.a_dst).sum(-1)                # [N, H]
        drop = self.attn_drop if training else 0.0
        if graph.meta_get("fanout"):
            # ahead of the fused route: a block has no kernel structure, and
            # maybe_cuda_gat_fused raises for a CUDA tensor without it
            out = self._fanout_attention(graph, h, score_dst, drop, generator)
        else:
            score_src = (h * self.a_src).sum(-1)
            out = maybe_cuda_gat_fused(graph, score_dst, score_src, h,
                                       alpha=self.alpha, attn_drop=drop,
                                       generator=generator, seed=attn_rand)
        if out is None:
            e = gather(score_dst, graph.row) + gather_src(graph, score_src)
            att = edge_softmax(graph, F.leaky_relu(e, self.alpha))
            if drop > 0:
                att = dropout(att, drop, generator, keep=attn_rand)
            out = mh_spmm(graph, att, h)                    # [N, H, D]
        out = out.reshape(-1, H * D) if self.concat else out.mean(1)
        if self.residual:
            out = out + (self.res_proj(x) if hasattr(self, "res_proj") else x)
        if self.norm_type == "batchnorm":
            out = self.norm(out, graph.node_mask(),
                            use_running_average=not training)
        elif self.norm_type == "layernorm":
            out = self.norm(out)
        if self.activation is not None:
            out = get_activation(self.activation)(out)
        return out

    def _fanout_attention(self, graph: Graph, h: torch.Tensor,
                          score_dst: torch.Tensor, drop: float,
                          generator: Optional[torch.Generator]
                          ) -> torch.Tensor:
        """Attention over a regular-fanout block (reference
        ``cogdl_tpu/layers/gat_layer.py:56-80``): the flat ``[N, H·D]`` rows
        of the first ``n·f`` slots gathered once, the source score
        recomputed from them, dead slots (weight 0) masked to −1e30, softmax
        over the ``f`` axis, then dropout and the weighted sum; ``[n_pad, H,
        D]`` with zeros past the frontier. A destination whose slots are
        all dead gets the mean of its slots' rows (the frame's sink row)."""
        H, D = self.nhead, self.out_features
        f, n = graph.meta_get("fanout"), graph.meta_get("frontier")
        cols = graph.col[: n * f]
        msg = h.reshape(-1, H * D).index_select(
            0, cols.clamp(0, h.shape[0] - 1)).view(n, f, H, D)
        e = F.leaky_relu(score_dst[:n, None, :] + (msg * self.a_src).sum(-1),
                         self.alpha)
        w = graph.edge_weight[: n * f].view(n, f, 1)
        att = torch.softmax(torch.where(w > 0, e, torch.full_like(e, -1e30)),
                            dim=1)
        if drop > 0:
            att = dropout(att, drop, generator)
        red = (att[..., None] * msg).sum(1)                 # [n, H, D]
        return torch.cat([red, red.new_zeros((graph.n_pad - n, H, D))])
