"""Model registry — the port of ``cogdl_tpu/models/__init__.py`` — and the
weight bridge from the JAX package's flax parameters.

``gcn``, ``gat``, ``graphsage`` (alias ``sage``), ``graphsaint`` and the
full-batch node-classification models ``gcnii``, ``appnp`` (alias
``ppnp``), ``mixhop``, ``sgc``, ``mlp``, ``deepergcn``, ``drgcn``,
``drgat``, ``sign``, ``dropedge_gcn``, ``revgcn``, ``revgat``, ``revgen``,
``grand``, ``pprgo``, ``moe_gcn``, ``robustgcn``, ``gnnguard_gcn``,
``gdc_gcn``, ``actgcn``, ``autognn``, ``disengcn`` and ``srgcn``, the
graph classification models ``gin``, ``sortpool`` and ``diffpool``, and the
heterogeneous models ``han``, ``gtn``, ``rgcn``, ``compgcn`` and
``simple_hgn``, and the node-classification stragglers ``graph_unet``
(alias ``unet``), ``gcnmix``, ``sagn``, ``m3s``, ``correct_smooth_mlp``
and ``patchy_san``, are ported so far; every other name of the JAX registry waits in ROADMAP.md §1
("Modules to port").
"""

from __future__ import annotations

import importlib
import inspect
from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.nn import Embedding, LayerNorm, Module

SUPPORTED_MODELS: Dict[str, str] = {
    "gcn": "cogdl_tpu_torch.models.nn.gcn.GCN",
    "gat": "cogdl_tpu_torch.models.nn.gat.GAT",
    "graphsage": "cogdl_tpu_torch.models.nn.graphsage.GraphSAGE",
    "sage": "cogdl_tpu_torch.models.nn.graphsage.GraphSAGE",
    "graphsaint": "cogdl_tpu_torch.models.nn.graphsaint.GraphSAINT",
    "sgc": "cogdl_tpu_torch.models.nn.sgc.SGC",
    "ppnp": "cogdl_tpu_torch.models.nn.appnp.APPNP",
    "appnp": "cogdl_tpu_torch.models.nn.appnp.APPNP",
    "gcnii": "cogdl_tpu_torch.models.nn.gcnii.GCNII",
    "mixhop": "cogdl_tpu_torch.models.nn.mixhop.MixHop",
    "mlp": "cogdl_tpu_torch.models.nn.mlp.MLPModel",
    "deepergcn": "cogdl_tpu_torch.models.nn.deepergcn.DeeperGCN",
    "drgcn": "cogdl_tpu_torch.models.nn.drgcn.DrGCN",
    "drgat": "cogdl_tpu_torch.models.nn.drgcn.DrGAT",
    "sign": "cogdl_tpu_torch.models.nn.sign.SIGN",
    "dropedge_gcn": "cogdl_tpu_torch.models.nn.dropedge_gcn.DropEdgeGCN",
    "revgcn": "cogdl_tpu_torch.models.nn.revgcn.RevGCN",
    "revgat": "cogdl_tpu_torch.models.nn.revgcn.RevGAT",
    "revgen": "cogdl_tpu_torch.models.nn.revgcn.RevGEN",
    "grand": "cogdl_tpu_torch.models.nn.grand.Grand",
    "pprgo": "cogdl_tpu_torch.models.nn.pprgo.PPRGo",
    "moe_gcn": "cogdl_tpu_torch.models.nn.moe_gcn.MoEGCN",
    "robustgcn": "cogdl_tpu_torch.models.nn.robustgcn.RobustGCN",
    "gnnguard_gcn": "cogdl_tpu_torch.models.nn.gnnguard.GNNGuardGCN",
    "gdc_gcn": "cogdl_tpu_torch.models.nn.gdc_gcn.GDCGCN",
    "actgcn": "cogdl_tpu_torch.models.nn.actgcn.ActGCN",
    "autognn": "cogdl_tpu_torch.models.nn.autognn.AutoGNN",
    "disengcn": "cogdl_tpu_torch.models.nn.disengcn.DisenGCN",
    "srgcn": "cogdl_tpu_torch.models.nn.srgcn.SRGCN",
    "gin": "cogdl_tpu_torch.models.nn.gin.GIN",
    "sortpool": "cogdl_tpu_torch.models.nn.sortpool.SortPool",
    "diffpool": "cogdl_tpu_torch.models.nn.diffpool.DiffPool",
    "rgcn": "cogdl_tpu_torch.models.nn.rgcn.RGCN",
    "compgcn": "cogdl_tpu_torch.models.nn.compgcn.CompGCN",
    "han": "cogdl_tpu_torch.models.nn.han.HAN",
    "gtn": "cogdl_tpu_torch.models.nn.gtn.GTN",
    "simple_hgn": "cogdl_tpu_torch.models.nn.simple_hgn.SimpleHGN",
    "graph_unet": "cogdl_tpu_torch.models.nn.graph_unet.GraphUnet",
    "unet": "cogdl_tpu_torch.models.nn.graph_unet.GraphUnet",
    "gcnmix": "cogdl_tpu_torch.models.nn.gcnmix.GCNMix",
    "sagn": "cogdl_tpu_torch.models.nn.sagn.SAGN",
    "m3s": "cogdl_tpu_torch.models.nn.m3s.M3S",
    "correct_smooth_mlp":
        "cogdl_tpu_torch.models.nn.correct_smooth.CorrectSmoothMLP",
    "patchy_san": "cogdl_tpu_torch.models.nn.patchy_san.PatchySAN",
}
# (torch.nn is imported by name: the subpackage ``models.nn`` would shadow it)


def build_model(name: str, **kwargs) -> Any:
    """Instantiate a registered model by name. Keyword arguments the model
    does not declare are dropped, as in the JAX package (a shared
    hyper-parameter such as ``hidden_size`` is ignored by models without
    it)."""
    try:
        path = SUPPORTED_MODELS[name]
    except KeyError:
        raise ValueError(
            f"model {name!r} is not yet ported to cogdl_tpu_torch (ported: "
            f"{sorted(SUPPORTED_MODELS)}); the rest wait in ROADMAP.md §1, "
            "'Modules to port'") from None
    module_path, cls_name = path.rsplit(".", 1)
    cls = getattr(importlib.import_module(module_path), cls_name)
    accepted = set(inspect.signature(cls.__init__).parameters)
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})


def load_jax_params(model: Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> Module:
    """Fill ``model`` in place from the JAX package's flax variables, given
    as nested dicts of arrays (``variables["params"]`` and, for batch norm,
    ``variables["batch_stats"]``).

    The module paths are the same in both packages (``layer0/linear`` ↔
    ``layer0.linear``, ``layer0/W`` ↔ ``layer0.W``, GraphSAGE's
    ``layer0/W_self`` ↔ ``layer0.W_self``). A flax ``kernel`` is
    [in, out] and becomes the transposed torch ``weight`` [out, in]; a
    flax ``Conv`` kernel [k, in, out] becomes a ``Conv1d`` ``weight`` [out,
    in, k] by an explicit permutation (PATCHY-SAN's ``conv1``, ``conv2``); a
    LayerNorm ``scale`` and an ``nn.Embed`` ``embedding`` (CompGCN's
    ``ent``) become the torch module's ``weight``; every other leaf keeps its
    name and shape (GAT's ``a_src``/``a_dst`` [1, H, D]). Raises if a parameter of the
    model is left unfilled or a leaf has no place in it."""
    state: Dict[str, torch.Tensor] = {}

    def _submodule(path: str):
        try:
            return model.get_submodule(path)
        except AttributeError:   # a leaf with no place: reported below
            return None

    def walk(tree: Mapping, prefix: str, is_params: bool):
        for key, value in tree.items():
            path = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, path + ".", is_params)
                continue
            t = torch.from_numpy(np.array(value, dtype=np.float32))
            mod_path, _, leaf = path.rpartition(".")
            if is_params and leaf == "kernel" and t.ndim == 3:
                # a flax Conv kernel [k, in, out] is torch's [out, in, k]
                state[f"{mod_path}.weight"] = t.permute(2, 1, 0).contiguous()
            elif is_params and leaf == "kernel":
                state[f"{mod_path}.weight"] = t.T.contiguous()
            elif is_params and isinstance(_submodule(mod_path), {
                    "scale": LayerNorm, "embedding": Embedding}.get(
                        leaf, ())):
                state[f"{mod_path}.weight"] = t
            else:
                state[path] = t

    walk(params, "", True)
    if batch_stats is not None:
        walk(batch_stats, "", False)
    result = model.load_state_dict(state, strict=False)
    param_names = {n for n, _ in model.named_parameters()}
    missing = [k for k in result.missing_keys if k in param_names]
    if missing or result.unexpected_keys:
        raise KeyError(f"load_jax_params: unfilled parameters {missing}, "
                       f"leaves with no place {result.unexpected_keys}")
    return model
