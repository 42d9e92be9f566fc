"""Task wrappers — the port of ``cogdl_tpu/wrappers/__init__.py``. A wrapper
owns the task-specific pieces (data preparation, loss, evaluation); the
Trainer stays task-agnostic. Full-batch node classification and its
sampled forms are ported so far: neighbor sampling on the host and on the
device, ClusterGCN (``cluster``) and GraphSAINT (``graphsaint``); and graph
classification over union batches (``graph_classification``) and over
PATCHY-SAN's receptive fields (``patchy_san``), heterogeneous node
classification over metapath graphs (``heterogeneous_gnn``), manifold
mixup (``gcnmix``), the multi-stage wrappers (``sagn_staged``,
``m3s_staged``, ``correct_smooth``), and the self-supervised ones
(``dgi``, ``grace``, ``graphmae``, ``graphmae2``, ``bgrl``,
``unsup_graphsage``, ``self_auxiliary``, ``infograph``); the rest wait in
ROADMAP.md §1."""

from __future__ import annotations

import importlib
from typing import Dict

SUPPORTED_WRAPPERS: Dict[str, str] = {
    "node_classification":
        "cogdl_tpu_torch.wrappers.node_classification.NodeClfWrapper",
    "neighbor_sampling":
        "cogdl_tpu_torch.wrappers.sampled_node_classification."
        "SampledNodeClfWrapper",
    "neighbor_sampling_device":
        "cogdl_tpu_torch.wrappers.sampled_node_classification."
        "DeviceSampledNodeClfWrapper",
    "cluster":
        "cogdl_tpu_torch.wrappers.sampled_node_classification."
        "ClusterNodeClfWrapper",
    "graphsaint":
        "cogdl_tpu_torch.wrappers.sampled_node_classification."
        "GraphSAINTWrapper",
    "graph_classification":
        "cogdl_tpu_torch.wrappers.graph_classification.GraphClfWrapper",
    "heterogeneous_gnn":
        "cogdl_tpu_torch.wrappers.heterogeneous.HeterogeneousGNNWrapper",
    "gcnmix": "cogdl_tpu_torch.wrappers.node_classification.GCNMixWrapper",
    "patchy_san":
        "cogdl_tpu_torch.wrappers.graph_classification.PatchySANWrapper",
    "sagn_staged": "cogdl_tpu_torch.wrappers.staged.SAGNWrapper",
    "m3s_staged": "cogdl_tpu_torch.wrappers.staged.M3SWrapper",
    "correct_smooth": "cogdl_tpu_torch.wrappers.staged.CorrectSmoothWrapper",
    "dgi": "cogdl_tpu_torch.wrappers.self_supervised.DGIWrapper",
    "grace": "cogdl_tpu_torch.wrappers.self_supervised.GRACEWrapper",
    "graphmae": "cogdl_tpu_torch.wrappers.self_supervised.GraphMAEWrapper",
    "graphmae2": "cogdl_tpu_torch.wrappers.self_supervised.GraphMAE2Wrapper",
    "bgrl": "cogdl_tpu_torch.wrappers.self_supervised.BGRLWrapper",
    "unsup_graphsage":
        "cogdl_tpu_torch.wrappers.self_supervised.UnsupGraphSAGEWrapper",
    "self_auxiliary":
        "cogdl_tpu_torch.wrappers.self_supervised.SelfAuxiliaryWrapper",
    "infograph":
        "cogdl_tpu_torch.wrappers.graph_classification.InfoGraphWrapper",
}

# model name → default wrapper
DEFAULT_WRAPPER = {
    "gcn": "node_classification", "gat": "node_classification",
    "graphsage": "node_classification", "sage": "node_classification",
    "sgc": "node_classification", "appnp": "node_classification",
    "ppnp": "node_classification", "gcnii": "node_classification",
    "mixhop": "node_classification", "mlp": "node_classification",
    "deepergcn": "node_classification", "graphsaint": "graphsaint",
    "drgcn": "node_classification", "drgat": "node_classification",
    "sign": "node_classification", "dropedge_gcn": "node_classification",
    "revgcn": "node_classification", "revgat": "node_classification",
    "revgen": "node_classification", "grand": "node_classification",
    "pprgo": "node_classification", "moe_gcn": "node_classification",
    "robustgcn": "node_classification",
    "gnnguard_gcn": "node_classification",
    "gdc_gcn": "node_classification", "actgcn": "node_classification",
    "autognn": "node_classification", "disengcn": "node_classification",
    "srgcn": "node_classification", "gin": "graph_classification",
    "sortpool": "graph_classification", "diffpool": "graph_classification",
    "han": "heterogeneous_gnn", "gtn": "heterogeneous_gnn",
    "simple_hgn": "heterogeneous_gnn",
    "rgcn": "heterogeneous_gnn", "compgcn": "heterogeneous_gnn",
    "graph_unet": "node_classification", "unet": "node_classification",
    "gcnmix": "gcnmix", "sagn": "sagn_staged", "m3s": "m3s_staged",
    "correct_smooth_mlp": "correct_smooth", "patchy_san": "patchy_san",
    "dgi": "dgi", "grace": "grace", "mvgrl": "dgi", "graphmae": "graphmae",
    "bgrl": "bgrl", "graphmae2": "graphmae2",
    "unsup_graphsage": "unsup_graphsage", "infograph": "infograph",
}


def fetch_wrapper(name: str):
    try:
        path = SUPPORTED_WRAPPERS[name]
    except KeyError:
        raise ValueError(
            f"wrapper {name!r} is not yet ported to cogdl_tpu_torch (ported: "
            f"{sorted(SUPPORTED_WRAPPERS)}); see ROADMAP.md §1") from None
    module_path, cls_name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module_path), cls_name)


def default_wrapper_for(model_name: str) -> str:
    return DEFAULT_WRAPPER.get(model_name, "node_classification")
