from .gat_layer import GATLayer
from .gcn_layer import GCNLayer
from .utils import CDense, MaskedBatchNorm, get_activation

__all__ = ["GATLayer", "GCNLayer", "CDense", "MaskedBatchNorm",
           "get_activation"]
