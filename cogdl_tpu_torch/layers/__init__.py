from .gat_layer import GATLayer
from .gcn_layer import GCNLayer
from .sage_layer import SAGELayer
from .utils import CDense, MaskedBatchNorm, get_activation

__all__ = ["GATLayer", "GCNLayer", "SAGELayer", "CDense", "MaskedBatchNorm",
           "get_activation"]
