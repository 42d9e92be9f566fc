from .gat_layer import GATLayer
from .gcn_layer import GCNLayer
from .sage_layer import SAGELayer
from .saint_layer import SAINTLayer
from .utils import CDense, MaskedBatchNorm, get_activation

__all__ = ["GATLayer", "GCNLayer", "SAGELayer", "SAINTLayer", "CDense",
           "MaskedBatchNorm", "get_activation"]
