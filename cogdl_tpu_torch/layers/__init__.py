from .appnp_layer import APPNPProp
from .deepergcn_layer import GENConv, ResGNNLayer
from .gat_layer import GATLayer
from .gcn_layer import GCNLayer
from .gcnii_layer import GCNIILayer
from .gin_layer import GINLayer
from .mixhop_layer import MixHopLayer
from .mlp import MLP
from .sage_layer import SAGELayer
from .saint_layer import SAINTLayer
from .se_layer import SELayer
from .sgc_layer import SGCLayer
from .utils import CDense, MaskedBatchNorm, get_activation

__all__ = ["APPNPProp", "GENConv", "ResGNNLayer", "GATLayer", "GCNLayer",
           "GCNIILayer", "GINLayer", "MixHopLayer", "MLP", "SAGELayer",
           "SAINTLayer", "SELayer", "SGCLayer", "CDense", "MaskedBatchNorm",
           "get_activation"]
