from .appnp_layer import APPNPProp
from .deepergcn_layer import GENConv, ResGNNLayer
from .gat_layer import GATLayer
from .gcn_layer import GCNLayer
from .gcnii_layer import GCNIILayer
from .gin_layer import GINLayer
from .han_layer import HANLayer
from .mixhop_layer import MixHopLayer
from .mlp import MLP
from .rgcn_layer import RGCNLayer
from .sage_layer import SAGELayer
from .saint_layer import SAINTLayer
from .se_layer import SELayer
from .set2set import Set2Set
from .sgc_layer import SGCLayer
from .utils import CDense, MaskedBatchNorm, get_activation

__all__ = ["APPNPProp", "GENConv", "ResGNNLayer", "GATLayer", "GCNLayer",
           "GCNIILayer", "GINLayer", "HANLayer", "MixHopLayer", "MLP",
           "RGCNLayer", "SAGELayer", "SAINTLayer", "SELayer", "Set2Set",
           "SGCLayer", "CDense", "MaskedBatchNorm", "get_activation"]
