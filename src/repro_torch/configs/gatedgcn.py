"""gatedgcn [arXiv:2003.00982]: 16L d=70, gated aggregator with edge
features."""
from ..models.gnn import GNNConfig
from .gnn_common import GNN_SHAPES, make_gnn_cell

SHAPES = list(GNN_SHAPES)


def get_config() -> GNNConfig:
    return GNNConfig("gatedgcn", "gatedgcn", n_layers=16, d_hidden=70,
                     d_feat=16, n_classes=2, d_edge=1)


def smoke_config() -> GNNConfig:
    return GNNConfig("gatedgcn-smoke", "gatedgcn", n_layers=2, d_hidden=14,
                     d_feat=8, n_classes=3, d_edge=1)


def make_cell(shape: str, multi_pod: bool = False):
    return make_gnn_cell(get_config(), shape, multi_pod, arch_name="gatedgcn")
