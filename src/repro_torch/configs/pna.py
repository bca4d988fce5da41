"""pna [arXiv:2004.05718]: 4L d=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation."""
from ..models.gnn import GNNConfig
from .gnn_common import GNN_SHAPES, make_gnn_cell

SHAPES = list(GNN_SHAPES)


def get_config() -> GNNConfig:
    return GNNConfig("pna", "pna", n_layers=4, d_hidden=75,
                     d_feat=16, n_classes=2)


def smoke_config() -> GNNConfig:
    return GNNConfig("pna-smoke", "pna", n_layers=2, d_hidden=15,
                     d_feat=8, n_classes=3)


def make_cell(shape: str, multi_pod: bool = False):
    return make_gnn_cell(get_config(), shape, multi_pod, arch_name="pna")
