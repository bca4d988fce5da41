"""gin-tu [arXiv:1810.00826]: 5L d=64, sum aggregator, learnable eps."""
from ..models.gnn import GNNConfig
from .gnn_common import GNN_SHAPES, make_gnn_cell

SHAPES = list(GNN_SHAPES)


def get_config() -> GNNConfig:
    return GNNConfig("gin-tu", "gin", n_layers=5, d_hidden=64,
                     d_feat=16, n_classes=2, learnable_eps=True)


def smoke_config() -> GNNConfig:
    return GNNConfig("gin-smoke", "gin", n_layers=2, d_hidden=16,
                     d_feat=8, n_classes=3)


def make_cell(shape: str, multi_pod: bool = False):
    return make_gnn_cell(get_config(), shape, multi_pod, arch_name="gin-tu")
