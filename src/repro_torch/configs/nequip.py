"""nequip [arXiv:2101.03164]: 5 interaction layers, 32 channels, l_max=2,
8 Bessel RBF, cutoff 5.0, E(3) tensor products (Gaunt couplings, no e3nn).
Non-molecular shapes carry synthetic 3D coordinates."""
from ..models.nequip import NequIPConfig
from .gnn_common import GNN_SHAPES, make_nequip_cell

SHAPES = list(GNN_SHAPES)


def get_config() -> NequIPConfig:
    return NequIPConfig("nequip", n_layers=5, channels=32, l_max=2,
                        n_rbf=8, cutoff=5.0)


def smoke_config() -> NequIPConfig:
    return NequIPConfig("nequip-smoke", n_layers=2, channels=8, l_max=2,
                        n_rbf=4, cutoff=5.0, d_feat=4)


def make_cell(shape: str, multi_pod: bool = False):
    return make_nequip_cell(get_config(), shape, multi_pod)
