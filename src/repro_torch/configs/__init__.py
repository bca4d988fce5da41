"""Architecture registry of the port: ``get_arch(name)`` returns the
module of an architecture whose model the port has: ``xdeepfm`` and the
GNN family (``gin-tu``, ``pna``, ``gatedgcn``, ``nequip``). Each module
exposes get_config(), smoke_config(), SHAPES. The reference's
`make_cell` lowers JAX programs for its dry run and has no counterpart
here."""
from __future__ import annotations

import importlib

ARCHS = {
    # GNN family
    "nequip": "repro_torch.configs.nequip",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "pna": "repro_torch.configs.pna",
    "gin-tu": "repro_torch.configs.gin_tu",
    # RecSys
    "xdeepfm": "repro_torch.configs.xdeepfm_arch",
}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    return importlib.import_module(ARCHS[name])
