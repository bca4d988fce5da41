"""Architecture registry of the port: ``get_arch(name)`` returns the
module of an architecture whose model the port has: the LM family
(``qwen2-moe-a2.7b``, ``dbrx-132b``, ``llama3-8b``, ``codeqwen1.5-7b``,
``qwen2.5-14b``), the GNN family (``gin-tu``, ``pna``, ``gatedgcn``,
``nequip``) and ``xdeepfm``. Each module
exposes get_config(), smoke_config(), SHAPES. The reference's
`make_cell` lowers JAX programs for its dry run and has no counterpart
here."""
from __future__ import annotations

import importlib

ARCHS = {
    # LM family
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "qwen2.5-14b": "repro_torch.configs.qwen25_14b",
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
