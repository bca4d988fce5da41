"""Architecture registry of the port: ``--arch <id>`` resolves here. Each
module exposes get_config(), smoke_config(), SHAPES and make_cell(shape,
multi_pod), the dry-run `Cell` of a shape: the LM family
(``qwen2-moe-a2.7b``, ``dbrx-132b``, ``llama3-8b``, ``codeqwen1.5-7b``,
``qwen2.5-14b``), the GNN family (``gin-tu``, ``pna``, ``gatedgcn``,
``nequip``), ``xdeepfm``, and beside them ``wcsd-serve``, the paper's
serving cells."""
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


# cells outside the assigned 40 (not yielded by all_cells)
EXTRA_ARCHS = {
    "wcsd-serve": "repro_torch.configs.wcsd_serve",
}


def get_arch(name: str):
    if name in EXTRA_ARCHS:
        return importlib.import_module(EXTRA_ARCHS[name])
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{list(ARCHS) + list(EXTRA_ARCHS)}")
    return importlib.import_module(ARCHS[name])


def all_cells(multi_pod: bool = False):
    """Yield every (arch, shape, Cell) of the 40-cell dry-run matrix."""
    for name in ARCHS:
        mod = get_arch(name)
        for shape in mod.SHAPES:
            yield name, shape, mod.make_cell(shape, multi_pod=multi_pod)
