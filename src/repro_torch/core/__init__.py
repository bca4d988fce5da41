"""Core of the port: the graph, the WC-Index and its builders, the query
engines and the server (`repro_torch`), with the reference package's
exports (`query_batch_jnp` is `query_batch_torch` here). The names load
with the submodule that defines them, on first use, so that importing
one submodule (`checkpoint.ckpt` imports `core.resilience`) does not pull
in the rest."""
from __future__ import annotations

import importlib

_EXPORTS = {
    "Graph": "graph", "INF_DIST": "graph",
    "PackedLabels": "wc_index", "PackedLabelsBuilder": "wc_index",
    "PackedWCIndex": "wc_index", "WCIndex": "wc_index",
    "build_wc_index": "wc_index",
    "build_wc_index_batched": "wc_index_batched",
    "build_wc_index_batched_packed": "wc_index_batched",
    "clean_index": "wc_index_batched",
    "make_order": "ordering", "degree_order": "ordering",
    "tree_decomposition_order": "ordering", "hybrid_order": "ordering",
    "DeviceQueryEngine": "query", "PendingResult": "query",
    "QuerySubBatch": "query", "ShardedQueryEngine": "query",
    "plan_query_batch": "query", "query_batch_torch": "query",
    "WCSDServer": "serve",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
