"""Helpers shared by the parity tests of the PyTorch port
(`tests/test_torch_*.py`): carry a reference (JAX-package) graph or index
across to the port as plain numpy arrays, and compare results exactly."""
from __future__ import annotations

import dataclasses

import numpy as np


def graph_arrays(g) -> dict:
    """A reference `Graph` as a dict of its fields."""
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


def port_graph(g):
    from repro_torch.core.graph import graph_from_arrays
    return graph_from_arrays(graph_arrays(g))


def index_arrays(idx, lane: int = 128) -> dict:
    """A reference `WCIndex` / `PackedWCIndex` as the arrays
    `repro_torch.core.wc_index.packed_index_from_arrays` takes."""
    p = idx.packed(lane=lane)
    return {"order": idx.order, "rank": idx.rank, "levels": idx.levels,
            "hub_rank": p.hub_rank, "dist": p.dist, "wlev": p.wlev,
            "offsets": p.offsets, "lane": lane}


def port_index(idx, lane: int = 128):
    from repro_torch.core.wc_index import packed_index_from_arrays
    return packed_index_from_arrays(index_arrays(idx, lane=lane))


def assert_same_array(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_fields(x, y, names):
    for n in names:
        assert_same_array(getattr(x, n), getattr(y, n), n)


PACKED_FIELDS = ("hub_rank", "dist", "wlev", "offsets", "bucket_widths",
                 "bucket_of", "slot_of")
ARENA_FIELDS = ("hub", "dist", "wlev", "tile_base", "tile_cnt", "tile_lo",
                "tile_hi")
GRAPH_FIELDS = ("indptr", "nbr", "nbr_level", "levels", "edges_src",
                "edges_dst", "edges_level")
