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


# ----------------------------------------- rows for the merge-join kernels
DEV_INF = 1 << 29
INF_DIST = 1 << 30
# "store": rows as the label store writes them; "duplicates": the same
# with long runs of one hub (Pareto entries); the rest break what a merge
# join relies on: "live-pad" (the first pad of every row feasible, with a
# short distance and a level >= 0), "mid-row-pad" (an inert pad between
# real cells), "descending" (two adjacent real cells out of hub order),
# "pads-only" (no real cell at all)
ROW_CASES = ("store", "duplicates", "live-pad", "mid-row-pad", "descending",
             "pads-only")


def label_rows(rng, n: int, W: int, case: str, top_level: int = 4):
    """[n, W] int32 (hub, dist, wlev) label rows. "store": k real cells
    (hub ranks non-decreasing, repeats allowed; distances 10-999, levels
    0..``top_level``) followed by pads (hub -1, dist INF_DIST, wlev -1),
    k drawn per row; the other `ROW_CASES` as described there."""
    hubs = max(2, W // 6) if case == "duplicates" else 4 * W
    lo_k = 2 if case in ("mid-row-pad", "descending") else 0
    hi_k = W if case == "live-pad" else W + 1      # live-pad: room for a pad
    hub = np.full((n, W), -1, np.int32)
    dist = np.full((n, W), INF_DIST, np.int32)
    wlev = np.full((n, W), -1, np.int32)
    for r in range(n):
        k = 0 if case == "pads-only" else int(rng.integers(min(lo_k, W),
                                                           max(hi_k, 1)))
        hub[r, :k] = np.sort(rng.integers(0, hubs, k))
        dist[r, :k] = rng.integers(10, 1000, k)
        wlev[r, :k] = rng.integers(0, top_level + 1, k)
    real = (hub >= 0).sum(1)
    for r in range(n):
        k = int(real[r])
        if case == "live-pad" and k < W:
            dist[r, k], wlev[r, k] = rng.integers(0, 5), top_level
        elif case == "mid-row-pad" and k >= 2:
            p = int(rng.integers(0, k - 1))
            hub[r, p], dist[r, p], wlev[r, p] = -1, INF_DIST, -1
        elif case == "descending":
            up = np.flatnonzero(hub[r, 1:k] > hub[r, :k - 1])
            if len(up):
                p = int(rng.choice(up))
                for a in (hub, dist, wlev):
                    a[r, [p, p + 1]] = a[r, [p + 1, p]]
    return hub, dist, wlev


def gathered_rows(rng, B: int, L: int, case: str, top_level: int = 4):
    """K9's inputs (hs, ds, ht, dt), [B, L] int32 each, made from
    `label_rows` of both sides as `kernels.ops.gather_padded_rows` makes
    them from the padded store: distances clamped to DEV_INF, and DEV_INF
    where a cell's level is below the query's (drawn in 0..top_level; a
    pad's level is -1). A "live-pad" row's first pad keeps its short
    distance, so the pad-pad meet is the answer."""
    w = rng.integers(0, top_level + 1, B)[:, None]
    out = []
    for _ in range(2):
        h, d, wl = label_rows(rng, B, L, case, top_level)
        out += [h, np.where(wl >= w, np.minimum(d, DEV_INF),
                            DEV_INF).astype(np.int32)]
    return tuple(out)


def tile_spans(hub, wlev):
    """[T] (tile_lo, tile_hi) of arena tiles: the min and max hub of the
    cells that can reach a bin (real cells, and pads with a level >= 0),
    -1 where there are none, as the store's pads-only tile would have.
    An item whose spans are disjoint then has no meet that bins, so the
    kernels' early exit keeps the answer of a join of every item."""
    live = (hub >= 0) | (wlev >= 0)
    big = np.iinfo(np.int32).max
    lo = np.where(live, hub, big).min(1)
    hi = np.where(live, hub, -big).max(1)
    none = ~live.any(1)
    return (np.where(none, -1, lo).astype(np.int32),
            np.where(none, -1, hi).astype(np.int32))


def ragged_items(rng, Q: int, T: int, length: int, per_query: int = 4):
    """A query-major ragged worklist of ``length`` items over T tiles, as
    the reference's `emit_ragged_worklist` lays one out: 1..per_query
    items a query (any tiles), then pads on the trash row Q with tile 0 on
    both sides (at least one). Returns int32 (qidx, stile, ttile,
    first)."""
    qidx = np.repeat(np.arange(Q), rng.integers(1, per_query + 1, Q))
    n = len(qidx)
    pads = length - n
    assert pads >= 1, (length, n)
    qidx = np.concatenate([qidx, np.full(pads, Q)])
    stile = np.concatenate([rng.integers(0, T, n), np.zeros(pads, int)])
    ttile = np.concatenate([rng.integers(0, T, n), np.zeros(pads, int)])
    first = np.concatenate([[1], qidx[1:] != qidx[:-1]])
    return tuple(a.astype(np.int32) for a in (qidx, stile, ttile, first))



def compressed_rows(hub, dist, wlev, tile_lo, dtype: str = "bfloat16"):
    """Arena tiles [T, W] int32 (hub, dist, wlev) in the compressed arena's
    format (`CompressedArena`): hub delta ``hub - tile_lo[t]`` as int16,
    -1 for a pad; the distance rounded to ``dtype`` ("bfloat16" or
    "float16"), as uint16 bit patterns, +inf where it is >= DEV_INF (the
    INF_DIST pads); wlev as int8. A live pad keeps its finite distance
    and its level."""
    from repro_torch.core.wc_index import float16_bits
    delta = np.where(hub < 0, -1, hub.astype(np.int64) - tile_lo[:, None])
    assert delta.max(initial=-1) <= np.iinfo(np.int16).max
    d = np.where(dist >= DEV_INF, np.inf, dist.astype(np.float64))
    return (delta.astype(np.int16), float16_bits(d, dtype),
            wlev.astype(np.int8))
