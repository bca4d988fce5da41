"""Graph data structures for quality-constrained shortest distance (WCSD).

Host-side numpy, a copy of the reference package's `core/graph.py`
(`Graph`, `mutate_edges`, `expand_frontier_csr`). Qualities are canonicalized
to integer *levels*: ``levels`` is the ascending sorted array of distinct
edge qualities, and each edge stores the index of its quality in
``levels``. A query threshold ``w`` maps to the smallest level ``l`` with
``levels[l] >= w``; an edge qualifies iff ``edge_level >= l``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INF_DIST = np.int32(1 << 30)


@dataclasses.dataclass
class Graph:
    """Undirected graph with edge qualities, stored as symmetric CSR.

    Attributes:
      num_nodes: |V|
      indptr: [V+1] CSR row pointers over the symmetrized edge list.
      nbr: [2E] neighbor ids, sorted by source.
      nbr_level: [2E] integer quality level of each half-edge.
      levels: [W] ascending distinct quality values (float64).
      edges_src/edges_dst/edges_level: [2E] flat symmetric edge list
        (same content as CSR).
      version: mutation counter (0 for a freshly built graph).
    """

    num_nodes: int
    indptr: np.ndarray
    nbr: np.ndarray
    nbr_level: np.ndarray
    levels: np.ndarray
    edges_src: np.ndarray
    edges_dst: np.ndarray
    edges_level: np.ndarray
    version: int = 0

    @staticmethod
    def from_edges(num_nodes: int, u: np.ndarray, v: np.ndarray,
                   qual: np.ndarray) -> "Graph":
        """Build from an undirected edge list (each edge listed once)."""
        u = np.asarray(u, dtype=np.int32)
        v = np.asarray(v, dtype=np.int32)
        qual = np.asarray(qual, dtype=np.float64)
        if not (u.shape == v.shape == qual.shape):
            raise ValueError("edge arrays must have matching shapes")
        keep = u != v  # drop self loops
        u, v, qual = u[keep], v[keep], qual[keep]
        levels, edge_level = np.unique(qual, return_inverse=True)
        edge_level = edge_level.astype(np.int32)
        # Deduplicate parallel edges, keeping the best (max) quality level.
        key = u.astype(np.int64) * num_nodes + v
        key2 = v.astype(np.int64) * num_nodes + u
        key = np.minimum(key, key2)  # canonical undirected key
        order = np.lexsort((-edge_level, key))
        key, u, v, edge_level = key[order], u[order], v[order], edge_level[order]
        first = np.ones(len(key), dtype=bool)
        first[1:] = key[1:] != key[:-1]
        u, v, edge_level = u[first], v[first], edge_level[first]

        src = np.concatenate([u, v])
        dst = np.concatenate([v, u])
        lvl = np.concatenate([edge_level, edge_level])
        order = np.lexsort((dst, src))
        src, dst, lvl = src[order], dst[order], lvl[order]
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int64)
        return Graph(num_nodes=num_nodes, indptr=indptr, nbr=dst.astype(np.int32),
                     nbr_level=lvl.astype(np.int32), levels=levels,
                     edges_src=src.astype(np.int32), edges_dst=dst.astype(np.int32),
                     edges_level=lvl.astype(np.int32))

    @property
    def num_levels(self) -> int:
        return int(len(self.levels))

    @property
    def num_edges(self) -> int:
        """Number of undirected edges."""
        return int(len(self.nbr) // 2)

    def degree(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int64)

    def level_of(self, w: float) -> int:
        """Smallest level index l with levels[l] >= w (== num_levels if none)."""
        return int(np.searchsorted(self.levels, w, side="left"))

    def neighbors(self, u: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = int(self.indptr[u]), int(self.indptr[u + 1])
        return self.nbr[s:e], self.nbr_level[s:e]

    def filtered(self, min_level: int) -> "Graph":
        """Subgraph with only edges of level >= min_level (same vertex set,
        same global level table)."""
        half = self.edges_src < self.edges_dst
        keep = half & (self.edges_level >= min_level)
        g = Graph.from_edges(self.num_nodes, self.edges_src[keep],
                             self.edges_dst[keep],
                             self.levels[self.edges_level[keep]])
        return _with_levels(g, self.levels)

    def memory_bytes(self) -> int:
        return int(self.indptr.nbytes + self.nbr.nbytes + self.nbr_level.nbytes
                   + self.edges_src.nbytes + self.edges_dst.nbytes
                   + self.edges_level.nbytes + self.levels.nbytes)

    def padded_adjacency(self, max_deg: Optional[int] = None,
                         pad_node: int = -1):
        """Return ([V, D] neighbor ids, [V, D] levels) padded with sentinel.

        Every row is filled as a prefix (the CSR row, then pads): pad
        neighbor id = pad_node (-1), pad level = -1 (never qualifies).
        Vectorized; same arrays as the reference's per-row loop.
        """
        deg = self.degree()
        D = int(max_deg if max_deg is not None else (deg.max() if len(deg) else 1))
        D = max(D, 1)
        V = self.num_nodes
        nbr_pad = np.full((V, D), pad_node, dtype=np.int32)
        lvl_pad = np.full((V, D), -1, dtype=np.int32)
        lens = np.minimum(deg, D)
        rows = np.repeat(np.arange(V, dtype=np.int64), lens)
        cols = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens)
        src = self.indptr[rows] + cols
        nbr_pad[rows, cols] = self.nbr[src]
        lvl_pad[rows, cols] = self.nbr_level[src]
        return nbr_pad, lvl_pad


def _with_levels(g: Graph, levels: np.ndarray) -> Graph:
    """``g`` re-expressed over the global level table ``levels`` (a superset
    of its own): `from_edges` re-derives the table from the qualities that
    survive, so level indices are mapped back to keep their meaning."""
    if len(g.levels) == len(levels) and np.array_equal(g.levels, levels):
        return g
    lut = np.searchsorted(levels, g.levels).astype(np.int32)
    return dataclasses.replace(
        g, nbr_level=lut[g.nbr_level] if len(g.nbr_level) else g.nbr_level,
        edges_level=lut[g.edges_level] if len(g.edges_level)
        else g.edges_level,
        levels=levels.copy())


def mutate_edges(g: Graph, inserts=(), deletes=()) -> Graph:
    """New `Graph` with ``deletes`` removed and ``inserts`` added/upserted.

    ``inserts`` is an iterable of ``(u, v, quality)``; ``deletes`` of
    ``(u, v)`` (orientation-insensitive). The global level table is kept
    verbatim, so an inserted quality must already be one of ``g.levels``
    (a new quality value re-bins every stored level: rebuild instead).
    Inserting over an existing edge replaces its quality (upsert). The
    result carries ``version = g.version + 1``."""
    half = g.edges_src < g.edges_dst
    u = g.edges_src[half].astype(np.int64)
    v = g.edges_dst[half].astype(np.int64)
    lvl = g.edges_level[half].copy()
    drop = set()
    for a, b in deletes:
        drop.add((min(int(a), int(b)), max(int(a), int(b))))
    ins_u, ins_v, ins_l = [], [], []
    for a, b, q in inserts:
        a, b = int(a), int(b)
        if a == b:
            raise ValueError(f"self loop ({a}, {b}) cannot be inserted")
        li = int(np.searchsorted(g.levels, q, side="left"))
        if li >= len(g.levels) or g.levels[li] != q:
            raise ValueError(
                f"inserted quality {q!r} is not in the graph's level table "
                f"{g.levels.tolist()}; a new quality value re-bins every "
                "label level — rebuild the index instead")
        drop.add((min(a, b), max(a, b)))  # upsert: replace, don't dedup-max
        ins_u.append(a)
        ins_v.append(b)
        ins_l.append(li)
    if drop:
        keys = np.minimum(u, v) * g.num_nodes + np.maximum(u, v)
        drop_keys = np.array([a * g.num_nodes + b for a, b in drop],
                             dtype=np.int64)
        keep = ~np.isin(keys, drop_keys)
        u, v, lvl = u[keep], v[keep], lvl[keep]
    u2 = np.concatenate([u, np.asarray(ins_u, dtype=np.int64)])
    v2 = np.concatenate([v, np.asarray(ins_v, dtype=np.int64)])
    l2 = np.concatenate([lvl, np.asarray(ins_l, dtype=np.int32)])
    g2 = Graph.from_edges(g.num_nodes, u2.astype(np.int32),
                          v2.astype(np.int32), g.levels[l2])
    return dataclasses.replace(_with_levels(g2, g.levels),
                               version=g.version + 1)


def graph_from_arrays(arrays: dict) -> Graph:
    """Rebuild a `Graph` from its fields as numpy arrays (the keys are the
    dataclass field names; ``num_nodes`` and ``version`` may be ints).
    This is how a graph crosses over from another implementation."""
    fields = {f.name for f in dataclasses.fields(Graph)}
    kw = {k: v for k, v in arrays.items() if k in fields}
    kw["num_nodes"] = int(kw["num_nodes"])
    kw["version"] = int(kw.get("version", 0))
    for name, dt in (("indptr", np.int64), ("nbr", np.int32),
                     ("nbr_level", np.int32), ("levels", np.float64),
                     ("edges_src", np.int32), ("edges_dst", np.int32),
                     ("edges_level", np.int32)):
        kw[name] = np.ascontiguousarray(kw[name], dtype=dt)
    return Graph(**kw)


def expand_frontier_csr(g: Graph, nodes: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized CSR expansion: all (src_pos, nbr, level) for edges out of
    ``nodes``. src_pos indexes into ``nodes``. Pure numpy, no python loop."""
    starts = g.indptr[nodes]
    degs = (g.indptr[nodes + 1] - starts).astype(np.int64)
    total = int(degs.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.astype(np.int32), z.astype(np.int32)
    src_pos = np.repeat(np.arange(len(nodes), dtype=np.int64), degs)
    cum = np.concatenate([[0], np.cumsum(degs)[:-1]])
    eidx = np.repeat(starts, degs) + (np.arange(total, dtype=np.int64)
                                      - np.repeat(cum, degs))
    return src_pos, g.nbr[eidx], g.nbr_level[eidx]
