"""Graph data structures for quality-constrained shortest distance (WCSD).

Host-side numpy, a copy of the reference package's `core/graph.py` (the
parts the port's build and serve path need). Qualities are canonicalized
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
