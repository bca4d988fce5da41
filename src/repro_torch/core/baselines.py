"""Baseline solutions the paper evaluates against (§III, §VI), host
numpy, a copy of the reference package's `core/baselines.py`:

  C-BFS     constrained BFS on the original graph (Algorithm 1)
  W-BFS     pre-partition the graph per quality level, BFS the partition
  Dijkstra  constrained Dijkstra (priority queue; supports weighted edges)
  Naive     |w| separate classical 2-hop (PLL) indices, one per level
  LCR-adapt label-constrained-reachability adaptation: per-level 2-hop
            *reachability* index used to short-circuit unreachable queries,
            falling back to constrained BFS for the distance.

`constrained_distance_grid` is the exact oracle of the dynamic index's
tests and of the chaos harness (`checkpoint/fault.py`).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .graph import Graph, INF_DIST
from .ref import wcsd_bfs
from .wc_index import WCIndex, build_wc_index


# --------------------------------------------------------------------- C-BFS
def cbfs_query(g: Graph, s: int, t: int, w_level: int) -> int:
    """Constrained BFS on the original graph (paper Algorithm 1)."""
    return wcsd_bfs(g, s, t, w_level)


# --------------------------------------------------------------------- W-BFS
@dataclasses.dataclass
class WBFS:
    """Graph partitioned by quality level; query runs plain BFS on the
    partition for its level (paper baseline 'W-BFS')."""
    subgraphs: list[Graph]

    @staticmethod
    def build(g: Graph) -> "WBFS":
        return WBFS(subgraphs=[g.filtered(l) for l in range(g.num_levels)])

    def query(self, s: int, t: int, w_level: int) -> int:
        if w_level >= len(self.subgraphs):
            return 0 if s == t else int(INF_DIST)
        # plain BFS: every edge of the partition already satisfies the level
        return wcsd_bfs(self.subgraphs[w_level], s, t, 0)

    def memory_bytes(self) -> int:
        return sum(sg.memory_bytes() for sg in self.subgraphs)


# ------------------------------------------------------------------ Dijkstra
def dijkstra_query(g: Graph, s: int, t: int, w_level: int,
                   edge_len: np.ndarray | None = None) -> float:
    """Constrained Dijkstra. With edge_len=None all edges have length 1
    (mirrors the paper's unweighted comparison); pass lengths for the
    weighted-graph extension (paper §V)."""
    if s == t:
        return 0
    dist = {s: 0.0}
    pq = [(0.0, s)]
    done = set()
    while pq:
        d, u = heapq.heappop(pq)
        if u in done:
            continue
        if u == t:
            return d
        done.add(u)
        beg, end = g.indptr[u], g.indptr[u + 1]
        for i in range(beg, end):
            v, lvl = int(g.nbr[i]), int(g.nbr_level[i])
            if lvl < w_level or v in done:
                continue
            w = 1.0 if edge_len is None else float(edge_len[i])
            nd = d + w
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return int(INF_DIST)


def constrained_distance_grid(g: Graph) -> np.ndarray:
    """[V, V, W+1] exact constrained distances for the FULL (s, t, w_level)
    grid, via per-level BFS from every source on the level-filtered graph.

    The differential-test oracle on small instances: one BFS sweep per
    (level, source) is W·V times cheaper than V²·W single-pair calls, and
    the implementation shares nothing with the index/query paths under
    test. Level W (above every edge quality) is included: only s == t is
    reachable there."""
    V, W = g.num_nodes, g.num_levels
    out = np.full((V, V, W + 1), INF_DIST, dtype=np.int32)
    src_all = np.repeat(np.arange(V, dtype=np.int64), np.diff(g.indptr))
    for level in range(W + 1):
        keep = g.nbr_level >= level
        deg = np.bincount(src_all[keep], minlength=V)
        indptr = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        nbr = g.nbr[keep]
        for s in range(V):
            dist = out[s, :, level]
            dist[s] = 0
            frontier = np.array([s], dtype=np.int64)
            d = 0
            while len(frontier):
                d += 1
                nxt = np.concatenate([nbr[indptr[u]:indptr[u + 1]]
                                      for u in frontier])
                nxt = np.unique(nxt)
                nxt = nxt[dist[nxt] == INF_DIST]
                dist[nxt] = d
                frontier = nxt
    return out


# ------------------------------------------------------ Naive per-w 2-hop
def _single_level_graph(g: Graph, min_level: int) -> Graph:
    """Filtered subgraph with qualities collapsed to one level, so that
    build_wc_index degenerates to classical PLL."""
    half = g.edges_src < g.edges_dst
    keep = half & (g.edges_level >= min_level)
    u, v = g.edges_src[keep], g.edges_dst[keep]
    return Graph.from_edges(g.num_nodes, u, v, np.ones(len(u)))


@dataclasses.dataclass
class NaiveIndex:
    """|w| separate classical PLL indices (paper §III 'Naïve 2-hop')."""
    per_level: list[WCIndex]
    levels: np.ndarray

    @staticmethod
    def build(g: Graph, ordering: str = "degree") -> "NaiveIndex":
        idxs = [build_wc_index(_single_level_graph(g, l), ordering=ordering)
                for l in range(g.num_levels)]
        return NaiveIndex(per_level=idxs, levels=g.levels.copy())

    def query(self, s: int, t: int, w_level: int) -> int:
        if w_level >= len(self.per_level):
            return 0 if s == t else int(INF_DIST)
        return self.per_level[w_level].query_one(s, t, 0)

    def query_batch(self, s, t, w_level) -> np.ndarray:
        out = np.full(len(s), INF_DIST, dtype=np.int32)
        for l in range(len(self.per_level)):
            m = w_level == l
            if m.any():
                out[m] = self.per_level[l].query_batch(s[m], t[m],
                                                       np.zeros(m.sum(),
                                                                np.int32))
        m = w_level >= len(self.per_level)
        if m.any():
            out[m] = np.where(s[m] == t[m], 0, INF_DIST)
        return out

    def size_entries(self) -> int:
        return sum(i.size_entries() for i in self.per_level)

    def memory_bytes(self) -> int:
        return sum(i.memory_bytes() for i in self.per_level)


# ----------------------------------------------------------------- LCR-adapt
@dataclasses.dataclass
class LCRAdapt:
    """Label-constrained-reachability adaptation: per level, a 2-hop
    *reachability* labeling (hub sets only). A query first checks
    reachability through the hubs; unreachable -> INF immediately, else the
    distance is computed by constrained BFS. Mirrors how an LCR oracle would
    be (mis)used for WCSD — it lacks distances, which is the paper's point."""
    hubsets: list[tuple[np.ndarray, np.ndarray, np.ndarray]]  # per level CSR
    graph: Graph

    @staticmethod
    def build(g: Graph, ordering: str = "degree") -> "LCRAdapt":
        hubsets = []
        for l in range(g.num_levels):
            idx = build_wc_index(_single_level_graph(g, l), ordering=ordering)
            # compress labels to hub sets (reachability only)
            counts = idx.count
            indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            hubs = np.empty(int(counts.sum()), dtype=np.int32)
            for v in range(idx.num_nodes):
                hubs[indptr[v]:indptr[v + 1]] = idx.hub_rank[v, :counts[v]]
            hubsets.append((indptr, hubs, idx.rank))
        return LCRAdapt(hubsets=hubsets, graph=g)

    def query(self, s: int, t: int, w_level: int) -> int:
        if s == t:
            return 0
        if w_level >= len(self.hubsets):
            return int(INF_DIST)
        indptr, hubs, _ = self.hubsets[w_level]
        hs = hubs[indptr[s]:indptr[s + 1]]
        ht = hubs[indptr[t]:indptr[t + 1]]
        if not np.intersect1d(hs, ht, assume_unique=True).size:
            return int(INF_DIST)
        return wcsd_bfs(self.graph, s, t, w_level)

    def memory_bytes(self) -> int:
        return sum(ip.nbytes + h.nbytes for ip, h, _ in self.hubsets)
