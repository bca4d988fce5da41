"""Pure host oracle for WCSD: constrained BFS, deliberately simple
(deque-based) so it is an independent check on the index and the device
engines. Used for spot checks of answers served from the card, and of the
single-root relaxation rounds (`wcsd_bfs_all`); `wcsd_all_dists` and
`pareto_dists` are the reference package's vectorized frontier forms."""
from __future__ import annotations

from collections import deque

import numpy as np

from .graph import Graph, INF_DIST, expand_frontier_csr


def wcsd_bfs(g: Graph, s: int, t: int, w_level: int) -> int:
    """w-constrained distance via textbook BFS (paper Algorithm 1)."""
    if s == t:
        return 0
    if w_level >= g.num_levels:
        return int(INF_DIST)
    visited = np.zeros(g.num_nodes, dtype=bool)
    visited[s] = True
    q = deque([s])
    dist = 0
    while q:
        dist += 1
        for _ in range(len(q)):
            u = q.popleft()
            beg, end = g.indptr[u], g.indptr[u + 1]
            for v, lvl in zip(g.nbr[beg:end], g.nbr_level[beg:end]):
                if lvl < w_level or visited[v]:
                    continue
                if v == t:
                    return dist
                visited[v] = True
                q.append(int(v))
    return int(INF_DIST)


def wcsd_bfs_all(g: Graph, s: int, w_level: int) -> np.ndarray:
    """[V] w-constrained distances from ``s`` to every vertex: the BFS of
    `wcsd_bfs` run to exhaustion (INF_DIST where unreachable; only ``s``
    itself is reached at ``w_level >= num_levels``)."""
    out = np.full(g.num_nodes, INF_DIST, dtype=np.int32)
    out[s] = 0
    if w_level >= g.num_levels:
        return out
    q = deque([s])
    dist = 0
    while q:
        dist += 1
        for _ in range(len(q)):
            u = q.popleft()
            beg, end = g.indptr[u], g.indptr[u + 1]
            for v, lvl in zip(g.nbr[beg:end], g.nbr_level[beg:end]):
                if lvl < w_level or out[v] != INF_DIST:
                    continue
                out[v] = dist
                q.append(int(v))
    return out


def wcsd_all_dists(g: Graph, s: int, w_level: int) -> np.ndarray:
    """All w-constrained distances from s (vectorized frontier BFS); the
    same array as `wcsd_bfs_all`."""
    dist = np.full(g.num_nodes, INF_DIST, dtype=np.int32)
    dist[s] = 0
    if w_level >= g.num_levels:
        return dist
    frontier = np.array([s], dtype=np.int32)
    d = 0
    while len(frontier):
        d += 1
        _, nbrs, lvls = expand_frontier_csr(g, frontier)
        nbrs = nbrs[lvls >= w_level]
        nbrs = nbrs[dist[nbrs] == INF_DIST]
        if len(nbrs) == 0:
            break
        frontier = np.unique(nbrs)
        dist[frontier] = d
    return dist


def pareto_dists(g: Graph, s: int) -> np.ndarray:
    """[V, W] matrix: D[v, l] = l-constrained distance from s to v, for
    every level l (the per-(s, v) Pareto frontier of (distance, quality)
    is the set of (D[v, l], l) with D strictly decreasing as l falls)."""
    W = g.num_levels
    out = np.full((g.num_nodes, W), INF_DIST, dtype=np.int32)
    for lev in range(W):
        out[:, lev] = wcsd_all_dists(g, s, lev)
    return out
