"""Vertex ordering strategies (paper §IV-D), a host-side numpy copy of the
reference package's `core/ordering.py`: degree, MDE tree-decomposition,
and the hybrid core/periphery order. Orders are returned as ``order`` arrays
(rank -> vertex id), highest-importance vertex first."""
from __future__ import annotations

import heapq

import numpy as np

from .graph import Graph


def degree_order(g: Graph) -> np.ndarray:
    """Non-ascending degree (ties broken by vertex id for determinism)."""
    deg = g.degree()
    return np.lexsort((np.arange(g.num_nodes), -deg)).astype(np.int32)


def mde_elimination(g: Graph, eliminate: np.ndarray | None = None
                    ) -> np.ndarray:
    """Minimum-degree-elimination sequence (paper Def. 8).

    Repeatedly removes the minimum-degree vertex and adds a clique over its
    neighbors in the transient graph. Returns the elimination sequence
    (first-eliminated first). ``eliminate`` optionally restricts elimination
    to a subset (used by the hybrid order); other vertices are never removed.
    Lazy-heap implementation with adjacency sets."""
    V = g.num_nodes
    adj = [set() for _ in range(V)]
    for v in range(V):
        s, e = g.indptr[v], g.indptr[v + 1]
        adj[v].update(int(x) for x in g.nbr[s:e])
    allowed = np.ones(V, dtype=bool) if eliminate is None else np.asarray(
        eliminate, dtype=bool)
    heap = [(len(adj[v]), v) for v in range(V) if allowed[v]]
    heapq.heapify(heap)
    removed = np.zeros(V, dtype=bool)
    seq = []
    while heap:
        d, v = heapq.heappop(heap)
        if removed[v] or d != len(adj[v]):
            continue  # stale heap entry
        removed[v] = True
        seq.append(v)
        nbrs = [u for u in adj[v] if not removed[u]]
        for u in nbrs:
            adj[u].discard(v)
        # clique fill over the transient neighbors
        for i, a in enumerate(nbrs):
            for b in nbrs[i + 1:]:
                if b not in adj[a]:
                    adj[a].add(b)
                    adj[b].add(a)
        for u in nbrs:
            if allowed[u] and not removed[u]:
                heapq.heappush(heap, (len(adj[u]), u))
    return np.array(seq, dtype=np.int32)


def tree_decomposition_order(g: Graph) -> np.ndarray:
    """Vertex hierarchy via MDE tree decomposition: reverse elimination order
    (the hierarchy root — eliminated last — gets the top rank)."""
    seq = mde_elimination(g)
    return seq[::-1].copy()


def hybrid_order(g: Graph, degree_threshold: int | None = None) -> np.ndarray:
    """Paper's hybrid order: high-degree *core* ranked by degree (cheap,
    effective on scale-free cores), low-degree *periphery* ranked by tree
    decomposition (effective on road-like fringes)."""
    deg = g.degree()
    if degree_threshold is None:
        # default: core = vertices above 4x average degree
        degree_threshold = max(int(4 * deg.mean()), int(np.percentile(deg, 95)))
    core = deg > degree_threshold
    core_ids = np.flatnonzero(core)
    core_sorted = core_ids[np.lexsort((core_ids, -deg[core_ids]))]
    periph_seq = mde_elimination(g, eliminate=~core)
    order = np.concatenate([core_sorted, periph_seq[::-1]]).astype(np.int32)
    assert len(order) == g.num_nodes
    return order


ORDERINGS = {
    "degree": degree_order,
    "treedec": tree_decomposition_order,
    "hybrid": hybrid_order,
}


def make_order(g: Graph, name: str = "degree") -> np.ndarray:
    return ORDERINGS[name](g)
