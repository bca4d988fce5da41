"""Synthetic graph generators: road-like grids and Barabási–Albert
scale-free graphs, with qualities drawn from |w| distinct levels.

Host-side numpy. The same seeds give byte-identical graphs to the
reference package's `core/generators.py`; `scale_free` reproduces
networkx's `barabasi_albert_graph` (networkx 3.6.1) in pure Python, so
the port does not need networkx.
"""
from __future__ import annotations

import random

import numpy as np

from .graph import Graph


def _assign_qualities(num_edges: int, num_levels: int, rng: np.random.Generator,
                      skew: float = 0.0) -> np.ndarray:
    """Draw per-edge qualities from ``num_levels`` distinct values.

    skew=0 -> uniform over levels; skew>0 -> zipf-ish bias to low levels."""
    vals = np.arange(1.0, num_levels + 1.0)  # quality values 1..W
    if skew <= 0:
        probs = np.full(num_levels, 1.0 / num_levels)
    else:
        probs = 1.0 / (np.arange(1, num_levels + 1) ** skew)
        probs /= probs.sum()
    return rng.choice(vals, size=num_edges, p=probs)


def road_grid(rows: int, cols: int, num_levels: int = 5, diag_prob: float = 0.05,
              seed: int = 0) -> Graph:
    """Road-network-like graph: rows×cols grid + sparse diagonal shortcuts."""
    rng = np.random.default_rng(seed)
    idx = np.arange(rows * cols).reshape(rows, cols)
    us, vs = [], []
    us.append(idx[:, :-1].ravel()); vs.append(idx[:, 1:].ravel())   # horizontal
    us.append(idx[:-1, :].ravel()); vs.append(idx[1:, :].ravel())   # vertical
    if diag_prob > 0:
        du, dv = idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()
        m = rng.random(len(du)) < diag_prob
        us.append(du[m]); vs.append(dv[m])
    u = np.concatenate(us); v = np.concatenate(vs)
    qual = _assign_qualities(len(u), num_levels, rng)
    return Graph.from_edges(rows * cols, u, v, qual)


def barabasi_albert_edges(n: int, m: int, seed: int) -> np.ndarray:
    """[E, 2] edge list of networkx's ``barabasi_albert_graph(n, m, seed)``
    in the order its ``G.edges()`` yields them.

    networkx grows a star on m + 1 nodes, then attaches each new node to m
    distinct targets drawn by ``random.Random(seed).choice`` over the list
    of nodes repeated once per incident edge, collecting them in a `set`.
    `G.edges()` walks nodes in insertion order and each node's neighbors
    in insertion order, yielding every edge the first time it is seen."""
    if m < 1 or m >= n:
        raise ValueError(f"Barabási–Albert network must have m >= 1 and "
                         f"m < n, m = {m}, n = {n}")
    rng = random.Random(seed)
    adj: list[list[int]] = [[] for _ in range(n)]
    for spoke in range(1, m + 1):            # star graph: hub 0, spokes 1..m
        adj[0].append(spoke)
        adj[spoke].append(0)
    repeated = [0] * m + list(range(1, m + 1))
    for source in range(m + 1, n):
        targets = set()
        while len(targets) < m:
            targets.add(rng.choice(repeated))
        for tgt in targets:
            adj[source].append(tgt)
            adj[tgt].append(source)
        repeated.extend(targets)
        repeated.extend([source] * m)
    # node insertion order is 0..n-1; an edge (u, v) is yielded from the
    # endpoint visited first, i.e. the smaller id
    edges = [(u, v) for u in range(n) for v in adj[u] if v > u]
    return np.array(edges, dtype=np.int32).reshape(-1, 2)


def scale_free(num_nodes: int, m: int = 4, num_levels: int = 3,
               seed: int = 0, skew: float = 0.8) -> Graph:
    """Barabási–Albert scale-free graph (social-network-like)."""
    e = barabasi_albert_edges(num_nodes, m, seed)
    rng = np.random.default_rng(seed + 1)
    qual = _assign_qualities(len(e), num_levels, rng, skew=skew)
    return Graph.from_edges(num_nodes, e[:, 0], e[:, 1], qual)


def erdos_renyi(num_nodes: int, avg_degree: float = 6.0, num_levels: int = 5,
                seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    num_edges = int(num_nodes * avg_degree / 2)
    u = rng.integers(0, num_nodes, size=num_edges)
    v = rng.integers(0, num_nodes, size=num_edges)
    keep = u != v
    u, v = u[keep], v[keep]
    qual = _assign_qualities(len(u), num_levels, rng)
    return Graph.from_edges(num_nodes, u, v, qual)


def random_queries(g: Graph, n: int, seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(s, t, w_level) triples with w_level in [0, num_levels)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, g.num_nodes, size=n).astype(np.int32)
    t = rng.integers(0, g.num_nodes, size=n).astype(np.int32)
    wl = rng.integers(0, max(g.num_levels, 1), size=n).astype(np.int32)
    return s, t, wl
