"""Path-dominance utilities (paper Def. 4/5).

A (d, w) pair dominates (d', w') iff d <= d' and w >= w'. Per (vertex, hub)
the surviving set is a Pareto staircase: sorting by (d asc, w desc) and
keeping entries whose w strictly exceeds the running max yields the minimal
set (Thm. 3: within a hub's list, d and w are then both strictly increasing).
"""
from __future__ import annotations

import numpy as np


def pareto_filter(d: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated (d, w) pairs (d min-better, w
    max-better). Ties: among equal (d, w) keeps one. O(n log n)."""
    n = len(d)
    if n == 0:
        return np.zeros(0, dtype=bool)
    order = np.lexsort((-w, d))  # d asc, then w desc
    ws = w[order]
    inc = np.maximum.accumulate(ws)
    keep_sorted = np.empty(n, dtype=bool)
    keep_sorted[0] = True
    keep_sorted[1:] = ws[1:] > inc[:-1]
    keep = np.zeros(n, dtype=bool)
    keep[order] = keep_sorted
    return keep


def pareto_csr_emit(v: np.ndarray, hub: np.ndarray, d: np.ndarray,
                    w: np.ndarray, num_nodes: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Fused Pareto post-pass + CSR emission order for a flat entry list.

    Input: parallel arrays (vertex, hub, d, w) in any order. Returns
    ``(order, keep)`` where ``order`` sorts the entries vertex-major with
    hub ascending inside each vertex and d ascending inside each
    (vertex, hub) group — exactly the label-row order the CSR store wants —
    and ``keep`` (aligned with ``order``) marks the entries that survive
    the per-(vertex, hub) dominance filter. One sort serves both the
    minimality sweep and the flat-store scatter, so the builder never
    materializes a padded [V, cap] intermediate between them."""
    v = np.asarray(v, dtype=np.int64)
    hub = np.asarray(hub, dtype=np.int64)
    n = len(v)
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    key = v * num_nodes + hub  # unique per (vertex, hub): hub rank < V
    keep_by_entry = pareto_filter_grouped(key, np.asarray(d, dtype=np.int64),
                                          np.asarray(w, dtype=np.int64))
    order = np.lexsort((d, hub, v))
    return order, keep_by_entry[order]


def pareto_filter_grouped(hub: np.ndarray, d: np.ndarray, w: np.ndarray
                          ) -> np.ndarray:
    """Per-hub Pareto filter over a flat (hub, d, w) entry list.

    Sort by (hub, d asc, w desc); an entry survives iff its w strictly exceeds
    the running per-hub max. The per-group cummax is computed with a global
    cummax over ws shifted by a large per-group offset (exact for int-like
    values), avoiding python loops over entries."""
    n = len(d)
    if n == 0:
        return np.zeros(0, dtype=bool)
    order = np.lexsort((-w, d, hub))
    h, ws = hub[order], w[order].astype(np.float64)
    new_grp = np.ones(n, dtype=bool)
    new_grp[1:] = h[1:] != h[:-1]
    grp_id = np.cumsum(new_grp) - 1
    # offset each group far above the previous so a single global cummax
    # restarts effectively at each group boundary
    span = (ws.max() - ws.min()) + 1.0
    shifted = ws + grp_id * span
    inc = np.maximum.accumulate(shifted)
    keep_sorted = np.empty(n, dtype=bool)
    keep_sorted[0] = True
    keep_sorted[1:] = shifted[1:] > inc[:-1]
    keep = np.zeros(n, dtype=bool)
    keep[order] = keep_sorted
    return keep
