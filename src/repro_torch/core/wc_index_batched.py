"""Rank-batched, device-resident WC-Index construction.

Port of the reference package's `core/wc_index_batched.py::
build_wc_index_batched_packed`. Roots are processed in rank batches of B:
within a batch the B constrained BFS runs share one round loop on the
card (K3 `wc_prune_emit_batched` prunes against the partial index as of
the batch start and emits, K4 `wc_relax_batched` relaxes), and the
emissions stream into a `PackedLabelsBuilder` whose finalize runs the
Pareto post-pass and writes the CSR store directly.

The only per-round host sync is the termination check. The per-batch
emission table E ([B, V, W+1]) stays on the device: its non-empty cells
are selected there (`torch.nonzero`) and only those entries come to the
host, which then appends exactly the entries, in exactly the order, that
the reference appends after downloading E.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels._cuda import resolve_device
from ..kernels.frontier import row_ends
from .graph import Graph, INF_DIST
from .ordering import make_order
from .wc_index import PackedLabelsBuilder, PackedWCIndex, _concat_ranges

DEV_INF = 1 << 29
_INF = int(INF_DIST)


def _build_T_device(hub, dist, wlev, roots, root_ranks, *, num_nodes: int,
                    num_levels: int):
    """Per-root hub tables from the device-side partial index:
    T[b, h, f] = min dist from root b to hub rank h over paths of quality
    level >= f (INF_DIST where unreachable; 0 on the root's own rank).
    Inert pad rows carry root_ranks == V + 1 and add no self entry.

    T is built level-major, ``[B, W+1, V]`` in memory, and returned as
    the ``[B, V, W+1]`` view of it: along a hub-sorted label row, K3's
    gathers for one root and one level fall on nearby words."""
    V, W1 = num_nodes, num_levels + 1
    B = roots.shape[0]
    dev = hub.device
    hr = hub[roots]                                     # [B, cap] hub ranks
    dr = dist[roots].clamp_max(DEV_INF)
    wr = wlev[roots]
    lev = torch.arange(W1, device=dev)
    feas = lev[None, None, :] <= wr[:, :, None]
    vals = torch.where(feas & (hr >= 0)[:, :, None], dr[:, :, None], _INF)
    T = torch.full((B, W1, V), _INF, dtype=torch.int32, device=dev)
    bidx = torch.arange(B, device=dev)[:, None, None]
    flat = ((bidx * W1 + lev[None, None, :]) * V
            + hr.clamp(0, V - 1).long()[:, :, None])
    T.view(-1).scatter_reduce_(0, flat.reshape(-1), vals.reshape(-1),
                               reduce="amin")
    T = T.permute(0, 2, 1)                              # [B, V, W+1] view
    self_val = torch.where(root_ranks < V, 0, _INF).to(torch.int32)
    rows = T[torch.arange(B, device=dev), root_ranks.clamp(0, V - 1).long()]
    T[torch.arange(B, device=dev), root_ranks.clamp(0, V - 1).long()] = \
        torch.minimum(rows, self_val[:, None])
    return T


def _accum_emit(E, emit_w, d: int):
    """Fold one round's emissions into the emission table: E[b, v, w] =
    the round (== distance) at which (root b, vertex v) emitted quality
    level w. Each cell is written at most once, so min() is a plain
    first-write."""
    W1 = E.shape[2]
    onehot = emit_w[:, :, None] == torch.arange(W1, device=E.device)[
        None, None, :]
    return torch.where(onehot, E.clamp_max(d), E)


def _scatter_append(hub, dist, wlev, v, pos, h_new, d_new, w_new):
    """Append new label entries into the device-side padded partial
    index, in place (the tensors are the builder's own)."""
    hub[v, pos] = h_new
    dist[v, pos] = d_new
    wlev[v, pos] = w_new


def build_wc_index_batched_packed(
        g: Graph, order: Optional[np.ndarray] = None,
        ordering: str = "degree", batch_size: int = 32,
        minimalize: bool = True, device=None
        ) -> tuple[PackedWCIndex, dict]:
    """Device-resident rank-batched construction emitting CSR directly.

    Runs on the card unless ``device="cpu"`` (the plain versions of the
    round kernels). Returns (PackedWCIndex, stats); the labels and the
    ``rounds`` / ``raw_entries`` / ``dominated_removed`` stats equal the
    reference builder's for the same graph, order and batch size.
    """
    dev = resolve_device(device)
    V, W = g.num_nodes, g.num_levels
    if order is None:
        order = make_order(g, ordering)
    order = np.asarray(order, dtype=np.int32)
    rank = np.empty(V, dtype=np.int32)
    rank[order] = np.arange(V, dtype=np.int32)

    B = int(batch_size)
    nbr_np, lvl_np = g.padded_adjacency()
    nbr_d = torch.from_numpy(nbr_np).to(dev)
    lvl_d = torch.from_numpy(lvl_np).to(dev)
    rank_d = torch.from_numpy(rank).to(dev)
    nbr_end = row_ends(nbr_d, lvl_d)          # K4's row ends, once a build

    cap = 8
    hub_d = torch.full((V, cap), -1, dtype=torch.int32, device=dev)
    dist_d = torch.full((V, cap), _INF, dtype=torch.int32, device=dev)
    wlev_d = torch.full((V, cap), -1, dtype=torch.int32, device=dev)
    count = np.zeros(V, dtype=np.int64)

    builder = PackedLabelsBuilder(V)
    n_rounds = 0
    raw_entries = 0
    array_syncs = 0
    scalar_syncs = 0

    for start in range(0, V, B):
        roots = order[start:start + B]
        nb = len(roots)
        root_ranks = np.arange(start, start + nb, dtype=np.int32)
        if nb < B:  # pad the tail batch with inert rows
            roots = np.concatenate([roots, np.zeros(B - nb, np.int32)])
            root_ranks = np.concatenate(
                [root_ranks, np.full(B - nb, V + 1, np.int32)])
        rr_d = torch.from_numpy(root_ranks).to(dev)
        T_d = _build_T_device(hub_d, dist_d, wlev_d,
                              torch.from_numpy(roots).to(dev).long(), rr_d,
                              num_nodes=V, num_levels=W)
        F = torch.full((B, V), -1, dtype=torch.int32, device=dev)
        F[torch.arange(nb, device=dev),
          torch.from_numpy(roots[:nb]).to(dev).long()] = W
        R = F
        E = torch.full((B, V, W + 1), _INF, dtype=torch.int32, device=dev)
        # K3's row ends: the partial index is fixed within a batch and
        # filled prefix first, so its per-row counts are exact
        count_d = torch.from_numpy(count.astype(np.int32)).to(dev)

        d = 0
        while True:
            emit_w = kops.wc_prune_emit(F, T_d, hub_d, dist_d, wlev_d, d,
                                        do_prune=(d > 0), row_end=count_d)
            if d > 0:
                E = _accum_emit(E, emit_w, d)
            F, R = kops.wc_relax_batched(emit_w, nbr_d, lvl_d, rank_d, rr_d,
                                         R, row_end=nbr_end)
            n_rounds += 1
            d += 1
            scalar_syncs += 1
            if not bool((F >= 0).any()):
                break

        # the non-empty cells of E, selected on the device: one download
        # of (b, v, w, dist) per batch instead of the whole table
        nz = torch.nonzero(E < _INF)                       # [n, 3] (b, v, w)
        found = torch.cat([nz, E[nz[:, 0], nz[:, 1], nz[:, 2]][:, None]
                           .long()], dim=1).cpu().numpy()
        array_syncs += 1
        if len(found) == 0:
            continue
        bs, vs, ws, ds = (found[:, i] for i in range(4))
        # per (b, v) the emitted level rises with the round, so sorting by
        # (v, b, w) is exactly (vertex, hub rank asc, dist asc)
        o = np.lexsort((ws, bs, vs))
        bs, vs = bs[o], vs[o].astype(np.int32)
        ws, ds = ws[o].astype(np.int32), ds[o].astype(np.int32)
        hub_new = root_ranks[bs].astype(np.int32)
        raw_entries += len(bs)
        builder.append_batch(vs, hub_new, ds, ws)

        # mirror the new entries into the device-side prune index
        uniq, run_start = np.unique(vs, return_index=True)
        run_len = np.diff(np.append(run_start, len(vs)))
        pos = count[vs] + _concat_ranges(run_len)
        need = int(pos.max()) + 1
        if need > cap:
            new_cap = max(need, cap * 2)
            grow = [torch.full((V, new_cap), fill, dtype=torch.int32,
                               device=dev) for fill in (-1, _INF, -1)]
            for dst, src in zip(grow, (hub_d, dist_d, wlev_d)):
                dst[:, :cap] = src
            hub_d, dist_d, wlev_d = grow
            cap = new_cap
        staged = torch.from_numpy(np.stack(
            [vs, pos.astype(np.int32), hub_new, ds, ws])).to(dev)
        vv, pp = staged[0].long(), staged[1].long()
        _scatter_append(hub_d, dist_d, wlev_d, vv, pp, staged[2], staged[3],
                        staged[4])
        count[uniq] += run_len

    t0 = time.perf_counter()
    labels, removed = builder.finalize(rank=rank, num_levels=W,
                                       minimalize=minimalize)
    finalize_s = time.perf_counter() - t0
    idx = PackedWCIndex(order=order, rank=rank, levels=g.levels.copy(),
                        labels=labels)
    stats = {"rounds": n_rounds, "raw_entries": int(raw_entries),
             "batch_size": B, "host_array_syncs": array_syncs,
             "host_scalar_syncs": scalar_syncs,
             "dominated_removed": removed,
             "entries": labels.size_entries(),
             "partial_index_cap": cap, "finalize_s": finalize_s}
    return idx, stats
