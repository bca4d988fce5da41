"""Rank-batched WC-Index construction, and the host side of incremental
maintenance (`affected_vertices`, `rebuild_affected_rows`) and label
cleaning (`clean_index`).

`build_wc_index_batched` is the reference package's host-orchestrated
pipeline: each round runs as torch ops on the device (`_batched_round`:
the prune against the partial index, then one gather, min and
``scatter_reduce(amax)`` relaxation over the edge list), downloads the
[B, V] emission mask, and appends into padded [V, cap] host arrays.
`build_wc_index_batched_packed` is the device-resident pipeline the
serving path uses. Roots are processed in rank batches of B: within a
batch the B constrained BFS runs share one round loop on the
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
from .dominance import pareto_filter_grouped
from .graph import Graph, INF_DIST, expand_frontier_csr
from .ordering import make_order
from .wc_index import (PackedLabelsBuilder, PackedWCIndex, WCIndex,
                       _concat_ranges, _relax_root, _seed_hub_table,
                       append_self_entries)

DEV_INF = 1 << 29
_INF = int(INF_DIST)


def _batched_round(F, R, T, hub, dist, wlev, count, root_ranks, edges_src,
                   edges_dst, edges_lvl, rank, d: int, *, do_prune: bool):
    """One synchronized BFS round for a batch of roots, as torch ops.

    F: [B, V] frontier quality level (-1 inactive), R: [B, V] best
    bottleneck level, T: [B, V, W+1] per-root hub tables, the partial
    index as padded [V, cap] tensors. Returns (next F, next R, emit)."""
    B, V = F.shape
    dev = F.device
    active = F >= 0
    Fw = F.clamp(0, T.shape[-1] - 1).long()
    if do_prune:
        # query the partial index: min_i dist[v, i] + T[b, hub[v, i], F[b, v]]
        col = torch.arange(hub.shape[1], device=dev)
        valid = (col[None, :] < count[:, None]) & (hub >= 0)       # [V, cap]
        # T holds only the real roots of a tail batch: its inert rows
        # (never active) read the last real root's table
        brow = torch.arange(B, device=dev).clamp_max(T.shape[0] - 1)
        tv = T[brow[:, None, None],
               hub.clamp(0, V - 1).long()[None, :, :],
               Fw[:, :, None]]                                     # [B,V,cap]
        qual_ok = wlev[None, :, :] >= Fw[:, :, None]
        # clamp before adding: INF + INF must not overflow int32
        cand = torch.where(valid[None] & qual_ok,
                           dist.clamp_max(DEV_INF)[None]
                           + tv.clamp_max(DEV_INF), _INF)
        survive = active & (cand.amin(dim=2) > d)
    else:
        survive = active
    emit_w = torch.where(survive, F, -1)
    # relaxation: one gather -> min -> segment max over all B roots
    wp = torch.minimum(emit_w[:, edges_src], edges_lvl[None, :])   # [B, E2]
    ok_dst = rank[edges_dst][None, :] > root_ranks[:, None]
    wp = torch.where(ok_dst, wp, -1)
    seg = (edges_dst[None, :] + V * torch.arange(B, device=dev)[:, None])
    newR = torch.full((B * V,), -1, dtype=torch.int32, device=dev)
    newR.scatter_reduce_(0, seg.reshape(-1), wp.reshape(-1), reduce="amax")
    newR = newR.reshape(B, V)
    improved = newR > R
    return (torch.where(improved, newR, -1), torch.where(improved, newR, R),
            emit_w)


def _build_T(hub, dist, wlev, count, root_ids, root_ranks, V, W):
    """Host-side per-batch hub tables (numpy; |L(root)| is small)."""
    T = np.full((len(root_ids), V, W + 1), INF_DIST, dtype=np.int32)
    for b, (r, k) in enumerate(zip(root_ids, root_ranks)):
        c = int(count[r])
        if c:
            _seed_hub_table(T[b], hub[r, :c], dist[r, :c], wlev[r, :c], W)
        T[b, k, :] = 0
    return T


def _pad_cols(a: np.ndarray, cap: int, fill: int) -> np.ndarray:
    if a.shape[1] >= cap:
        return a[:, :cap]
    return np.pad(a, ((0, 0), (0, cap - a.shape[1])), constant_values=fill)


def build_wc_index_batched(g: Graph, order: Optional[np.ndarray] = None,
                           ordering: str = "degree", batch_size: int = 32,
                           minimalize: bool = True, device=None
                           ) -> tuple[WCIndex, dict]:
    """Rank-batched construction, host-orchestrated: every round's [B, V]
    emission mask comes back to the host. Runs its rounds on the card
    unless ``device="cpu"``. Returns (padded index, stats); the index and
    the ``rounds`` / ``raw_entries`` / sync counts equal the reference's
    for the same graph, order and batch size."""
    dev = resolve_device(device)
    V, W = g.num_nodes, g.num_levels
    if order is None:
        order = make_order(g, ordering)
    order = np.asarray(order, dtype=np.int32)
    rank = np.empty(V, dtype=np.int32)
    rank[order] = np.arange(V, dtype=np.int32)

    B = int(batch_size)
    hub = np.full((V, 4), -1, dtype=np.int32)
    dist = np.full((V, 4), INF_DIST, dtype=np.int32)
    wlev = np.full((V, 4), -1, dtype=np.int32)
    count = np.zeros(V, dtype=np.int32)

    e_src, e_dst, e_lvl, rank_d = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (g.edges_src.astype(np.int64), g.edges_dst.astype(np.int64),
                  g.edges_level, rank))
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
        T = _build_T(hub, dist, wlev, count, roots[:nb], root_ranks[:nb],
                     V, W)
        # device mirrors, capacity a power of two (as the reference's)
        cap = max(8, 1 << int(np.ceil(np.log2(max(int(count.max()), 1)
                                              + 1))))
        hub_d, dist_d, wlev_d = (
            torch.from_numpy(np.ascontiguousarray(_pad_cols(a, cap, fill)))
            .to(dev) for a, fill in ((hub, -1), (dist, _INF), (wlev, -1)))
        count_d = torch.from_numpy(count).to(dev)
        F0 = np.full((B, V), -1, dtype=np.int32)
        F0[np.arange(nb), roots[:nb]] = W
        F = torch.from_numpy(F0).to(dev)
        R = F  # at d = 0, R == F (the roots only)
        T_d = torch.from_numpy(T).to(dev)
        rr_d = torch.from_numpy(root_ranks).to(dev)

        d = 0
        emitted: list[tuple[np.ndarray, np.ndarray, np.ndarray, int]] = []
        while True:
            F, R, emit_w = _batched_round(
                F, R, T_d, hub_d, dist_d, wlev_d, count_d, rr_d, e_src,
                e_dst, e_lvl, rank_d, d, do_prune=(d > 0))
            n_rounds += 1
            if d > 0:
                ew = emit_w.cpu().numpy()      # [B, V] download, every round
                array_syncs += 1
                bs, vs = np.nonzero(ew >= 0)
                if len(bs):
                    emitted.append((bs.astype(np.int32), vs.astype(np.int32),
                                    ew[bs, vs].astype(np.int32), d))
            d += 1
            scalar_syncs += 1
            if not bool((F >= 0).any()):
                break
        # append the batch's emissions, grouped by vertex, hub rank rising
        if emitted:
            b_all = np.concatenate([e[0] for e in emitted])
            v_all = np.concatenate([e[1] for e in emitted])
            w_all = np.concatenate([e[2] for e in emitted])
            d_all = np.concatenate([np.full(len(e[0]), e[3], np.int32)
                                    for e in emitted])
            raw_entries += len(b_all)
            o = np.lexsort((d_all, b_all, v_all))
            b_all, v_all, w_all, d_all = (b_all[o], v_all[o], w_all[o],
                                          d_all[o])
            uniq, run_start = np.unique(v_all, return_index=True)
            run_len = np.diff(np.append(run_start, len(v_all)))
            pos = count[v_all] + _concat_ranges(run_len)
            need = int(pos.max()) + 1
            if need > hub.shape[1]:
                new_cap = max(need, hub.shape[1] * 2)
                hub, dist, wlev = (_pad_cols(a, new_cap, fill) for a, fill
                                   in ((hub, -1), (dist, _INF), (wlev, -1)))
            hub[v_all, pos] = root_ranks[b_all]
            dist[v_all, pos] = d_all
            wlev[v_all, pos] = w_all
            count[uniq] += run_len.astype(np.int32)

    stats = {"rounds": n_rounds, "raw_entries": int(raw_entries),
             "batch_size": B, "host_array_syncs": array_syncs,
             "host_scalar_syncs": scalar_syncs}
    if minimalize:
        # per-(vertex, hub) Pareto sweep restores minimality
        total = int(count.sum())
        v_flat = np.repeat(np.arange(V, dtype=np.int64), count)
        col = _concat_ranges(count)
        h_flat = hub[v_flat, col]
        d_flat = dist[v_flat, col]
        w_flat = wlev[v_flat, col]
        keep = pareto_filter_grouped(v_flat * V + h_flat,
                                     d_flat.astype(np.int64),
                                     w_flat.astype(np.int64))
        removed = total - int(keep.sum())
        stats["dominated_removed"] = removed
        if removed:
            v2, h2, d2, w2 = (v_flat[keep], h_flat[keep], d_flat[keep],
                              w_flat[keep])
            count = np.bincount(v2, minlength=V).astype(np.int32)
            capn = max(int(count.max()), 1)
            hub = np.full((V, capn), -1, dtype=np.int32)
            dist = np.full((V, capn), INF_DIST, dtype=np.int32)
            wlev = np.full((V, capn), -1, dtype=np.int32)
            pos = _concat_ranges(count)
            o = np.lexsort((d2, h2, v2))
            hub[v2[o], pos] = h2[o]
            dist[v2[o], pos] = d2[o]
            wlev[v2[o], pos] = w2[o]
    hub, dist, wlev, count = append_self_entries(hub, dist, wlev, count,
                                                 rank, W)
    idx = WCIndex(order=order, rank=rank, levels=g.levels.copy(),
                  hub_rank=hub, dist=dist, wlev=wlev, count=count)
    stats["entries"] = idx.size_entries()
    return idx, stats


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


def clean_index(idx: WCIndex) -> tuple[WCIndex, int]:
    """PSL-style label cleaning: drop every entry (v, hub k, d, w) that the
    query Q(v, order[k], w) already answers with distance <= d through
    hubs of rank < k (the paper's minimality). Roots in rank order keep
    the witnesses valid by induction on hub rank. Returns (index, entries
    removed)."""
    V, W = idx.num_nodes, idx.num_levels
    hub, dist, wlev = (idx.hub_rank.copy(), idx.dist.copy(), idx.wlev.copy())
    count = idx.count.copy()
    col = np.arange(hub.shape[1])
    removed_total = 0
    for k in range(V):
        root = int(idx.order[k])
        # vertices holding an entry with hub k (self entries skipped)
        vs, cols = np.nonzero((hub == k) & (col[None, :] < count[:, None]))
        sel = vs != root
        vs, cols = vs[sel], cols[sel]
        if len(vs) == 0:
            continue
        d_e = dist[vs, cols]
        w_e = wlev[vs, cols]
        c = int(count[root])
        hr, dr, wr = hub[root, :c], dist[root, :c], wlev[root, :c]
        m = hr < k
        T = np.full((V, W + 1), INF_DIST, dtype=np.int64)
        if m.any():
            _seed_hub_table(T, hr[m], dr[m], wr[m], W)
        hv = hub[vs]
        ok = (col[None, :] < count[vs, None]) & (hv >= 0) & (hv < k) & \
             (wlev[vs] >= w_e[:, None])
        tv = T[np.clip(hv, 0, V - 1), w_e[:, None]]
        cand = np.where(ok, dist[vs].astype(np.int64) + tv, INF_DIST)
        drop = cand.min(axis=1) <= d_e
        if drop.any():
            removed_total += int(drop.sum())
            dv, dc = vs[drop], cols[drop]
            o = np.lexsort((-dc, dv))  # right to left per vertex
            for v, cpos in zip(dv[o], dc[o]):
                cc = int(count[v])
                hub[v, cpos:cc - 1] = hub[v, cpos + 1:cc]
                dist[v, cpos:cc - 1] = dist[v, cpos + 1:cc]
                wlev[v, cpos:cc - 1] = wlev[v, cpos + 1:cc]
                hub[v, cc - 1] = -1
                dist[v, cc - 1] = INF_DIST
                wlev[v, cc - 1] = -1
                count[v] -= 1
    out = WCIndex(order=idx.order, rank=idx.rank, levels=idx.levels,
                  hub_rank=hub, dist=dist, wlev=wlev, count=count)
    return out, removed_total


# Incremental maintenance: `core.wc_index.DynamicWCIndex` calls these two
# per update batch. `affected_vertices` bounds the blast radius of an edge
# change; `rebuild_affected_rows` re-runs the pruned rank-ordered rounds
# for exactly those roots, seeded with the current serving rows.


def affected_vertices(g_old: Graph, g_new: Graph, endpoints) -> np.ndarray:
    """Vertices whose label row may change when ``g_old`` becomes ``g_new``:
    the connected-component closure of the touched ``endpoints`` at level
    0 over the union of both graphs. Sufficient: a root outside it (in
    both graphs) explores an unchanged subgraph with unchanged inputs, and
    every emission of an affected root lands inside it."""
    V = g_new.num_nodes
    seen = np.zeros(V, dtype=bool)
    f = np.unique(np.asarray(list(endpoints), dtype=np.int64))
    f = f[(f >= 0) & (f < V)]
    seen[f] = True
    f = f.astype(np.int32)
    while len(f):
        nxt = [expand_frontier_csr(g, f)[1] for g in (g_old, g_new)]
        nxt = np.unique(np.concatenate(nxt).astype(np.int64))
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        f = nxt.astype(np.int32)
    return np.flatnonzero(seen).astype(np.int32)


def rebuild_affected_rows(g: Graph, order: np.ndarray, rank: np.ndarray,
                          num_levels: int, merged_flat, affected) -> dict:
    """Recompute the label rows of the ``affected`` vertices on the
    mutated graph ``g``.

    Re-runs the sequential Algorithm-3 loop of `wc_index.build_wc_index`
    for the affected roots only (ascending rank), seeded with the current
    serving rows (``merged_flat``: flat hub/dist/wlev + offsets) minus
    every entry whose hub is an affected root and minus the self entries.
    At root k the unaffected seed entries with hub < k are what a build
    from scratch would hold by then, affected hubs < k were re-run earlier
    in this loop, and hubs >= k stay out of the hub table, so pruning
    never consults a witness the build from scratch would not have.

    Returns ``{vertex: (hub, dist, wlev)}``: full replacement rows
    (hub-sorted, closed by the self entry) for every vertex whose row may
    have changed."""
    V, W = g.num_nodes, int(num_levels)
    order = np.asarray(order, dtype=np.int32)
    rank = np.asarray(rank, dtype=np.int32)
    fhub, fdist, fwlev, offs = merged_flat
    affected = np.asarray(affected, dtype=np.int64)
    aff_ranks = np.sort(rank[affected].astype(np.int64))
    is_aff_rank = np.zeros(V, dtype=bool)
    is_aff_rank[aff_ranks] = True

    # seed padded working rows from the current serving store
    lens = (offs[1:] - offs[:-1]).astype(np.int64)
    rows_of = np.repeat(np.arange(V, dtype=np.int64), lens)
    keep = ~is_aff_rank[np.clip(fhub, 0, V - 1)]
    keep[offs[1:] - 1] = False  # every row ends with its self entry
    krows = rows_of[keep]
    count = np.bincount(krows, minlength=V).astype(np.int32)
    cap = max(int(count.max()) if V else 1, 8)
    hub = np.full((V, cap), -1, dtype=np.int32)
    dist = np.full((V, cap), INF_DIST, dtype=np.int32)
    wlev = np.full((V, cap), -1, dtype=np.int32)
    cols = _concat_ranges(count.astype(np.int64))
    hub[krows, cols] = fhub[keep]
    dist[krows, cols] = fdist[keep]
    wlev[krows, cols] = fwlev[keep]
    # rows that lost an entry are stale even if the re-run emits nothing
    dropped = ~keep
    dropped[offs[1:] - 1] = False  # self entries are re-appended
    touched = np.zeros(V, dtype=bool)
    touched[affected] = True
    touched[rows_of[dropped]] = True

    T = np.full((V, W + 1), INF_DIST, dtype=np.int32)
    touched_T: list[np.ndarray] = []
    R = np.full(V, -1, dtype=np.int32)
    touched_R: list[np.ndarray] = []
    for k in aff_ranks:
        k = int(k)
        root = int(order[k])
        c = int(count[root])
        if c:
            hr, dr, wr = hub[root, :c], dist[root, :c], wlev[root, :c]
            pre = hr < k  # only hubs a build from scratch knows by now
            if pre.any():
                _seed_hub_table(T, hr[pre], dr[pre], wr[pre], W)
                touched_T.append(hr[pre].copy())
        T[k, :] = 0
        touched_T.append(np.array([k], dtype=np.int32))
        R[root] = W
        touched_R.append(np.array([root], dtype=np.int32))
        hub, dist, wlev, emitted = _relax_root(
            g, rank, k, root, W, T, R, touched_R, hub, dist, wlev, count,
            prune=True)
        for fv in emitted:
            touched[fv] = True
        for arr in touched_T:
            T[arr] = INF_DIST
        touched_T.clear()
        for arr in touched_R:
            R[arr] = -1
        touched_R.clear()

    # full replacement rows (hub-sorted + self entry)
    out = {}
    for v in np.flatnonzero(touched):
        v = int(v)
        c = int(count[v])
        h, dd, w = hub[v, :c], dist[v, :c], wlev[v, :c]
        o = np.lexsort((dd, h))
        h, dd, w = h[o], dd[o], w[o]
        out[v] = (np.append(h, rank[v]).astype(np.int32),
                  np.append(dd, 0).astype(np.int32),
                  np.append(w, W).astype(np.int32))
    return out
