"""WCSD query kernels over the arena and the padded store: K1
`wcsd_query_ragged`, K2 `wcsd_profile_ragged`, their twins over the
compressed arena, K5 `wcsd_query_ragged_compressed` and K6
`wcsd_profile_ragged_compressed`, and K9 `wcsd_query_gathered`. The CUDA
launchers and, beside each, its plain PyTorch version.

K9 joins pre-gathered, pre-masked ``[B, L]`` label rows of the padded
store (`kernels.ops.gather_padded_rows`): per query, the min over every
cell pair with ``hs[i] == ht[j]`` of ``ds[i] + dt[j]``, capped at DEV_INF
as the Pallas kernel's DEV_INF-initialised accumulator caps it. The
store's rows are hub-sorted with inert pads after them (hub -1, distance
DEV_INF), and the CUDA kernel merge-joins such rows (one block per query,
both rows staged in shared memory up to 2,048 cells). Rows need not be
sorted: a query whose rows fail the kernel's check (real cells
non-decreasing in hub, pads only after them, every pad's distance >=
DEV_INF) is joined all-pairs inside the kernel, so any rows give the
plain version's answer.

K1, K2, K5 and K6 read the lane-tiled label arena
(`core.wc_index.LabelArena`, or `CompressedArena` for K5/K6) through a
flat ``(qidx, s_tile, t_tile)`` worklist (`core.query.
emit_ragged_worklist`) and answer a whole flush in one launch. The CUDA
sources are `repro_torch/csrc/wcsd_query.cu`; the plain versions are
line-by-line translations of the reference package's `kernels/ref.py`
oracles (`wcsd_query_ragged_ref`, `wcsd_profile_ragged_ref` and their
`_compressed` twins), chunked over the worklist so that the
``[items, lane, lane]`` join never exceeds a fixed number of cells. All
four run a warp per item and merge-join tiles whose real cells are
hub-sorted with inert pads after them (K1/K5: a pad's distance, masked
at the item's level, is >= DEV_INF; K2/K6: its wlev is < 0), all-pairs
otherwise. K5 and K6 are K1's and K2's kernels with another tile
stager, which decodes the compressed tiles into shared memory as it
loads them.

Compressed cells decode as the reference's `_decode_cells` does: hub =
``tile_lo + delta`` where ``delta >= 0`` (the sign is the pad flag), else
-1; dist = ``int(min(float32(x), DEV_INF) + 0.5)``, truncating; wlev
widened from int8.
"""
from __future__ import annotations

import torch

from . import _cuda

DEV_INF = 1 << 29
MAX_LANE = 1024         # widest arena tile the ragged kernels take
MAX_LEVELS1 = 32        # level bins of the profile kernels
_CHUNK_CELLS = 1 << 25  # join cells per chunk of the plain versions
_DIST_DTYPES = (torch.bfloat16, torch.float16)


def _chunk(lane: int) -> int:
    return max(1, _CHUNK_CELLS // max(lane * lane, 1))


def _tiles_plain(hub, dist, wlev):
    """Tile gather of the int32 arena: (hub, dist clamped to DEV_INF,
    wlev) of the given tiles."""
    def gather(tiles):
        return hub[tiles], dist[tiles].clamp_max(DEV_INF), wlev[tiles]
    return gather


def _tiles_compressed(hub_delta, dist, wlev, tile_lo):
    """Tile gather + decode of the compressed arena (the reference's
    `_decode_tiles_ref`)."""
    def gather(tiles):
        hd = hub_delta[tiles].to(torch.int32)
        h = torch.where(hd >= 0, tile_lo[tiles][:, None] + hd, -1)
        d = (dist[tiles].float().clamp_max(float(DEV_INF)) + 0.5
             ).to(torch.int32)
        return h, d, wlev[tiles].to(torch.int32)
    return gather


def _query_items(gather, lane, qidx, stile, ttile, wq):
    """Join every work item, mask by its query's level, scatter-min into
    the output row. Returns [Q] int32 (>= DEV_INF means infeasible). The
    tile_lo/tile_hi early-out is a kernel optimization, not semantics:
    every item is joined."""
    out = torch.full((wq.shape[0],), DEV_INF, dtype=torch.int32,
                     device=wq.device)
    step = _chunk(lane)
    for a in range(0, qidx.shape[0], step):
        qi, st, tt = qidx[a:a + step], stile[a:a + step], ttile[a:a + step]
        wqe = wq[qi].long()                                   # [n]
        hs, ds, ws = gather(st)                               # [n, lane]
        ht, dt, wt = gather(tt)
        ds = torch.where(ws >= wqe[:, None], ds, DEV_INF)
        dt = torch.where(wt >= wqe[:, None], dt, DEV_INF)
        eq = hs[:, :, None] == ht[:, None, :]
        best = torch.where(eq, ds[:, :, None] + dt[:, None, :],
                           DEV_INF).amin(dim=(1, 2)).to(torch.int32)
        out.scatter_reduce_(0, qi.long(), best, reduce="amin")
    return out


def _profile_items(gather, lane, qidx, stile, ttile, num_rows, num_levels):
    """Per work item, bin hub meets by pair level ``min(wlev_s, wlev_t)``
    and scatter-min the [num_levels + 1] bucket rows into the output.
    Returns [num_rows, num_levels + 1] int32."""
    L1 = int(num_levels) + 1
    out = torch.full((num_rows, L1), DEV_INF, dtype=torch.int32,
                     device=qidx.device)
    step = _chunk(lane)
    for a in range(0, qidx.shape[0], step):
        qi, st, tt = qidx[a:a + step], stile[a:a + step], ttile[a:a + step]
        hs, ds, ws = gather(st)
        ht, dt, wt = gather(tt)
        eq = hs[:, :, None] == ht[:, None, :]
        dsum = torch.where(eq, ds[:, :, None] + dt[:, None, :], DEV_INF)
        mw = torch.minimum(ws[:, :, None], wt[:, None, :])
        bucket = torch.stack(
            [torch.where(mw == lev, dsum, DEV_INF).amin(dim=(1, 2))
             for lev in range(L1)], dim=1).to(torch.int32)
        out.scatter_reduce_(0, qi.long()[:, None].expand(-1, L1), bucket,
                            reduce="amin")
    return out


def wcsd_query_ragged_plain(hub, dist, wlev, qidx, stile, ttile, wq):
    """Plain version of K1: gather each work item's two arena tiles, join,
    scatter-min into the output row. Returns [Q] int32 (>= DEV_INF means
    infeasible)."""
    return _query_items(_tiles_plain(hub, dist, wlev), hub.shape[1], qidx,
                        stile, ttile, wq)


def wcsd_profile_ragged_plain(hub, dist, wlev, qidx, stile, ttile,
                              num_rows: int, num_levels: int):
    """Plain version of K2: per-item pair-level bucket minima,
    scatter-min'd. Returns [num_rows, num_levels + 1] int32."""
    return _profile_items(_tiles_plain(hub, dist, wlev), hub.shape[1], qidx,
                          stile, ttile, num_rows, num_levels)


def wcsd_query_ragged_compressed_plain(hub_delta, dist, wlev, tile_lo, qidx,
                                       stile, ttile, wq):
    """Plain version of K5: decode each work item's two compressed tiles,
    then K1's join. ``dist`` is bfloat16 or float16."""
    return _query_items(_tiles_compressed(hub_delta, dist, wlev, tile_lo),
                        hub_delta.shape[1], qidx, stile, ttile, wq)


def wcsd_profile_ragged_compressed_plain(hub_delta, dist, wlev, tile_lo,
                                         qidx, stile, ttile, num_rows: int,
                                         num_levels: int):
    """Plain version of K6: decode, then K2's binned join."""
    return _profile_items(_tiles_compressed(hub_delta, dist, wlev, tile_lo),
                          hub_delta.shape[1], qidx, stile, ttile, num_rows,
                          num_levels)


def wcsd_query_gathered_plain(hs, ds, ht, dt):
    """Plain version of K9 (the reference's `wcsd_query_gathered_ref`,
    chunked over the batch): [B, L] rows -> [B] int32 min over equal hubs
    of ``ds + dt``, capped at DEV_INF."""
    B, L = hs.shape
    out = torch.empty((B,), dtype=torch.int32, device=hs.device)
    step = max(1, _CHUNK_CELLS // max(L * ht.shape[1], 1))
    for a in range(0, B, step):
        eq = hs[a:a + step, :, None] == ht[a:a + step, None, :]
        dsum = ds[a:a + step, :, None] + dt[a:a + step, None, :]
        out[a:a + step] = torch.where(eq, dsum, DEV_INF).amin(
            dim=(1, 2)).clamp_max(DEV_INF)
    return out


def wcsd_query_gathered_cuda(hs, ds, ht, dt):
    """Launch K9 on the current stream: one block per query, a merge join
    where both rows pass the kernel's check, else all-pairs. hs/ds/ht/dt
    [B, L] int32, ds/dt in [0, DEV_INF]. Returns [B] int32 best sums
    (DEV_INF means no meet)."""
    what = "wcsd_query_gathered"
    _cuda.check_cuda_args(what, hs.device, hs=hs, ds=ds, ht=ht, dt=dt)
    if hs.dim() != 2 or not (hs.shape == ds.shape == ht.shape == dt.shape):
        raise ValueError(f"{what}: hs/ds/ht/dt must all be one [B, L] shape")
    B, L = hs.shape
    out = torch.empty((B,), dtype=torch.int32, device=hs.device)
    if B == 0:                            # an empty batch launches nothing
        return out
    if L < 1:
        raise ValueError(f"{what}: empty label rows")
    fn = _cuda.library("wcsd_query").wcsd_query_gathered_launch
    err = fn(hs.data_ptr(), ds.data_ptr(), ht.data_ptr(), dt.data_ptr(),
             out.data_ptr(), B, L, _cuda.stream_ptr(hs.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out


def _arena_checks(what, hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                  ttile, extra: dict, dtypes: dict | None = None):
    dev = hub.device
    _cuda.check_cuda_args(what, dev, dtypes=dtypes, hub=hub, dist=dist,
                          wlev=wlev, tile_lo=tile_lo, tile_hi=tile_hi,
                          qidx=qidx, stile=stile, ttile=ttile, **extra)
    T, lane = hub.shape
    if dist.shape != (T, lane) or wlev.shape != (T, lane):
        raise ValueError(f"{what}: hub/dist/wlev must all be [T, lane]")
    if tile_lo.shape != (T,) or tile_hi.shape != (T,):
        raise ValueError(f"{what}: tile_lo/tile_hi must be [T]")
    if not (qidx.shape == stile.shape == ttile.shape) or qidx.dim() != 1:
        raise ValueError(f"{what}: qidx/stile/ttile must be one [WL] shape")
    if not 1 <= lane <= MAX_LANE:
        raise ValueError(f"{what}: lane {lane} outside [1, {MAX_LANE}]")


_COMPRESSED_DTYPES = {"hub": torch.int16, "dist": _DIST_DTYPES,
                      "wlev": torch.int8}


def _levels1(what, num_levels) -> int:
    L1 = int(num_levels) + 1
    if not 1 <= L1 <= MAX_LEVELS1:
        raise ValueError(f"{what}: num_levels + 1 = {L1} outside "
                         f"[1, {MAX_LEVELS1}]")
    return L1


def _launch_query(what, symbol, hub, dist, wlev, tile_lo, tile_hi, qidx,
                  stile, ttile, wq, extra_args=()):
    """Shared launch of K1/K5: output pre-filled with DEV_INF, one
    atomicMin per meeting work item."""
    if wq.dim() != 1:
        raise ValueError(f"{what}: wq must be [Q]")
    out = torch.full((wq.shape[0],), DEV_INF, dtype=torch.int32,
                     device=hub.device)
    if qidx.shape[0] == 0:                # an empty worklist launches nothing
        return out
    fn = getattr(_cuda.library("wcsd_query"), symbol)
    err = fn(hub.data_ptr(), dist.data_ptr(), wlev.data_ptr(),
             tile_lo.data_ptr(), tile_hi.data_ptr(), qidx.data_ptr(),
             stile.data_ptr(), ttile.data_ptr(), wq.data_ptr(),
             out.data_ptr(), qidx.shape[0], hub.shape[1], *extra_args,
             _cuda.stream_ptr(hub.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out


def _launch_profile(what, symbol, hub, dist, wlev, tile_lo, tile_hi, qidx,
                    stile, ttile, num_rows, num_levels, extra_args=()):
    """Shared launch of K2/K6: [num_rows, L1] pre-filled with DEV_INF
    (trash row included), one atomicMin per level per meeting item."""
    L1 = _levels1(what, num_levels)
    out = torch.full((int(num_rows), L1), DEV_INF, dtype=torch.int32,
                     device=hub.device)
    if qidx.shape[0] == 0:                # an empty worklist launches nothing
        return out
    fn = getattr(_cuda.library("wcsd_query"), symbol)
    err = fn(hub.data_ptr(), dist.data_ptr(), wlev.data_ptr(),
             tile_lo.data_ptr(), tile_hi.data_ptr(), qidx.data_ptr(),
             stile.data_ptr(), ttile.data_ptr(), out.data_ptr(),
             qidx.shape[0], hub.shape[1], L1, *extra_args,
             _cuda.stream_ptr(hub.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out


def wcsd_query_ragged_cuda(hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                           ttile, wq):
    """Launch K1 on the current stream: a warp per work item, a merge join
    where both tiles pass the kernel's check at the item's level, else
    all-pairs. Returns [Q] int32 best sums (>= DEV_INF means infeasible);
    the output is pre-filled with DEV_INF and every meeting work item
    ends in at most one atomicMin."""
    what = "wcsd_query_ragged"
    _arena_checks(what, hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                  ttile, {"wq": wq})
    return _launch_query(what, "wcsd_query_ragged_launch", hub, dist, wlev,
                         tile_lo, tile_hi, qidx, stile, ttile, wq)


def wcsd_profile_ragged_cuda(hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                             ttile, num_rows: int, num_levels: int):
    """Launch K2 on the current stream: a warp per work item, a merge join
    where both tiles pass the kernel's check, else all-pairs. Returns
    [num_rows, num_levels + 1] int32 bucket minima (pre-filled with
    DEV_INF, trash row included)."""
    what = "wcsd_profile_ragged"
    _arena_checks(what, hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                  ttile, {})
    return _launch_profile(what, "wcsd_profile_ragged_launch", hub, dist,
                           wlev, tile_lo, tile_hi, qidx, stile, ttile,
                           num_rows, num_levels)


def wcsd_query_ragged_compressed_cuda(hub_delta, dist, wlev, tile_lo,
                                      tile_hi, qidx, stile, ttile, wq):
    """Launch K5 on the current stream: K1's kernel over the compressed
    arena (int16 hub deltas, bfloat16 or float16 distances, int8 levels),
    each tile decoded as it is staged."""
    what = "wcsd_query_ragged_compressed"
    _arena_checks(what, hub_delta, dist, wlev, tile_lo, tile_hi, qidx, stile,
                  ttile, {"wq": wq}, _COMPRESSED_DTYPES)
    return _launch_query(what, "wcsd_query_ragged_compressed_launch",
                         hub_delta, dist, wlev, tile_lo, tile_hi, qidx,
                         stile, ttile, wq,
                         (int(dist.dtype == torch.float16),))


def wcsd_profile_ragged_compressed_cuda(hub_delta, dist, wlev, tile_lo,
                                        tile_hi, qidx, stile, ttile,
                                        num_rows: int, num_levels: int):
    """Launch K6 on the current stream: K2's kernel over the compressed
    arena, each tile decoded as it is staged."""
    what = "wcsd_profile_ragged_compressed"
    _arena_checks(what, hub_delta, dist, wlev, tile_lo, tile_hi, qidx, stile,
                  ttile, {}, _COMPRESSED_DTYPES)
    return _launch_profile(what, "wcsd_profile_ragged_compressed_launch",
                           hub_delta, dist, wlev, tile_lo, tile_hi, qidx,
                           stile, ttile, num_rows, num_levels,
                           (int(dist.dtype == torch.float16),))
