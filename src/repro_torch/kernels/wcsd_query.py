"""Ragged WCSD query kernels (K1 `wcsd_query_ragged`, K2
`wcsd_profile_ragged`): the CUDA launchers and, beside each, its plain
PyTorch version.

Both read the lane-tiled label arena (`core.wc_index.LabelArena`) through
a flat ``(qidx, s_tile, t_tile)`` worklist (`core.query.
emit_ragged_worklist`) and answer a whole flush in one launch. The CUDA
sources are `repro_torch/csrc/wcsd_query.cu`; the plain versions are
line-by-line translations of the reference package's
`kernels/ref.py:wcsd_query_ragged_ref` / `wcsd_profile_ragged_ref`,
chunked over the worklist so that the ``[items, lane, lane]`` join never
exceeds a fixed number of cells.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

DEV_INF = 1 << 29
MAX_LANE = 1024         # one thread per s-side cell, one block per item
MAX_LEVELS1 = 32        # per-thread level minima of the profile kernel
_CHUNK_CELLS = 1 << 25  # join cells per chunk of the plain versions


def _chunk(lane: int) -> int:
    return max(1, _CHUNK_CELLS // max(lane * lane, 1))


def wcsd_query_ragged_plain(hub, dist, wlev, qidx, stile, ttile, wq):
    """Plain version of K1: gather each work item's two arena tiles, join,
    scatter-min into the output row. Returns [Q] int32 (>= DEV_INF means
    infeasible). The tile_lo/tile_hi early-out is a kernel optimization,
    not semantics: every item is joined."""
    lane = hub.shape[1]
    out = torch.full((wq.shape[0],), DEV_INF, dtype=torch.int32,
                     device=hub.device)
    step = _chunk(lane)
    for a in range(0, qidx.shape[0], step):
        qi, st, tt = qidx[a:a + step], stile[a:a + step], ttile[a:a + step]
        wqe = wq[qi].long()                                   # [n]
        hs, ws = hub[st], wlev[st]                            # [n, lane]
        ht, wt = hub[tt], wlev[tt]
        ds = torch.where(ws >= wqe[:, None],
                         dist[st].clamp_max(DEV_INF), DEV_INF)
        dt = torch.where(wt >= wqe[:, None],
                         dist[tt].clamp_max(DEV_INF), DEV_INF)
        eq = hs[:, :, None] == ht[:, None, :]
        best = torch.where(eq, ds[:, :, None] + dt[:, None, :],
                           DEV_INF).amin(dim=(1, 2)).to(torch.int32)
        out.scatter_reduce_(0, qi.long(), best, reduce="amin")
    return out


def wcsd_profile_ragged_plain(hub, dist, wlev, qidx, stile, ttile,
                              num_rows: int, num_levels: int):
    """Plain version of K2: per work item, bin hub meets by pair level
    ``min(wlev_s, wlev_t)`` and scatter-min the [num_levels + 1] bucket
    rows into the output. Returns [num_rows, num_levels + 1] int32."""
    lane = hub.shape[1]
    L1 = int(num_levels) + 1
    out = torch.full((num_rows, L1), DEV_INF, dtype=torch.int32,
                     device=hub.device)
    step = _chunk(lane)
    for a in range(0, qidx.shape[0], step):
        qi, st, tt = qidx[a:a + step], stile[a:a + step], ttile[a:a + step]
        hs, ws = hub[st], wlev[st]
        ht, wt = hub[tt], wlev[tt]
        ds = dist[st].clamp_max(DEV_INF)
        dt = dist[tt].clamp_max(DEV_INF)
        eq = hs[:, :, None] == ht[:, None, :]
        dsum = torch.where(eq, ds[:, :, None] + dt[:, None, :], DEV_INF)
        mw = torch.minimum(ws[:, :, None], wt[:, None, :])
        bucket = torch.stack(
            [torch.where(mw == lev, dsum, DEV_INF).amin(dim=(1, 2))
             for lev in range(L1)], dim=1).to(torch.int32)
        out.scatter_reduce_(0, qi.long()[:, None].expand(-1, L1), bucket,
                            reduce="amin")
    return out


def _arena_checks(what, hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                  ttile, extra: dict):
    dev = hub.device
    _cuda.check_cuda_args(what, dev, hub=hub, dist=dist, wlev=wlev,
                          tile_lo=tile_lo, tile_hi=tile_hi, qidx=qidx,
                          stile=stile, ttile=ttile, **extra)
    T, lane = hub.shape
    if dist.shape != (T, lane) or wlev.shape != (T, lane):
        raise ValueError(f"{what}: hub/dist/wlev must all be [T, lane]")
    if tile_lo.shape != (T,) or tile_hi.shape != (T,):
        raise ValueError(f"{what}: tile_lo/tile_hi must be [T]")
    if not (qidx.shape == stile.shape == ttile.shape) or qidx.dim() != 1:
        raise ValueError(f"{what}: qidx/stile/ttile must be one [WL] shape")
    if not 1 <= lane <= MAX_LANE:
        raise ValueError(f"{what}: lane {lane} outside [1, {MAX_LANE}]")


def wcsd_query_ragged_cuda(hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                           ttile, wq):
    """Launch K1 on the current stream. Returns [Q] int32 best sums
    (>= DEV_INF means infeasible); the output is pre-filled with DEV_INF
    and every work item ends in one atomicMin."""
    what = "wcsd_query_ragged"
    _arena_checks(what, hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                  ttile, {"wq": wq})
    if wq.dim() != 1:
        raise ValueError(f"{what}: wq must be [Q]")
    out = torch.full((wq.shape[0],), DEV_INF, dtype=torch.int32,
                     device=hub.device)
    if qidx.shape[0] == 0:                # an empty worklist launches nothing
        return out
    fn = _cuda.library("wcsd_query").wcsd_query_ragged_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(hub.data_ptr(), dist.data_ptr(), wlev.data_ptr(),
             tile_lo.data_ptr(), tile_hi.data_ptr(), qidx.data_ptr(),
             stile.data_ptr(), ttile.data_ptr(), wq.data_ptr(),
             out.data_ptr(), qidx.shape[0], hub.shape[1],
             _cuda.stream_ptr(hub.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out


def wcsd_profile_ragged_cuda(hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                             ttile, num_rows: int, num_levels: int):
    """Launch K2 on the current stream. Returns [num_rows, num_levels + 1]
    int32 bucket minima (pre-filled with DEV_INF, trash row included)."""
    what = "wcsd_profile_ragged"
    _arena_checks(what, hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                  ttile, {})
    L1 = int(num_levels) + 1
    if not 1 <= L1 <= MAX_LEVELS1:
        raise ValueError(f"{what}: num_levels + 1 = {L1} outside "
                         f"[1, {MAX_LEVELS1}]")
    out = torch.full((int(num_rows), L1), DEV_INF, dtype=torch.int32,
                     device=hub.device)
    if qidx.shape[0] == 0:                # an empty worklist launches nothing
        return out
    fn = _cuda.library("wcsd_query").wcsd_profile_ragged_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(hub.data_ptr(), dist.data_ptr(), wlev.data_ptr(),
             tile_lo.data_ptr(), tile_hi.data_ptr(), qidx.data_ptr(),
             stile.data_ptr(), ttile.data_ptr(), out.data_ptr(),
             qidx.shape[0], hub.shape[1], L1, _cuda.stream_ptr(hub.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out
