"""Bucket-pair WCSD query kernels (K7 `wcsd_query_segmented`, K8
`wcsd_profile_segmented`): the CUDA launchers and, beside each, its plain
PyTorch version.

One launch answers one planned sub-batch (`core.query.plan_query_batch`):
query b joins row ``srow[b]`` of the s-side bucket tiles ``[Ns, Ws]``
with row ``trow[b]`` of the t-side tiles ``[Nt, Wt]``
(`core.wc_index.PackedLabels.bucket_tiles`; pads hub -1, dist INF_DIST,
wlev -1). The CUDA source is `repro_torch/csrc/wcsd_query.cu`, where
K7/K8 share one join with the ragged kernels; the plain versions
translate the reference package's `kernels/ref.py` oracles
(`wcsd_query_segmented_ref`, `wcsd_profile_segmented_ref`), chunked over
the batch, and cap every minimum at DEV_INF as the kernels'
DEV_INF-initialised accumulators do.
"""
from __future__ import annotations

import torch

from . import _cuda

DEV_INF = 1 << 29
MAX_LEVELS1 = 32        # per-thread level minima of the profile kernel
_CHUNK_CELLS = 1 << 25  # join cells per chunk of the plain versions


def _rows(hub, dist, wlev, rows):
    return hub[rows], dist[rows].clamp_max(DEV_INF), wlev[rows]


def _step(Ws: int, Wt: int) -> int:
    return max(1, _CHUNK_CELLS // max(Ws * Wt, 1))


def wcsd_query_segmented_plain(hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t,
                               srow, trow, wq):
    """Plain version of K7: gather both rows of every query, mask by its
    level, join. Returns [B] int32 (DEV_INF means infeasible)."""
    B = srow.shape[0]
    out = torch.empty((B,), dtype=torch.int32, device=srow.device)
    step = _step(hub_s.shape[1], hub_t.shape[1])
    for a in range(0, B, step):
        w = wq[a:a + step].long()[:, None]
        hs, ds, ws = _rows(hub_s, dist_s, wlev_s, srow[a:a + step])
        ht, dt, wt = _rows(hub_t, dist_t, wlev_t, trow[a:a + step])
        ds = torch.where(ws >= w, ds, DEV_INF)
        dt = torch.where(wt >= w, dt, DEV_INF)
        eq = hs[:, :, None] == ht[:, None, :]
        out[a:a + step] = torch.where(
            eq, ds[:, :, None] + dt[:, None, :], DEV_INF).amin(
                dim=(1, 2)).clamp_max(DEV_INF)
    return out


def wcsd_profile_segmented_plain(hub_s, dist_s, wlev_s, hub_t, dist_t,
                                 wlev_t, srow, trow, num_levels: int):
    """Plain version of K8: per query, the hub meets' sums binned by pair
    level ``min(wlev_s, wlev_t)``. Returns [B, num_levels + 1] int32
    bucket minima (DEV_INF where a level has no meet)."""
    B = srow.shape[0]
    L1 = int(num_levels) + 1
    out = torch.empty((B, L1), dtype=torch.int32, device=srow.device)
    step = _step(hub_s.shape[1], hub_t.shape[1])
    for a in range(0, B, step):
        hs, ds, ws = _rows(hub_s, dist_s, wlev_s, srow[a:a + step])
        ht, dt, wt = _rows(hub_t, dist_t, wlev_t, trow[a:a + step])
        eq = hs[:, :, None] == ht[:, None, :]
        dsum = torch.where(eq, ds[:, :, None] + dt[:, None, :], DEV_INF)
        mw = torch.minimum(ws[:, :, None], wt[:, None, :])
        out[a:a + step] = torch.stack(
            [torch.where(mw == lev, dsum, DEV_INF).amin(dim=(1, 2))
             for lev in range(L1)], dim=1).clamp_max(DEV_INF)
    return out


def _checks(what, hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t, srow, trow,
            extra: dict):
    _cuda.check_cuda_args(what, srow.device, hub_s=hub_s, dist_s=dist_s,
                          wlev_s=wlev_s, hub_t=hub_t, dist_t=dist_t,
                          wlev_t=wlev_t, srow=srow, trow=trow, **extra)
    for side, (h, d, w) in (("s", (hub_s, dist_s, wlev_s)),
                            ("t", (hub_t, dist_t, wlev_t))):
        if h.dim() != 2 or d.shape != h.shape or w.shape != h.shape:
            raise ValueError(f"{what}: hub/dist/wlev_{side} must all be "
                             "one [N, W] shape")
        if h.shape[1] < 1:
            raise ValueError(f"{what}: empty {side}-side rows")
    if srow.dim() != 1 or srow.shape != trow.shape:
        raise ValueError(f"{what}: srow/trow must be one [B] shape")
    for name, x in extra.items():
        if x.shape != srow.shape:
            raise ValueError(f"{what}: {name} must be [B]")


def wcsd_query_segmented_cuda(hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t,
                              srow, trow, wq):
    """Launch K7 on the current stream: one block per query. Returns [B]
    int32 best sums (DEV_INF means infeasible)."""
    what = "wcsd_query_segmented"
    _checks(what, hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t, srow, trow,
            {"wq": wq})
    B = srow.shape[0]
    out = torch.empty((B,), dtype=torch.int32, device=srow.device)
    if B == 0:                            # an empty sub-batch launches nothing
        return out
    fn = _cuda.library("wcsd_query").wcsd_query_segmented_launch
    err = fn(hub_s.data_ptr(), dist_s.data_ptr(), wlev_s.data_ptr(),
             hub_t.data_ptr(), dist_t.data_ptr(), wlev_t.data_ptr(),
             srow.data_ptr(), trow.data_ptr(), wq.data_ptr(), out.data_ptr(),
             B, hub_s.shape[1], hub_t.shape[1],
             _cuda.stream_ptr(srow.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out


def wcsd_profile_segmented_cuda(hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t,
                                srow, trow, num_levels: int):
    """Launch K8 on the current stream: one block per query. Returns
    [B, num_levels + 1] int32 bucket minima (DEV_INF where empty)."""
    what = "wcsd_profile_segmented"
    _checks(what, hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t, srow, trow,
            {})
    L1 = int(num_levels) + 1
    if not 1 <= L1 <= MAX_LEVELS1:
        raise ValueError(f"{what}: num_levels + 1 = {L1} outside "
                         f"[1, {MAX_LEVELS1}]")
    B = srow.shape[0]
    out = torch.empty((B, L1), dtype=torch.int32, device=srow.device)
    if B == 0:                            # an empty sub-batch launches nothing
        return out
    fn = _cuda.library("wcsd_query").wcsd_profile_segmented_launch
    err = fn(hub_s.data_ptr(), dist_s.data_ptr(), wlev_s.data_ptr(),
             hub_t.data_ptr(), dist_t.data_ptr(), wlev_t.data_ptr(),
             srow.data_ptr(), trow.data_ptr(), out.data_ptr(), B,
             hub_s.shape[1], hub_t.shape[1], L1,
             _cuda.stream_ptr(srow.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out
