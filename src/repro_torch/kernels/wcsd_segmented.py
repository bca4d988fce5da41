"""Bucket-pair WCSD query kernels (K7 `wcsd_query_segmented`, K8
`wcsd_profile_segmented`): the CUDA launchers and, beside each, its plain
PyTorch version.

A planned sub-batch (`core.query.plan_query_batch`) is a run of queries
b that join row ``srow[b]`` of the s-side bucket tiles ``[Ns, Ws]`` with
row ``trow[b]`` of the t-side tiles ``[Nt, Wt]``
(`core.wc_index.PackedLabels.bucket_tiles`; pads hub -1, dist INF_DIST,
wlev -1). K7 and K8 are merge joins over hub-sorted rows (rows that are
not are joined all-pairs in the kernel), and each answers a whole flush
in one launch: `GroupedFlush` lays the flush's sub-batches out as a
small table (`segmented_group_table`: each one's six tile pointers, Ws,
Wt, and its columns of the staged array, ``[3, B]`` with levels for a
scalar flush, ``[2, B]`` for a profile flush) and uploads it with the
staged queries in one copy, and `wcsd_query_segmented_grouped_cuda` /
`wcsd_profile_segmented_grouped_cuda` launch over it;
`wcsd_query_segmented_cuda` and `wcsd_profile_segmented_cuda` are the
per-sub-batch entry points, with the reference's contract. The CUDA
source is `repro_torch/csrc/wcsd_query.cu`; the plain versions translate
the reference package's `kernels/ref.py` oracles
(`wcsd_query_segmented_ref`, `wcsd_profile_segmented_ref`), chunked over
the batch, and cap every minimum at DEV_INF as the kernels'
DEV_INF-initialised accumulators do.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cuda

DEV_INF = 1 << 29
MAX_LEVELS1 = 32        # level bins of the profile kernel
_CHUNK_CELLS = 1 << 25  # join cells per chunk of the plain versions
SEG_STAGE = 2048        # widest row K7 / K8 stage in shared memory
GROUP_WORDS = 16        # int32 words of a table row: six int64 tile
                        # pointers, Ws, Wt, offset, n (csrc SegGroup)


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


def segmented_group_table(groups) -> np.ndarray:
    """The table of one grouped K7 or K8 launch: ``groups`` is the
    flush's sub-batches in staging order, each ``(tiles_s, tiles_t, n)``
    with ``tiles_* = (hub, dist, wlev)`` and n its query count. Returns
    int32 ``[G, GROUP_WORDS]``: words 0-11 the six tiles' data pointers
    (int64), then Ws, Wt, the sub-batch's first column of the staged
    array, and n. Empty sub-batches have no row."""
    groups = [g for g in groups if g[2] > 0]
    table = np.zeros((len(groups), GROUP_WORDS), dtype=np.int32)
    ptrs = table.view(np.int64)
    off = 0
    for i, (ts, tt, n) in enumerate(groups):
        ptrs[i, :6] = [x.data_ptr() for x in (*ts, *tt)]
        table[i, 12:] = ts[0].shape[1], tt[0].shape[1], off, n
        off += n
    return table


class GroupedFlush:
    """A bucket-pair flush staged for one grouped launch: ``groups`` the
    planned sub-batches in staging order, each ``(tiles_s, tiles_t, n)``;
    ``stq`` the host int32 staged array in the same order, ``[3, B]``
    (row ids and levels: a scalar flush, K7) or ``[2, B]`` (row ids: a
    profile flush, K8). The table of the sub-batches
    (`segmented_group_table`) is built here from ``groups`` and goes to
    ``device`` with ``stq`` in one copy, so it always describes them.
    Holds ``groups`` (the non-empty ones), ``table`` and ``st`` (the
    device copy of ``stq``)."""

    def __init__(self, groups, stq, device):
        self.groups = [g for g in groups if g[2] > 0]
        stq = np.ascontiguousarray(stq, dtype=np.int32)
        covered = sum(n for _, _, n in self.groups)
        if stq.ndim != 2 or stq.shape[0] not in (2, 3) \
                or stq.shape[1] != covered:
            raise ValueError(f"grouped flush: the sub-batches cover "
                             f"{covered} queries, the staged array is "
                             f"{tuple(stq.shape)} (expected [3 or 2, "
                             f"{covered}])")
        table = segmented_group_table(self.groups)
        dev = torch.from_numpy(np.concatenate([table.ravel(),
                                               stq.ravel()])).to(device)
        self.table = dev[:table.size].view(table.shape)
        self.st = dev[table.size:].view(stq.shape)


def _staged(what, flush: GroupedFlush, rows: int):
    """The first ``rows`` rows of the flush's staged array (s rows, t rows
    and, for K7, levels)."""
    if flush.st.shape[0] < rows:
        raise ValueError(f"{what}: the grouped flush is staged as "
                         f"{tuple(flush.st.shape)}, the launch needs "
                         f"{rows} rows")
    return tuple(flush.st[:rows])


def _per_group(flush: GroupedFlush, staged, plain, out):
    """``out`` filled sub-batch by sub-batch: ``plain(*tiles_s, *tiles_t,
    *columns)`` on each sub-batch's columns of ``staged``."""
    a = 0
    for ts, tt, n in flush.groups:
        out[a:a + n] = plain(*ts, *tt, *(x[a:a + n] for x in staged))
        a += n
    return out


def wcsd_query_segmented_grouped_plain(flush: GroupedFlush):
    """Plain version of the grouped K7 launch: every sub-batch of
    ``flush`` through `wcsd_query_segmented_plain` on its columns of the
    staged queries. Returns [B] int32 in staging order."""
    st = _staged("wcsd_query_segmented", flush, 3)
    out = torch.empty((st[0].shape[0],), dtype=torch.int32,
                      device=st[0].device)
    return _per_group(flush, st, wcsd_query_segmented_plain, out)


def wcsd_profile_segmented_grouped_plain(flush: GroupedFlush,
                                         num_levels: int):
    """Plain version of the grouped K8 launch: every sub-batch of
    ``flush`` through `wcsd_profile_segmented_plain`. Returns [B,
    num_levels + 1] int32 bucket minima in staging order."""
    st = _staged("wcsd_profile_segmented", flush, 2)
    out = torch.empty((st[0].shape[0], int(num_levels) + 1),
                      dtype=torch.int32, device=st[0].device)
    return _per_group(
        flush, st, lambda *a: wcsd_profile_segmented_plain(*a, num_levels),
        out)


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
    """Launch K7 on the current stream for one sub-batch: one block per
    query, a merge join where both rows are hub-sorted, all-pairs where
    they are not. Returns [B] int32 best sums (DEV_INF means
    infeasible)."""
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


def _levels1(what, num_levels) -> int:
    L1 = int(num_levels) + 1
    if not 1 <= L1 <= MAX_LEVELS1:
        raise ValueError(f"{what}: num_levels + 1 = {L1} outside "
                         f"[1, {MAX_LEVELS1}]")
    return L1


def _grouped_checks(what, flush: GroupedFlush, staged, extra: dict):
    """Checks of a grouped launch, each tensor once: every bucket's tiles
    (one [N, W] shape a bucket, W >= 1), the staged rows and ``extra``
    ([B] each), the table, all on one device. Returns the widest row of
    each side that is staged in shared memory (0 if none)."""
    groups = flush.groups
    tiles = {id(x[0]): x for g in groups for x in g[:2]}  # each bucket once
    for h, d, w in tiles.values():
        if h.dim() != 2 or d.shape != h.shape or w.shape != h.shape:
            raise ValueError(f"{what}: a bucket's hub/dist/wlev must all "
                             "be one [N, W] shape")
        if h.shape[1] < 1:
            raise ValueError(f"{what}: empty bucket rows")
    srow = staged[0]
    if srow.dim() != 1 or any(x.shape != srow.shape
                              for x in (*staged, *extra.values())):
        raise ValueError(f"{what}: the staged rows must be one [B] shape")
    named = {f"{n}{i}": x for i, ts in enumerate(tiles.values())
             for n, x in zip(("hub", "dist", "wlev"), ts)}
    _cuda.check_cuda_args(what, srow.device, table=flush.table, srow=srow,
                          trow=staged[1], **extra, **named)

    def widest(side):
        w = [g[side][0].shape[1] for g in groups]
        return max([x for x in w if x <= SEG_STAGE], default=0)

    return widest(0), widest(1)


def wcsd_query_segmented_grouped_cuda(flush: GroupedFlush):
    """Launch K7 once for a whole flush on the current stream: a block per
    query, each finding its sub-batch in ``flush.table``. Same answers as
    `wcsd_query_segmented_cuda` on every sub-batch. Returns [B] int32 in
    staging order (DEV_INF means infeasible)."""
    what = "wcsd_query_segmented"
    srow, trow, wq = _staged(what, flush, 3)
    ws, wt = _grouped_checks(what, flush, (srow, trow), {"wq": wq})
    B = srow.shape[0]
    out = torch.empty((B,), dtype=torch.int32, device=srow.device)
    if B == 0:                            # an empty flush launches nothing
        return out
    fn = _cuda.library("wcsd_query").wcsd_query_segmented_grouped_launch
    err = fn(flush.table.data_ptr(), len(flush.groups), srow.data_ptr(),
             trow.data_ptr(), wq.data_ptr(), out.data_ptr(), B, ws, wt,
             _cuda.stream_ptr(srow.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out


def wcsd_profile_segmented_cuda(hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t,
                                srow, trow, num_levels: int):
    """Launch K8 on the current stream for one sub-batch: one block per
    query, a merge join where both rows are hub-sorted with inert pads
    (wlev < 0) after them, all-pairs where they are not. Returns [B,
    num_levels + 1] int32 bucket minima (DEV_INF where empty)."""
    what = "wcsd_profile_segmented"
    _checks(what, hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t, srow, trow,
            {})
    L1 = _levels1(what, num_levels)
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


def wcsd_profile_segmented_grouped_cuda(flush: GroupedFlush,
                                        num_levels: int):
    """Launch K8 once for a whole profile flush on the current stream: a
    block per query, each finding its sub-batch in ``flush.table``. Same
    answers as `wcsd_profile_segmented_cuda` on every sub-batch. Returns
    [B, num_levels + 1] int32 bucket minima in staging order."""
    what = "wcsd_profile_segmented"
    srow, trow = _staged(what, flush, 2)
    ws, wt = _grouped_checks(what, flush, (srow, trow), {})
    L1 = _levels1(what, num_levels)
    B = srow.shape[0]
    out = torch.empty((B, L1), dtype=torch.int32, device=srow.device)
    if B == 0:                            # an empty flush launches nothing
        return out
    fn = _cuda.library("wcsd_query").wcsd_profile_segmented_grouped_launch
    err = fn(flush.table.data_ptr(), len(flush.groups), srow.data_ptr(),
             trow.data_ptr(), out.data_ptr(), B, ws, wt, L1,
             _cuda.stream_ptr(srow.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return out
