"""Device-side batched WCSD query engine over the CSR label store and
the padded ``[V, cap]`` store.

Port of the reference package's `core/query.py` for `DeviceQueryEngine`:

  * ``layout="csr"``, ``dispatch="ragged"`` (default): a batch of (s, t,
    w_level) queries becomes a flat (query, s_tile, t_tile) worklist
    emitted on the device (`emit_ragged_worklist`), and the whole batch is
    answered by ONE kernel launch over the lane-tiled arena (K1
    `wcsd_query_ragged`, or K2 `wcsd_profile_ragged` for all-level
    profiles). With ``compressed=True`` the arena is the
    `CompressedArena` and the launch is K5 / K6, which decode the narrow
    cells in the kernel.
  * ``layout="csr"``, ``dispatch="bucket_pair"``: the host planner
    (`plan_query_batch`) groups the batch by (bucket(s), bucket(t)) over
    the bucket pairs' padded tiles. A scalar flush is ONE K7
    `wcsd_query_segmented` launch over a table of its groups, a profile
    flush ONE K8 `wcsd_profile_segmented` launch over the same kind of
    table. The reference keeps it as the ragged path's differential
    oracle.
  * ``layout="padded"``: one ``[V, L]`` store, every query pays the
    longest row's width. ``use_pallas=True`` answers a batch with one K9
    `wcsd_query_gathered` launch (`kernels.ops.wcsd_query`);
    ``use_pallas=False`` runs `query_batch_torch`, the plain masked outer
    join -- the fallback ladder's oracle rung. Profiles run
    `profile_batch_torch` for either setting, as in the reference.

The plain padded joins (`query_batch_torch`, `profile_batch_torch`,
`query_batch_sorted_torch`) are the reference's XLA functions
(`query_batch_jnp`, ...) as torch ops. They materialise ``[b, L, L]``
intermediates, so they walk the batch in chunks of
`padded_chunk_rows(L, chunk_bytes)` queries (one int32 intermediate holds
at most ``chunk_bytes``); the answers do not depend on the chunk size.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels._cuda import resolve_device
from ..kernels.wcsd_segmented import GroupedFlush
from .graph import INF_DIST
from .wc_index import (FLOAT_DTYPES, LANE, PackedWCIndex, ceil_to,
                       float16_bits, round_to_lane)

TRASH_LEVEL = 1 << 20  # no stored wlev reaches it: infeasible everywhere
DEV_INF = 1 << 29
PADDED_CHUNK_BYTES = 1 << 30  # one int32 [b, L, L] intermediate, at most


def padded_chunk_rows(L: int, chunk_bytes: int = PADDED_CHUNK_BYTES) -> int:
    """Queries per chunk of the plain padded joins: an int32 ``[b, L, L]``
    intermediate fits ``chunk_bytes`` (at least one query)."""
    return max(1, int(chunk_bytes) // (4 * max(int(L), 1) ** 2))


def query_batch_torch(hub, dist, wlev, count, s, t, w_level, *,
                      chunk_bytes: int = PADDED_CHUNK_BYTES):
    """[B] w-constrained distances by the masked outer join over the
    padded store (reference `query_batch_jnp`), chunked over the batch.
    hub/dist/wlev [V, L], count [V], s/t/w_level [B]. Returns [B] int32
    (INF_DIST where no feasible path)."""
    B, L = s.shape[0], hub.shape[1]
    out = torch.empty((B,), dtype=torch.int32, device=hub.device)
    step = padded_chunk_rows(L, chunk_bytes)
    for a in range(0, B, step):
        wl = w_level[a:a + step]
        hs, ds, _ = kops.padded_rows(hub, dist, wlev, count, s[a:a + step], wl)
        ht, dt, _ = kops.padded_rows(hub, dist, wlev, count, t[a:a + step], wl)
        eq = hs[:, :, None] == ht[:, None, :]
        dsum = ds[:, :, None] + dt[:, None, :]
        out[a:a + step] = kops._to_inf_dist(torch.where(
            eq, dsum, DEV_INF).amin(dim=(1, 2)))
    return out


def _staircase_from_rows(hs, ds, ws, ht, dt, wt, num_levels: int):
    """[b, *] masked label rows -> [b, W + 1] profile staircases
    (reference `_staircase_from_rows`): a hub meet (i, j) is feasible at
    exactly the levels <= min(ws[i], wt[j]), so its sum lands in one
    pair-level bucket, and the suffix min over buckets is the staircase.
    ds/dt clamped to DEV_INF, ws/wt -1 at pads."""
    eq = hs[:, :, None] == ht[:, None, :]
    dsum = torch.where(eq, ds[:, :, None] + dt[:, None, :], DEV_INF)
    mw = torch.minimum(ws[:, :, None], wt[:, None, :])
    bucket = torch.stack([torch.where(mw == lev, dsum, DEV_INF).amin(
        dim=(1, 2)) for lev in range(num_levels + 1)], dim=1)
    return kops._staircase(bucket)


def profile_batch_torch(hub, dist, wlev, count, s, t, *, num_levels: int,
                        chunk_bytes: int = PADDED_CHUNK_BYTES):
    """[B, W + 1] staircases by one masked outer join per query over the
    padded store (reference `profile_batch_jnp`), chunked over the batch:
    ``out[:, w] == query_batch_torch(..., w)`` pointwise."""
    B, L = s.shape[0], hub.shape[1]
    out = torch.empty((B, num_levels + 1), dtype=torch.int32,
                      device=hub.device)
    step = padded_chunk_rows(L, chunk_bytes)
    for a in range(0, B, step):
        out[a:a + step] = _staircase_from_rows(
            *kops.padded_rows(hub, dist, wlev, count, s[a:a + step]),
            *kops.padded_rows(hub, dist, wlev, count, t[a:a + step]),
            num_levels)
    return out


def query_batch_sorted_torch(hub, dist, wlev, count, s, t, w_level, *,
                             chunk_bytes: int = PADDED_CHUNK_BYTES):
    """Theorem-3 variant of `query_batch_torch` (reference
    `query_batch_sorted_jnp`): each hub-sorted row is first reduced to the
    minimum feasible distance per hub run, kept at the run's last entry
    (DEV_INF elsewhere), then joined. Same answers."""
    B, L = s.shape[0], hub.shape[1]
    out = torch.empty((B,), dtype=torch.int32, device=hub.device)
    step = padded_chunk_rows(L, chunk_bytes)

    def reduce_side(v, wl):
        h, d, _ = kops.padded_rows(hub, dist, wlev, count, v, wl)
        n = h.shape[0]
        first = torch.ones_like(h, dtype=torch.bool)
        first[:, 1:] = h[:, 1:] != h[:, :-1]
        last = torch.ones_like(h, dtype=torch.bool)
        last[:, :-1] = h[:, :-1] != h[:, 1:]
        run = torch.cumsum(first.to(torch.int64), dim=1) - 1   # run id
        run_min = torch.full((n, L), DEV_INF, dtype=d.dtype, device=d.device)
        run_min.scatter_reduce_(1, run, d, reduce="amin")
        return h, torch.where(last, run_min.gather(1, run), DEV_INF)

    for a in range(0, B, step):
        wl = w_level[a:a + step]
        hs, ds = reduce_side(s[a:a + step], wl)
        ht, dt = reduce_side(t[a:a + step], wl)
        eq = hs[:, :, None] == ht[:, None, :]
        out[a:a + step] = kops._to_inf_dist(torch.where(
            eq, ds[:, :, None] + dt[:, None, :], DEV_INF).amin(dim=(1, 2)))
    return out


def _build_padded_store(idx, cap, lane_pad: bool):
    """[V, L] padded label arrays (hub, dist, wlev, count); with
    ``lane_pad`` the width is rounded up to a multiple of 128, as the
    reference ships it to its kernel (pads hub -1, dist INF_DIST,
    wlev -1). K9 itself needs no pad: it only adds join work where the
    longest row is not already a multiple of 128."""
    h, d, w, c = idx.padded_device_arrays(cap)
    L = h.shape[1]
    Lp = round_to_lane(L) if lane_pad else L
    if Lp != L:
        pad = ((0, 0), (0, Lp - L))
        h = np.pad(h, pad, constant_values=-1)
        d = np.pad(d, pad, constant_values=INF_DIST)
        w = np.pad(w, pad, constant_values=-1)
    return h, d, w, c


def emit_ragged_worklist(tile_base, tile_cnt, s, t, *, worklist_len: int):
    """Device-side ragged plan: the flat (query, s_tile, t_tile) worklist.

    Query q over rows with ``tile_cnt[s[q]]`` x ``tile_cnt[t[q]]`` arena
    tiles owns that many consecutive work items (query-major, via an
    exclusive prefix sum). Returns (qidx, stile, ttile, first), all int32
    [worklist_len]. Items beyond the real total carry ``qidx == len(s)``
    (the caller's trash output row) and tile 0 on both sides; ``first``
    marks each output row's first work item, the trash row's included.
    """
    Q = s.shape[0]
    dev = s.device
    ts = tile_cnt[s.long()]
    tt = tile_cnt[t.long()]
    c = ts * tt                                            # [Q] >= 1
    cum = torch.cumsum(c, 0, dtype=torch.int32)
    k = torch.arange(worklist_len, dtype=torch.int32, device=dev)
    qidx = torch.searchsorted(cum, k, right=True, out_int32=True)
    qc = qidx.clamp_max(Q - 1).long()                      # clamp for pads
    local = k - (cum[qc] - c[qc])
    pad = qidx >= Q
    stile = torch.where(pad, 0, tile_base[s[qc].long()]
                        + torch.div(local, tt[qc], rounding_mode="floor"))
    ttile = torch.where(pad, 0, tile_base[t[qc].long()]
                        + torch.remainder(local, tt[qc]))
    first = torch.ones_like(qidx)
    first[1:] = (qidx[1:] != qidx[:-1]).to(torch.int32)
    return qidx, stile.to(torch.int32), ttile.to(torch.int32), first


def ragged_worklist_len(tile_cnt: np.ndarray, s: np.ndarray, t: np.ndarray
                        ) -> int:
    """Host-side worklist length: the batch's exact tile-pair count. O(B)
    — the only per-flush host arithmetic of the ragged path. (The
    reference rounds it up to a power of two to bound its jit shapes; the
    kernels here take any length, so no pad items are launched.)"""
    total = int(tile_cnt[s].astype(np.int64) @ tile_cnt[t].astype(np.int64))
    return total


def ragged_query_batch(hub, dist, wlev, tile_lo, tile_hi, tile_base,
                       tile_cnt, stq, *, worklist_len: int,
                       compressed: bool = False):
    """Plan + launch: emit the worklist from the staged queries and answer
    every query with one K1 launch (K5 with ``compressed=True``, where
    hub/dist/wlev are the `CompressedArena` trio and the index tables are
    shared). stq: [3, Q] staged (s, t, w_level). Returns [Q] int32
    distances (INF_DIST when no feasible path)."""
    s, t, wl = stq[0], stq[1], stq[2]
    qidx, stile, ttile, first = emit_ragged_worklist(
        tile_base, tile_cnt, s, t, worklist_len=worklist_len)
    # one trash output row for worklist pads, at an infeasible level
    wq = torch.cat([wl, torch.full((1,), TRASH_LEVEL, dtype=torch.int32,
                                   device=wl.device)])
    op = (kops.wcsd_query_ragged_compressed if compressed
          else kops.wcsd_query_ragged)
    out = op(hub, dist, wlev, tile_lo, tile_hi, qidx, stile, ttile, first,
             wq)
    return out[: s.shape[0]]


def ragged_profile_batch(hub, dist, wlev, tile_lo, tile_hi, tile_base,
                         tile_cnt, stq, *, worklist_len: int,
                         num_levels: int, compressed: bool = False):
    """Profile twin of `ragged_query_batch`: stq is [2, Q] staged (s, t);
    every level of every query comes from one K2 launch (K6 with
    ``compressed=True``). Returns [Q, num_levels + 1] staircases."""
    s, t = stq[0], stq[1]
    qidx, stile, ttile, first = emit_ragged_worklist(
        tile_base, tile_cnt, s, t, worklist_len=worklist_len)
    op = (kops.wcsd_profile_ragged_compressed if compressed
          else kops.wcsd_profile_ragged)
    out = op(hub, dist, wlev, tile_lo, tile_hi, qidx, stile, ttile, first,
             num_rows=int(s.shape[0]) + 1, num_levels=num_levels)
    return out[: s.shape[0]]


@dataclasses.dataclass
class QuerySubBatch:
    """One bucket-pair slice of an incoming batch (see `plan_query_batch`)."""
    bucket_s: int
    bucket_t: int
    positions: np.ndarray  # [n] indices into the original batch


def plan_query_batch(bucket_of: np.ndarray, s: np.ndarray, t: np.ndarray,
                     num_buckets: int | None = None) -> list[QuerySubBatch]:
    """Group a (s, t) batch by the (bucket(s), bucket(t)) pair (host
    numpy). Sub-batches come back in (bucket_s, bucket_t) order, and
    their position arrays partition ``arange(len(s))`` (stable within a
    pair). ``num_buckets`` (the store's bucket count) spares the O(V)
    ``bucket_of.max()`` scan."""
    bucket_of = np.asarray(bucket_of)
    bs = bucket_of[np.asarray(s)]
    bt = bucket_of[np.asarray(t)]
    if num_buckets is not None:
        nb = int(num_buckets)
    else:
        nb = int(bucket_of.max()) + 1 if len(bucket_of) else 1
    key = bs.astype(np.int64) * nb + bt
    order = np.argsort(key, kind="stable")
    uniq, starts = np.unique(key[order], return_index=True)
    bounds = np.append(starts, len(order))
    return [QuerySubBatch(bucket_s=int(k // nb), bucket_t=int(k % nb),
                          positions=order[a:b])
            for k, a, b in zip(uniq, bounds[:-1], bounds[1:])]


def stage_sub_batch(slot_of, pos, s, t, w_level=None) -> np.ndarray:
    """The queries at ``pos`` as one staging array: [3, n] (srow, trow,
    wq), or [2, n] (srow, trow) for profiles (``w_level`` None). This is
    the reference's `_pad_sub_batch` without its pad lanes, which exist
    only to bound jit shapes: the kernels take any batch size."""
    rows = [slot_of[s[pos]], slot_of[t[pos]]]
    if w_level is not None:
        rows.append(w_level[pos])
    return np.stack(rows).astype(np.int32)


class PendingResult:
    """Handle to an in-flight query batch.

    The device work is already enqueued when the handle is created;
    `wait()` copies the answers to the host (once — the handle caches).
    `ready()` probes without blocking: on the card it queries the CUDA
    events recorded right after the batch's last launch on each device
    it used (one for a single-device engine, one per physical device of
    a sharded engine's mesh); on the CPU the work is already done.
    """

    def __init__(self, finalize, events=()):
        self._finalize = finalize
        self._events = tuple(events)
        self._out = None
        # absolute `time.monotonic()` seconds, stamped by the server's
        # flush watchdog at dispatch (None: no deadline)
        self.deadline = None

    def ready(self) -> bool:
        if self._finalize is None:
            return True
        return all(bool(e.query()) for e in self._events)

    def wait(self) -> np.ndarray:
        if self._finalize is not None:
            self._out = np.asarray(self._finalize())
            self._finalize = None
            self._events = ()
        return self._out


def _record_event(device: torch.device):
    """A CUDA event recorded now on ``device``'s current stream."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _pending(res: torch.Tensor, finalize) -> PendingResult:
    """A handle over ``res``, the batch's last device result: one CUDA
    event recorded after it on the current stream."""
    events = ()
    if res.device.type == "cuda":
        events = (_record_event(res.device),)
    return PendingResult(finalize, events)


class DeviceQueryEngine:
    """Holds a label store on the device and answers query batches.

    ``layout="csr"`` (default), ``dispatch="ragged"``: each flush is ONE
    kernel launch over the lane-tiled `LabelArena`, planned by a
    device-emitted tile-pair worklist. ``compressed=True`` serves the
    `CompressedArena` instead (int16 hub deltas, bfloat16 distances, int8
    levels, decoded in the kernel); a store with any tile the format
    cannot hold is served uncompressed, with ``compressed`` False and
    ``compression_overflow`` True.

    ``layout="csr"``, ``dispatch="bucket_pair"``: the host planner groups
    each flush by (bucket(s), bucket(t)) over the padded bucket tiles; a
    scalar flush is one K7 launch over all its groups, a profile flush
    one K8 launch per group; the answers come back in batch order from
    one handle. It does not take ``compressed=True`` (ValueError),
    as in the reference.

    ``layout="padded"``: the ``[V, L]`` store (``cap`` trims rows, see
    `PackedLabels.to_padded`; ``dispatch`` reads "dense"). A batch is one
    K9 launch with ``use_pallas=True``, the plain `query_batch_torch` with
    ``use_pallas=False``; profiles are `profile_batch_torch` either way.
    The CSR layouts run only their kernels: ``use_pallas=False`` with
    ``layout="csr"`` raises ValueError (``device="cpu"`` is how their
    plain versions run).

    Runs on the card unless ``device="cpu"`` (the kernels' plain
    versions). The reference defaults to ``layout="padded"``; the port
    defaults to ``"csr"`` (same answers).
    """

    def __init__(self, idx: PackedWCIndex, layout: str = "csr",
                 dispatch: str = "ragged", lane: int | None = None,
                 compressed: bool = False, cap: int | None = None,
                 use_pallas: bool = True, device=None):
        if layout not in ("padded", "csr"):
            raise ValueError(f"unknown layout: {layout!r}")
        if dispatch not in ("ragged", "bucket_pair"):
            raise ValueError(f"unknown dispatch: {dispatch!r}")
        if layout == "csr" and cap is not None:
            raise ValueError("cap (label-row trimming) only applies to the "
                             "padded layout; the CSR store keeps exact rows")
        if layout == "csr" and not use_pallas:
            raise ValueError("use_pallas=False runs the plain padded join: "
                             "it needs layout='padded' (the CSR layouts run "
                             "their kernels; device='cpu' runs their plain "
                             "versions)")
        if compressed and (layout, dispatch) != ("csr", "ragged"):
            raise ValueError("compressed=True requires layout='csr' with "
                             "dispatch='ragged' (only the arena kernels "
                             "decode the compressed tile format)")
        self.device = resolve_device(device)
        self.layout = layout
        self.use_pallas = bool(use_pallas)
        self.num_levels = idx.num_levels
        self.compressed = False
        self.compression_overflow = False
        if layout == "padded":
            self.dispatch = "dense"
            store = _build_padded_store(idx, cap, lane_pad=self.use_pallas)
            self.padded_bytes = sum(int(a.nbytes) for a in store)
            self.hub, self.dist, self.wlev, self.count = (
                torch.from_numpy(a).to(self.device) for a in store)
            return
        self.dispatch = dispatch
        lane = LANE if lane is None else int(lane)
        self.lane = lane
        packed = idx.packed(lane=lane)
        self.packed = packed
        self._bucket_of = packed.bucket_of
        self._slot_of = packed.slot_of
        self.num_buckets = packed.num_buckets
        if dispatch == "bucket_pair":
            self._tiles = [tuple(torch.from_numpy(a).to(self.device)
                                 for a in packed.bucket_tiles(b))
                           for b in range(packed.num_buckets)]
            return
        ar = packed.arena(lane=lane)
        self.arena = ar
        self._tile_cnt_np = ar.tile_cnt
        trio = (ar.hub, ar.dist, ar.wlev)
        if compressed:
            comp = packed.compressed_arena(lane=lane)
            if comp.num_overflow_tiles:
                # the store does not fit the format (hub-delta / level /
                # distance range): serve uncompressed and say so
                self.compression_overflow = True
            else:
                self.compressed = True
                trio = (comp.hub_delta, comp.dist.view(np.int16), comp.wlev)
        arena = [torch.from_numpy(a).to(self.device)
                 for a in trio + (ar.tile_lo, ar.tile_hi, ar.tile_base,
                                  ar.tile_cnt)]
        if self.compressed:   # the uint16 bit patterns, seen as floats
            arena[1] = arena[1].view(FLOAT_DTYPES[comp.dist_dtype])
        self._arena = tuple(arena)

    def _stage_ragged(self, s, t, w_level=None):
        """One [3 or 2, B] staging array for a ragged (or padded-layout)
        flush: exactly the batch, no pad lanes (the reference pads the
        batch to a power of two to bound its jit shapes; the kernels here
        take any size)."""
        rows = (s, t) if w_level is None else (s, t, w_level)
        return np.stack([np.asarray(r, np.int32) for r in rows])

    def _put(self, stq: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(stq).to(self.device)

    def query(self, s, t, w_level) -> np.ndarray:
        """[B] int32 distances (INF_DIST where no feasible path)."""
        return self.query_async(s, t, w_level).wait()

    def query_async(self, s, t, w_level) -> PendingResult:
        """Enqueue a batch without waiting: every launch of the flush is
        issued when this returns."""
        s = np.asarray(s, np.int32)
        t = np.asarray(t, np.int32)
        w_level = np.asarray(w_level, np.int32)
        if self.dispatch == "bucket_pair":
            return self._query_segmented_async(s, t, w_level)
        stq = self._stage_ragged(s, t, w_level)
        if self.dispatch == "dense":
            res = self._query_dense(self._put(stq))
            return _pending(res, lambda: res.cpu().numpy())
        wl_len = ragged_worklist_len(self._tile_cnt_np, stq[0], stq[1])
        res = ragged_query_batch(*self._arena, self._put(stq),
                                 worklist_len=wl_len,
                                 compressed=self.compressed)
        return _pending(res, lambda: res.cpu().numpy())

    def query_profile(self, s, t) -> np.ndarray:
        """[B, W + 1] staircases: ``out[b, w] == query(s, t, w)[b]`` for
        every level, from one label sweep."""
        return self.query_profile_async(s, t).wait()

    def query_profile_async(self, s, t) -> PendingResult:
        s = np.asarray(s, np.int32)
        t = np.asarray(t, np.int32)
        if self.dispatch == "bucket_pair":
            return self._profile_segmented_async(s, t)
        stq = self._stage_ragged(s, t)
        if self.dispatch == "dense":
            res = self._profile_dense(self._put(stq))
            return _pending(res, lambda: res.cpu().numpy())
        wl_len = ragged_worklist_len(self._tile_cnt_np, stq[0], stq[1])
        res = ragged_profile_batch(*self._arena, self._put(stq),
                                   worklist_len=wl_len,
                                   num_levels=self.num_levels,
                                   compressed=self.compressed)
        return _pending(res, lambda: res.cpu().numpy())

    # ------------------------------------------------------ padded layout
    def _query_dense(self, stq: torch.Tensor) -> torch.Tensor:
        store = (self.hub, self.dist, self.wlev, self.count)
        if self.use_pallas:
            return kops.wcsd_query(*store, stq[0], stq[1], stq[2])
        return query_batch_torch(*store, stq[0], stq[1], stq[2])

    def _profile_dense(self, stq: torch.Tensor) -> torch.Tensor:
        # the padded layout profiles with the plain join for either
        # setting, as the reference does (its XLA path)
        return profile_batch_torch(self.hub, self.dist, self.wlev,
                                   self.count, stq[0], stq[1],
                                   num_levels=self.num_levels)

    # ------------------------------------------------ bucket-pair dispatch
    def _plan(self, s, t, w_level):
        """Plan on the host and stage every sub-batch (exactly, no pads)
        into one [3 or 2, B] array in plan order. Returns (plan, pos,
        staged) with ``pos`` the batch position of each staged column."""
        plan = plan_query_batch(self._bucket_of, s, t,
                                num_buckets=self.num_buckets)
        if not plan:
            return plan, None, None
        pos = np.concatenate([sub.positions for sub in plan])
        return plan, pos, stage_sub_batch(self._slot_of, pos, s, t, w_level)

    @staticmethod
    def _scattered(res: torch.Tensor, pos, shape) -> PendingResult:
        """A handle over ``res`` (answers in plan order) that scatters them
        back into batch order on `wait()`."""
        def assemble():
            out = np.empty(shape, np.int32)
            out[pos] = res.cpu().numpy()
            return out
        return _pending(res, assemble)

    def _groups(self, plan):
        """The flush's sub-batches as `GroupedFlush` takes them: (s-side
        tiles, t-side tiles, query count) in plan order."""
        return [(self._tiles[sub.bucket_s], self._tiles[sub.bucket_t],
                 len(sub.positions)) for sub in plan]

    def _query_segmented_async(self, s, t, w_level) -> PendingResult:
        """One K7 launch for the whole flush: the sub-batches' table and
        the staged queries go to the device in one copy."""
        plan, pos, stq = self._plan(s, t, w_level)
        if not plan:
            return PendingResult(lambda: np.zeros(len(s), np.int32))
        res = kops.wcsd_query_segmented_grouped(
            GroupedFlush(self._groups(plan), stq, self.device))
        return self._scattered(res, pos, (len(s),))

    def _profile_segmented_async(self, s, t) -> PendingResult:
        """One K8 launch for the whole flush, staged as a scalar flush is
        (the staged array is [2, B]: no levels)."""
        plan, pos, stq = self._plan(s, t, None)
        shape = (len(s), self.num_levels + 1)
        if not plan:
            return PendingResult(lambda: np.zeros(shape, np.int32))
        res = kops.wcsd_profile_segmented_grouped(
            GroupedFlush(self._groups(plan), stq, self.device),
            num_levels=self.num_levels)
        return self._scattered(res, pos, shape)

    def query_from_quality(self, s, t, w: np.ndarray, levels: np.ndarray):
        """Real-valued thresholds -> levels (exact canonicalization)."""
        wl = np.searchsorted(levels, np.asarray(w), side="left")
        return self.query(s, t, wl.astype(np.int32))


@dataclasses.dataclass
class RowShardedFlush:
    """A row-sharded ragged flush after its host plan and tile gather
    (`ShardedQueryEngine._row_sharded_flush`)."""
    stq: np.ndarray     # [3 or 2, Q] staged batch, balanced, shard-major
    perm: np.ndarray    # answers un-permute as ``out[perm] = res``
    lens: list          # each shard's exact worklist length
    uniq: np.ndarray    # [ndev, G] each shard's gathered tile ids, sorted
    gathered: list      # per shard, its gathered (hub, dist, wlev) tiles
    staged: dict        # stq on each physical device
    plan: dict          # uniq on each physical device


def _on(device: torch.device):
    """The device context a shard's launches run under: the ctypes
    launchers enqueue on the current stream of the tensors' device, and a
    kernel launch goes to the current CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedQueryEngine:
    """The label store on a mesh of shards (`launch.mesh.ServingMesh`),
    each query batch split over them; port of the reference's
    `ShardedQueryEngine`.

    One process drives every shard, as the reference's single controller
    does: each shard's plan and kernel launch is issued here, on the
    shard's device. Two placements, chosen by ``device_budget_bytes``
    against the bytes of the store actually served (compressed or not):

    ``mode="replicated"`` (the store fits, or no budget): the arrays are
    held once per distinct physical device and shared by that device's
    shards; shard k answers the k-th contiguous slice of the staged
    batch. ``dispatch="ragged"``: each shard emits its slice's worklist
    and launches one K1 / K2 (K5 / K6 compressed) over the shared arena,
    one launch per shard per flush. ``dispatch="bucket_pair"``: every
    planned sub-batch is padded to a shard multiple and split over the
    shards, and each shard's slice of the flush is one grouped K7 / K8
    launch. ``layout="padded"``: K9 per shard with ``use_pallas=True``
    (else `query_batch_torch`); profiles `profile_batch_torch`.

    ``mode="sharded_labels"`` (the store exceeds the budget): the tile-
    or vertex-row axis is padded to a shard multiple (pads: hub -1, wlev
    -1, dist INF_DIST, or +inf in the compressed float format) and split
    into contiguous blocks. ``dispatch="ragged"``: the batch is
    load-balanced on the host (`_balance_ragged`), each shard's distinct
    tiles are planned (`_gather_plan`) and delivered by one
    `ragged_tile_gather`; each shard then emits its slice's worklist,
    relabels it into the gathered buffer and launches one K1 / K2 / K5 /
    K6 over it. Bucket-pair: per sub-batch, one
    `multi_row_gather_psum_scatter` hands each shard the rows of its
    slice, and each shard's gathered tiles of the whole flush go through
    one grouped K7 / K8 launch. Padded: one gather hands each shard both
    sides' rows of its slice, joined by K9 (``use_pallas=True``, else
    `query_batch_torch`); profiles `profile_batch_torch`. (The reference
    runs jnp joins on these two gathered paths.) Every placement
    launches each kernel once per shard per flush.

    Every answer is a per-query integer min, so the answers equal
    `DeviceQueryEngine`'s on the same index. A batch is padded to a shard
    multiple only (pad lanes: the arena's fewest-tile vertex at an
    infeasible level); the kernels take any size. Runs on the mesh's
    devices: ``mesh=None`` is every visible CUDA device (and raises
    without one). The CSR layouts run only their kernels:
    ``use_pallas=False`` with ``layout="csr"`` raises `ValueError`.
    """

    def __init__(self, idx: PackedWCIndex, mesh=None, cap: int | None = None,
                 use_pallas: bool = True, layout: str = "csr",
                 device_budget_bytes: int | None = None,
                 multi_pod: bool = False, dispatch: str = "ragged",
                 lane: int | None = None, compressed: bool = False):
        if layout not in ("padded", "csr"):
            raise ValueError(f"unknown layout: {layout!r}")
        if dispatch not in ("ragged", "bucket_pair"):
            raise ValueError(f"unknown dispatch: {dispatch!r}")
        if layout == "csr" and cap is not None:
            raise ValueError("cap (label-row trimming) only applies to the "
                             "padded layout; the CSR store keeps exact rows")
        if layout == "csr" and not use_pallas:
            raise ValueError("use_pallas=False runs the plain padded join: "
                             "it needs layout='padded'")
        if compressed and (layout, dispatch) != ("csr", "ragged"):
            raise ValueError("compressed=True requires layout='csr' with "
                             "dispatch='ragged' (only the arena kernels "
                             "decode the compressed tile format)")
        if mesh is None:
            from ..launch.mesh import make_serving_mesh
            mesh = make_serving_mesh(multi_pod=multi_pod)
        self.mesh = mesh
        self.batch_axes = tuple(a for a in mesh.axis_names
                                if a in ("pod", "data"))
        if not self.batch_axes:
            raise ValueError(f"mesh axes {mesh.axis_names} carry no "
                             "('pod', 'data') batch axis")
        self.ndev = int(np.prod([mesh.shape[mesh.axis_names.index(a)]
                                 for a in self.batch_axes]))
        self.devices = tuple(mesh.devices)
        self.device = self.devices[0]
        self.layout = layout
        self.use_pallas = bool(use_pallas)
        self.num_levels = idx.num_levels
        self.compressed = False
        self.compression_overflow = False

        if layout == "csr":
            lane = LANE if lane is None else int(lane)
            self.lane = lane
            packed = idx.packed(lane=lane)
            self.packed = packed
            self._bucket_of = packed.bucket_of
            self._slot_of = packed.slot_of
            self.num_buckets = packed.num_buckets
            if dispatch == "ragged":
                ar = packed.arena(lane=lane)
                self.arena = ar
                src = ar
                if compressed:
                    comp = packed.compressed_arena(lane=lane)
                    if comp.num_overflow_tiles:
                        self.compression_overflow = True
                    else:
                        self.compressed = True
                        src = comp
                # the decision sees the bytes the chosen arena costs
                self.store_bytes_per_device = src.memory_bytes()
            else:
                self.store_bytes_per_device = packed.tile_memory_bytes()
        else:
            store = _build_padded_store(idx, cap, lane_pad=self.use_pallas)
            self.store_bytes_per_device = int(sum(a.nbytes for a in store))
        self.mode = ("replicated"
                     if device_budget_bytes is None
                     or self.store_bytes_per_device <= device_budget_bytes
                     else "sharded_labels")
        if self.mode == "sharded_labels":
            self.store_bytes_per_device = ceil_to(
                self.store_bytes_per_device, self.ndev) // self.ndev
        self.dispatch = dispatch if layout == "csr" else "dense"

        if layout == "padded":
            if self.mode == "sharded_labels":
                self._blocks, self._rows_per = self._shard_store_rows(
                    store[:3], store[3])
            else:
                self._store = self._replicate(store)
        elif self.dispatch == "ragged":
            self._tile_cnt_np = ar.tile_cnt
            self._tile_base_np = ar.tile_base
            self._num_tiles_np = int(ar.num_tiles)
            self._pad_vertex = int(np.argmin(ar.tile_cnt))
            if self.compressed:
                trio = (comp.hub_delta, comp.dist.view(np.int16), comp.wlev)
                self._dist_dtype = FLOAT_DTYPES[comp.dist_dtype]
                dfill = int(float16_bits(np.array([np.inf]),
                                         comp.dist_dtype).view(np.int16)[0])
            else:
                trio = (ar.hub, ar.dist, ar.wlev)
                dfill = INF_DIST
            self._tables = self._replicate(
                (ar.tile_lo, ar.tile_hi, ar.tile_base, ar.tile_cnt))
            if self.mode == "sharded_labels":
                self._blocks = self._shard_arena_tiles(trio, dfill)
            else:
                trio = self._replicate(trio)
                self._arena = [self._dist_view(tr) + tb
                               for tr, tb in zip(trio, self._tables)]
        else:
            tiles = [packed.bucket_tiles(b)
                     for b in range(packed.num_buckets)]
            if self.mode == "sharded_labels":
                self._tiles = [self._shard_tile_rows(tl) for tl in tiles]
            else:
                per_b = [self._replicate(tl) for tl in tiles]
                self._tiles = [[per_b[b][k] for b in range(len(tiles))]
                               for k in range(self.ndev)]

    # ------------------------------------------------------------ placement
    def _replicate(self, arrays):
        """``arrays`` once on each physical device; returns per shard the
        tuple of its device's copies (shards of one device share them)."""
        copies = {dev: tuple(torch.from_numpy(np.ascontiguousarray(a))
                             .to(dev) for a in arrays)
                  for dev in dict.fromkeys(self.devices)}
        return [copies[dev] for dev in self.devices]

    def _split_rows(self, arrays, fills):
        """Pad the row axis of each array to a shard multiple with its
        fill and split it into per-shard blocks on the shards' devices.
        Returns (the per-shard blocks of each array, rows per shard)."""
        n = arrays[0].shape[0]
        npad = ceil_to(max(n, 1), self.ndev)
        per = npad // self.ndev
        out = []
        for a, fill in zip(arrays, fills):
            if npad != n:
                a = np.pad(a, ((0, npad - n),) + ((0, 0),) * (a.ndim - 1),
                           constant_values=fill)
            out.append([torch.from_numpy(np.ascontiguousarray(
                a[k * per:(k + 1) * per])).to(dev)
                for k, dev in enumerate(self.devices)])
        return out, per

    def _shard_tile_rows(self, tiles):
        """One bucket's [n, W] tiles, row-sharded (standard pad
        contract): ((hub, dist, wlev) per-shard blocks, rows per shard)."""
        return self._split_rows(tiles, (-1, INF_DIST, -1))

    def _shard_arena_tiles(self, trio, dist_fill: int):
        """The arena trio, tile-row-sharded. Pad tiles are never named by
        a worklist (tile_base / tile_cnt address real tiles only); the
        compressed dist pad is +inf's bit pattern. Records the block
        height for the tile gather."""
        blocks, self._tiles_per = self._split_rows(trio, (-1, dist_fill, -1))
        return blocks

    def _shard_store_rows(self, arrays, count):
        """The padded store, vertex-row-sharded (count 0 at pad rows):
        (per-shard blocks of hub, dist, wlev and count, rows per
        shard)."""
        return self._split_rows(tuple(arrays) + (count,),
                                (-1, INF_DIST, -1, 0))

    def _dist_view(self, trio):
        """The compressed dist is held as int16 bit patterns; the kernels
        see the float format."""
        if not self.compressed:
            return tuple(trio)
        return (trio[0], trio[1].view(self._dist_dtype), trio[2])

    # ----------------------------------------------------------- plumbing
    def _batch_pad(self, n: int) -> int:
        """A batch is padded to a shard multiple (at least one query a
        shard), not to a power of two: the kernels take any size."""
        return ceil_to(max(n, 1), self.ndev)

    def _stage_ragged(self, s, t, w_level=None):
        """One [3 or 2, Q] staging array, Q a shard multiple. Pad lanes
        use the arena's fewest-tile vertex at an infeasible level (a
        hub-heavy vertex would cost every pad lane its tile count squared
        in worklist items)."""
        n = len(s)
        Q = self._batch_pad(n)
        if w_level is not None:
            stq = np.full((3, Q), self._pad_vertex, dtype=np.int32)
            stq[2, :] = self.num_levels + 1
            stq[2, :n] = w_level
        else:
            stq = np.full((2, Q), self._pad_vertex, dtype=np.int32)
        stq[0, :n] = s
        stq[1, :n] = t
        return stq

    def _put(self, arr: np.ndarray) -> dict:
        """A host array on every physical device of the mesh, one copy
        each."""
        return {dev: torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
                for dev in dict.fromkeys(self.devices)}

    def _pending_shards(self, outs, finish) -> PendingResult:
        """One handle over every shard's result (``outs[k]`` on shard k's
        device, rows in shard order): each physical device's results are
        concatenated there and copied in one transfer, and a CUDA event is
        recorded after them on each device, so `ready()` holds only when
        every shard's work is done. ``finish`` maps the concatenated host
        rows (shard order) to the answer."""
        by_dev: dict = {}
        for k, r in enumerate(outs):
            by_dev.setdefault(r.device, []).append(k)
        cats, events = {}, []
        for dev, ks in by_dev.items():
            with _on(dev):
                cats[dev] = (torch.cat([outs[k] for k in ks])
                             if len(ks) > 1 else outs[ks[0]])
                if dev.type == "cuda":
                    events.append(_record_event(dev))
        sizes = [int(r.shape[0]) for r in outs]

        def finalize():
            parts = [None] * len(outs)
            for dev, ks in by_dev.items():
                host = cats[dev].cpu().numpy()
                off = 0
                for k in ks:
                    parts[k] = host[off:off + sizes[k]]
                    off += sizes[k]
            return finish(np.concatenate(parts))
        return PendingResult(finalize, events)

    # ------------------------------------------------------------ queries
    def query(self, s, t, w_level) -> np.ndarray:
        """[B] int32 distances (INF_DIST where no feasible path)."""
        return self.query_async(s, t, w_level).wait()

    def query_async(self, s, t, w_level) -> PendingResult:
        """Enqueue a batch on every shard without waiting."""
        s = np.asarray(s, np.int32)
        t = np.asarray(t, np.int32)
        w_level = np.asarray(w_level, np.int32)
        if self.dispatch == "ragged":
            return self._ragged_async(s, t, w_level)
        if self.dispatch == "bucket_pair":
            return self._segmented_async(s, t, w_level)
        return self._padded_async(s, t, w_level)

    def query_profile(self, s, t) -> np.ndarray:
        """[B, W + 1] staircases, equal to `DeviceQueryEngine.
        query_profile` on the same index."""
        return self.query_profile_async(s, t).wait()

    def query_profile_async(self, s, t) -> PendingResult:
        s = np.asarray(s, np.int32)
        t = np.asarray(t, np.int32)
        if self.dispatch == "ragged":
            return self._ragged_async(s, t, None)
        if self.dispatch == "bucket_pair":
            return self._segmented_async(s, t, None)
        return self._padded_async(s, t, None)

    def query_from_quality(self, s, t, w: np.ndarray, levels: np.ndarray):
        """Real-valued thresholds -> levels (exact canonicalization)."""
        wl = np.searchsorted(levels, np.asarray(w), side="left")
        return self.query(s, t, wl.astype(np.int32))

    # ----------------------------------------------------- ragged dispatch
    def _shard_worklist_lens(self, stq) -> list:
        """Each shard's worklist length for a flush staged shard-major:
        the exact tile-pair count of its slice (the reference rounds a
        replicated flush's capacity up to a power of two and a balanced
        one to a multiple of 512, to bound its jit shapes; the kernels
        here take any length, so no pad items are launched)."""
        b = stq.shape[1] // self.ndev
        return [ragged_worklist_len(self._tile_cnt_np,
                                    stq[0, k * b:(k + 1) * b],
                                    stq[1, k * b:(k + 1) * b])
                for k in range(self.ndev)]

    def _balance_ragged(self, stq):
        """Load-balanced shard assignment for a row-sharded flush: queries
        dealt in descending tile-pair cost, each round handing the
        heaviest remaining ones to the least-loaded shards
        (capacity-constrained LPT: every shard gets exactly Q / ndev).
        Returns (stq reordered shard-major, perm); answers are
        un-permuted with ``out[perm] = res``."""
        ndev = self.ndev
        if ndev == 1:
            return stq, np.arange(stq.shape[1])
        tc = self._tile_cnt_np
        c = tc[stq[0]].astype(np.int64) * tc[stq[1]]
        order = np.argsort(-c, kind="stable")
        b = stq.shape[1] // ndev
        load = np.zeros(ndev, np.int64)
        perm = np.empty(stq.shape[1], np.int64)
        cs = c[order].reshape(b, ndev)
        ob = order.reshape(b, ndev)
        for blk in range(b):
            dst = np.argsort(load, kind="stable")
            perm[dst * b + blk] = ob[blk]
            load[dst] += cs[blk]
        return stq[:, perm], perm

    def _gather_plan(self, stq) -> np.ndarray:
        """Per shard, the sorted DISTINCT arena tiles its batch slice can
        name (the union of its vertices' tile ranges), padded to the
        largest shard's count with the arena's last tile id, which keeps
        each row sorted for the relabelling search. Returns uniq [ndev,
        G] int32."""
        ndev = self.ndev
        b = stq.shape[1] // ndev
        tb, tc = self._tile_base_np, self._tile_cnt_np
        uniqs = []
        for k in range(ndev):
            v = np.unique(np.concatenate([stq[0, k * b:(k + 1) * b],
                                          stq[1, k * b:(k + 1) * b]]))
            cnt = tc[v].astype(np.int64)
            ends = np.cumsum(cnt)
            idx = np.arange(int(ends[-1]))
            own = np.searchsorted(ends, idx, side="right")
            uniqs.append(np.unique(
                tb[v][own] + (idx - (ends[own] - cnt[own]))).astype(np.int32))
        G = max(len(u) for u in uniqs)
        uniq = np.full((ndev, G), self._num_tiles_np - 1, dtype=np.int32)
        for k, u in enumerate(uniqs):
            uniq[k, :len(u)] = u
        return uniq

    def _ragged_async(self, s, t, w_level) -> PendingResult:
        n = len(s)
        profile = w_level is None
        stq = self._stage_ragged(s, t, w_level)
        if self.mode == "sharded_labels":
            return self._ragged_sharded(stq, n, profile)
        lens = self._shard_worklist_lens(stq)
        b = stq.shape[1] // self.ndev
        staged = self._put(stq)
        outs = []
        for k, dev in enumerate(self.devices):
            st = staged[dev][:, k * b:(k + 1) * b]
            with _on(dev):
                if profile:
                    outs.append(ragged_profile_batch(
                        *self._arena[k], st, worklist_len=lens[k],
                        num_levels=self.num_levels,
                        compressed=self.compressed))
                else:
                    outs.append(ragged_query_batch(
                        *self._arena[k], st, worklist_len=lens[k],
                        compressed=self.compressed))
        return self._pending_shards(outs, lambda r: r[:n])

    def _row_sharded_flush(self, stq) -> RowShardedFlush:
        """A row-sharded ragged flush's host plan and tile gather: the
        batch balanced over the shards, each shard's worklist length and
        distinct tiles, one `ragged_tile_gather`, and the staged batch and
        tile lists on every physical device."""
        from ..distributed.collectives import ragged_tile_gather
        stq, perm = self._balance_ragged(stq)
        uniq = self._gather_plan(stq)
        return RowShardedFlush(
            stq=stq, perm=perm, lens=self._shard_worklist_lens(stq),
            uniq=uniq,
            gathered=ragged_tile_gather(self._blocks, uniq.reshape(-1),
                                        self._tiles_per),
            staged=self._put(stq), plan=self._put(uniq))

    def _shard_launch_args(self, fl: RowShardedFlush, k: int):
        """Shard k's K1 / K2 (K5 / K6) launch over its gathered tiles:
        its slice's worklist, relabelled into the gathered buffer (the
        worklist pads name tile 0, which lands on gathered tile 0 and
        feeds the trash row). Returns (hub, dist, wlev, tile_lo, tile_hi,
        qidx, sloc, tloc, first) and the level column with the trash
        row's level appended (None for a profile flush); the output has
        ``b + 1`` rows. Runs under the shard's device."""
        dev = self.devices[k]
        b = fl.stq.shape[1] // self.ndev
        lo, hi, base, cnt = self._tables[k]
        st = fl.staged[dev][:, k * b:(k + 1) * b]
        u = fl.plan[dev][k]
        qidx, stile, ttile, first = emit_ragged_worklist(
            base, cnt, st[0], st[1], worklist_len=fl.lens[k])
        sloc = torch.searchsorted(u, stile, out_int32=True)
        tloc = torch.searchsorted(u, ttile, out_int32=True)
        ul = u.long()
        args = self._dist_view(fl.gathered[k]) + (
            lo[ul], hi[ul], qidx, sloc, tloc, first)
        wq = None
        if fl.stq.shape[0] == 3:
            wq = torch.cat([st[2], torch.full(
                (1,), TRASH_LEVEL, dtype=torch.int32, device=dev)])
        return args, wq

    def _ragged_sharded(self, stq, n: int, profile: bool) -> PendingResult:
        """A row-sharded ragged flush: host plan, one tile gather, then per
        shard one kernel launch over its gathered tiles."""
        fl = self._row_sharded_flush(stq)
        b = stq.shape[1] // self.ndev
        outs = []
        for k, dev in enumerate(self.devices):
            with _on(dev):
                args, wq = self._shard_launch_args(fl, k)
                if profile:
                    op = (kops.wcsd_profile_ragged_compressed
                          if self.compressed else kops.wcsd_profile_ragged)
                    out = op(*args, num_rows=b + 1,
                             num_levels=self.num_levels)
                else:
                    op = (kops.wcsd_query_ragged_compressed
                          if self.compressed else kops.wcsd_query_ragged)
                    out = op(*args, wq)
                outs.append(out[:b])

        def finish(res):
            out = np.empty_like(res)
            out[fl.perm] = res
            return out[:n]
        return self._pending_shards(outs, finish)

    # ------------------------------------------------ bucket-pair dispatch
    def _split_plan(self, s, t, w_level):
        """The flush's sub-batches, each padded to a shard multiple (pads:
        slot 0 at an infeasible level) and split over the shards. Returns
        (plan, per shard: [3 or 2, *] staging in plan order and the batch
        position of each column, -1 at pads)."""
        plan = plan_query_batch(self._bucket_of, s, t,
                                num_buckets=self.num_buckets)
        rows = 2 if w_level is None else 3
        per_shard = [([], []) for _ in range(self.ndev)]
        for sub in plan:
            pos = sub.positions
            m = len(pos)
            c = self._batch_pad(m) // self.ndev
            st = np.zeros((rows, c * self.ndev), dtype=np.int32)
            pp = np.full(c * self.ndev, -1, dtype=np.int64)
            st[:, :m] = stage_sub_batch(self._slot_of, pos, s, t, w_level)
            if w_level is not None:
                st[2, m:] = self.num_levels + 1
            pp[:m] = pos
            for k in range(self.ndev):
                per_shard[k][0].append(st[:, k * c:(k + 1) * c])
                per_shard[k][1].append(pp[k * c:(k + 1) * c])
        return plan, [(np.concatenate(a, axis=1), np.concatenate(p))
                      for a, p in per_shard]

    def _segmented_async(self, s, t, w_level) -> PendingResult:
        profile = w_level is None
        shape = ((len(s), self.num_levels + 1) if profile else (len(s),))
        plan, shards = self._split_plan(s, t, w_level)
        if not plan:
            return PendingResult(lambda: np.zeros(shape, np.int32))
        if self.mode == "sharded_labels":
            groups, staged = self._gathered_groups(plan, shards)
        else:
            cols = self._sub_cols(plan)
            groups = [[(self._tiles[k][sub.bucket_s],
                        self._tiles[k][sub.bucket_t], c)
                       for sub, c in zip(plan, cols)]
                      for k in range(self.ndev)]
            staged = [st for st, _ in shards]
        outs = []
        for k, dev in enumerate(self.devices):
            with _on(dev):
                flush = GroupedFlush(groups[k], staged[k], dev)
                if profile:
                    outs.append(kops.wcsd_profile_segmented_grouped(
                        flush, num_levels=self.num_levels))
                else:
                    outs.append(kops.wcsd_query_segmented_grouped(flush))
        pos = np.concatenate([p for _, p in shards])

        def finish(res):
            out = np.empty(shape, np.int32)
            real = pos >= 0
            out[pos[real]] = res[real]
            return out
        return self._pending_shards(outs, finish)

    def _sub_cols(self, plan):
        """Columns each shard holds of every planned sub-batch."""
        return [self._batch_pad(len(sub.positions)) // self.ndev
                for sub in plan]

    def _gathered_groups(self, plan, shards):
        """Row-sharded bucket tiles: per sub-batch, one gather hands every
        shard the s-side and t-side rows of its slice, in slice order, so
        row i of both is the slice's query i. Returns per shard its
        `GroupedFlush` groups (gathered s tiles, gathered t tiles,
        columns) and its staged array (rows ``arange`` of each group, and
        the levels of a scalar flush)."""
        from ..distributed.collectives import multi_row_gather_psum_scatter
        cols = self._sub_cols(plan)
        offs = np.concatenate([[0], np.cumsum(cols)])
        groups = [[] for _ in range(self.ndev)]
        for i, sub in enumerate(plan):
            side = []
            for row, bucket in ((0, sub.bucket_s), (1, sub.bucket_t)):
                ids = np.concatenate([shards[k][0][row, offs[i]:offs[i + 1]]
                                      for k in range(self.ndev)])
                blocks, per = self._tiles[bucket]
                side.append(multi_row_gather_psum_scatter(blocks, ids, per))
            for k in range(self.ndev):
                groups[k].append((side[0][k], side[1][k], cols[i]))
        slots = np.concatenate([np.arange(c, dtype=np.int32) for c in cols])
        staged = [np.concatenate([np.stack([slots, slots]), st[2:]])
                  for st, _ in shards]
        return groups, staged

    # ------------------------------------------------------ padded layout
    def _padded_async(self, s, t, w_level) -> PendingResult:
        n = len(s)
        profile = w_level is None
        Q = self._batch_pad(n)
        stq = np.zeros((2 if profile else 3, Q), dtype=np.int32)
        stq[0, :n], stq[1, :n] = s, t
        if not profile:
            stq[2, :] = self.num_levels + 1
            stq[2, :n] = w_level
        b = Q // self.ndev
        W = self.num_levels
        if self.mode == "sharded_labels":
            outs = self._padded_sharded(stq, b, profile)
        else:
            staged = self._put(stq)
            outs = []
            for k, dev in enumerate(self.devices):
                st = staged[dev][:, k * b:(k + 1) * b]
                store = self._store[k]
                with _on(dev):
                    if profile:
                        outs.append(profile_batch_torch(
                            *store, st[0], st[1], num_levels=W))
                    elif self.use_pallas:
                        outs.append(kops.wcsd_query(*store, st[0], st[1],
                                                    st[2]))
                    else:
                        outs.append(query_batch_torch(*store, st[0], st[1],
                                                      st[2]))
        return self._pending_shards(outs, lambda r: r[:n])

    def _padded_sharded(self, stq, b: int, profile: bool):
        """Row-sharded padded store: one gather hands each shard the
        (hub, dist, wlev, count) rows of both sides of its slice, and the
        shard's batch runs over those rows as a small store: K9 (with
        ``use_pallas``), else the plain join; profiles the plain join, as
        on a single device."""
        from ..distributed.collectives import multi_row_gather_psum_scatter
        rows = np.concatenate([np.concatenate([stq[0, k * b:(k + 1) * b],
                                               stq[1, k * b:(k + 1) * b]])
                               for k in range(self.ndev)])
        got = multi_row_gather_psum_scatter(self._blocks, rows,
                                            self._rows_per)
        W = self.num_levels
        outs = []
        for k, dev in enumerate(self.devices):
            store = got[k]
            with _on(dev):
                s_idx = torch.arange(b, dtype=torch.int32, device=dev)
                t_idx = s_idx + b
                if profile:
                    outs.append(profile_batch_torch(*store, s_idx, t_idx,
                                                    num_levels=W))
                    continue
                wq = torch.from_numpy(np.ascontiguousarray(
                    stq[2, k * b:(k + 1) * b])).to(dev)
                join = kops.wcsd_query if self.use_pallas else \
                    query_batch_torch
                outs.append(join(*store, s_idx, t_idx, wq))
        return outs
