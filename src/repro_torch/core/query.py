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

import dataclasses

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels._cuda import resolve_device
from ..kernels.wcsd_segmented import GroupedFlush
from .graph import INF_DIST
from .wc_index import FLOAT_DTYPES, LANE, PackedWCIndex, round_to_lane

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
    `ready()` probes without blocking: on the card it queries a CUDA event
    recorded right after the batch's last launch; on the CPU the work is
    already done.
    """

    def __init__(self, finalize, event=None):
        self._finalize = finalize
        self._event = event
        self._out = None
        # absolute `time.monotonic()` seconds, stamped by the server's
        # flush watchdog at dispatch (None: no deadline)
        self.deadline = None

    def ready(self) -> bool:
        if self._finalize is None or self._event is None:
            return True
        return bool(self._event.query())

    def wait(self) -> np.ndarray:
        if self._finalize is not None:
            self._out = np.asarray(self._finalize())
            self._finalize = None
            self._event = None
        return self._out


def _pending(res: torch.Tensor, finalize) -> PendingResult:
    """A handle over ``res``, the batch's last device result: one CUDA
    event recorded after it on the current stream."""
    event = None
    if res.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(res.device))
    return PendingResult(finalize, event)


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
