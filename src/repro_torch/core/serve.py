"""WCSD serving: request batching over the device query engine.

Port of the core of the reference package's `core/serve.py`
(`WCSDServer` with ``backend="device"``, csr layout): requests
accumulate into batches that the engine answers -- one kernel launch per
flush with ``dispatch="ragged"`` (over the compressed arena with
``compressed=True``), one launch per populated bucket pair with
``dispatch="bucket_pair"`` -- with

  * an LRU memo (symmetric ``(s <= t)`` keys when ``undirected``) and
    piggyback dedup: a key already pending or in flight occupies one
    device slot, however often it is submitted;
  * a double-buffered async flush: an auto-flush only enqueues the batch
    on the card, and the host keeps accepting submissions while it runs;
    at most one batch is in flight;
  * continuous batching: with ``max_wait_us`` set, once ``min_batch``
    requests are queued a flush fires as soon as the in-flight slot is
    free or finished, or when the oldest queued request has waited
    ``max_wait_us`` (checked on every submit and on `poll`);
  * read-once results, profile (all-level staircase) requests riding the
    same flush, `ServeStats` counters and p50/p99 enqueue→deliver latency.

Not ported yet (the constructor raises `NotImplementedError`): the
sharded backend, the dynamic index (``graph=``), the update WAL and the
flush watchdog with its fallback ladder.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from .query import DeviceQueryEngine, PendingResult
from .resilience import UnknownRequestError
from .wc_index import PackedWCIndex


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    profile_requests: int = 0
    batches: int = 0
    memo_hits: int = 0
    dispatch_time_s: float = 0.0  # host time launching batches (flush_async)
    drain_wait_s: float = 0.0     # host time blocked on device results
    max_batch: int = 0
    deadline_flushes: int = 0     # flushes fired by the max_wait_us deadline
    opportunistic_flushes: int = 0  # flushes fired by a free in-flight slot


class _Lane:
    """Queue state of one request kind (scalar or profile): the pending
    batch with its dedup table and piggyback riders, and the in-flight
    batch with the same."""

    def __init__(self):
        self.pending: list[tuple] = []           # (rid, s, t[, wl])
        self.pending_rids: set[int] = set()
        self.pending_pos: dict[tuple, int] = {}  # key -> pending position
        self.pending_extra: list[tuple[int, int]] = []  # (rid, position)
        self.inflight: Optional[tuple[PendingResult, list, list]] = None
        self.inflight_rids: set[int] = set()
        self.inflight_pos: dict[tuple, int] = {}
        self.inflight_extra: list[tuple[int, int]] = []

    def enqueue(self, rid: int, key: tuple, req: tuple) -> str:
        """Place a request: ride the in-flight or pending copy of its key
        when there is one ("inflight"/"pending"), else queue it ("new")."""
        if key in self.inflight_pos:
            self.inflight_extra.append((rid, self.inflight_pos[key]))
            self.inflight_rids.add(rid)
            return "inflight"
        if key in self.pending_pos:
            self.pending_extra.append((rid, self.pending_pos[key]))
            self.pending_rids.add(rid)
            return "pending"
        self.pending_pos[key] = len(self.pending)
        self.pending.append(req)
        self.pending_rids.add(rid)
        return "new"

    def launch(self, handle: PendingResult, keys: list) -> int:
        """Move the pending batch in flight under ``handle``."""
        batch = self.pending
        self.inflight = (handle, [b[0] for b in batch], keys)
        self.inflight_rids = ({b[0] for b in batch}
                              | {r for r, _ in self.pending_extra})
        self.inflight_pos = {k: i for i, k in enumerate(keys)}
        self.inflight_extra = self.pending_extra
        self.pending, self.pending_rids = [], set()
        self.pending_pos, self.pending_extra = {}, []
        return len(batch)

    def land(self):
        """Take the in-flight batch: (handle, rids, keys, extra) or None."""
        if self.inflight is None:
            return None
        handle, rids, keys = self.inflight
        extra = self.inflight_extra
        self.inflight = None
        self.inflight_rids, self.inflight_pos = set(), {}
        self.inflight_extra = []
        return handle, rids, keys, extra


class WCSDServer:
    def __init__(self, idx: PackedWCIndex, max_batch: int = 1024,
                 memo_capacity: int = 65536, layout: str = "csr",
                 undirected: bool = True, backend: str = "device",
                 dispatch: str = "ragged", compressed: bool = False,
                 graph=None, max_wait_us: float | None = None,
                 min_batch: int = 1, wal_path: str | None = None,
                 flush_timeout_ms: float | None = None, device=None):
        # undirected=False disables the symmetric memo canonicalization
        # for indices over directed graphs. max_wait_us/min_batch turn on
        # continuous batching; max_wait_us=None keeps epoch flushes
        # (a flush when max_batch requests are queued, or on demand).
        if backend != "device":
            raise NotImplementedError(f"backend={backend!r} (the sharded "
                                      "engine) is not ported yet")
        if graph is not None:
            raise NotImplementedError("graph= (dynamic index serving) is not "
                                      "ported yet")
        if wal_path is not None:
            raise NotImplementedError("wal_path= (update WAL) is not ported "
                                      "yet")
        if flush_timeout_ms is not None:
            raise NotImplementedError("flush_timeout_ms= (flush watchdog and "
                                      "fallback ladder) is not ported yet")
        self.engine = DeviceQueryEngine(idx, layout=layout, dispatch=dispatch,
                                        compressed=compressed, device=device)
        self.index = idx
        self.max_batch = int(max_batch)
        self.max_wait_us = None if max_wait_us is None else float(max_wait_us)
        self.min_batch = max(1, int(min_batch))
        self.undirected = bool(undirected)
        self.memo: collections.OrderedDict[tuple, int] = \
            collections.OrderedDict()
        self.profile_memo: collections.OrderedDict[tuple, np.ndarray] = \
            collections.OrderedDict()
        self.memo_capacity = memo_capacity
        self._scalar = _Lane()
        self._profile = _Lane()
        self.results: dict[int, int] = {}
        self.profile_results: dict[int, np.ndarray] = {}
        self._next_rid = 0
        # enqueue→deliver latency: stamped per rid at submit, recorded
        # (µs) the moment the answer lands in the result dict
        self._enqueue_t: dict[int, float] = {}
        self.latencies_us: list[float] = []
        self._pending_since: float | None = None  # oldest queued enqueue
        self.stats = ServeStats()

    # ------------------------------------------------------------- keys
    def _memo_key(self, s: int, t: int, w_level: int) -> tuple:
        if self.undirected and s > t:
            return (t, s, w_level)
        return (s, t, w_level)

    def _profile_key(self, s: int, t: int) -> tuple:
        if self.undirected and s > t:
            return (t, s)
        return (s, t)

    @property
    def pending(self) -> list:
        return self._scalar.pending

    @property
    def pending_profiles(self) -> list:
        return self._profile.pending

    # --------------------------------------------------------- requests
    def _deliver(self, rid: int) -> None:
        t0 = self._enqueue_t.pop(rid, None)
        if t0 is not None:
            self.latencies_us.append((time.perf_counter() - t0) * 1e6)

    def _queued(self) -> int:
        return len(self._scalar.pending) + len(self._profile.pending)

    def _enqueue(self, lane: _Lane, rid: int, key: tuple, req: tuple):
        was_empty = self._queued() == 0
        if lane.enqueue(rid, key, req) != "new":
            # piggyback: no extra device work, counted as a memo hit
            self.stats.memo_hits += 1
            return
        if was_empty:
            self._pending_since = time.perf_counter()
        self._maybe_flush()

    def submit(self, s: int, t: int, w_level: int) -> int:
        """Queue one request; returns a request id."""
        rid = self._next_rid
        self._next_rid += 1
        key = self._memo_key(s, t, w_level)
        pkey = self._profile_key(s, t)
        self.stats.requests += 1
        self._enqueue_t[rid] = time.perf_counter()
        if key in self.memo:
            self.memo.move_to_end(key)
            self.results[rid] = self.memo[key]
            self.stats.memo_hits += 1
            self._deliver(rid)
        elif (pkey in self.profile_memo
              and 0 <= w_level <= self.engine.num_levels):
            # a cached profile answers every level of its pair
            self.profile_memo.move_to_end(pkey)
            self.results[rid] = int(self.profile_memo[pkey][w_level])
            self._memo_put(key, self.results[rid])
            self.stats.memo_hits += 1
            self._deliver(rid)
        else:
            self._enqueue(self._scalar, rid, key, (rid, s, t, w_level))
        return rid

    def submit_profile(self, s: int, t: int) -> int:
        """Queue one profile request — the ``dist(s, t, w)`` staircase for
        every level 0..num_levels. Returns a rid for `profile_result`."""
        rid = self._next_rid
        self._next_rid += 1
        key = self._profile_key(s, t)
        self.stats.profile_requests += 1
        self._enqueue_t[rid] = time.perf_counter()
        if key in self.profile_memo:
            self.profile_memo.move_to_end(key)
            self.profile_results[rid] = self.profile_memo[key].copy()
            self.stats.memo_hits += 1
            self._deliver(rid)
        else:
            self._enqueue(self._profile, rid, key, (rid, s, t))
        return rid

    def _slot_done(self) -> bool:
        """True iff a batch is in flight AND its device work has finished."""
        lanes = [ln for ln in (self._scalar, self._profile)
                 if ln.inflight is not None]
        return bool(lanes) and all(ln.inflight[0].ready() for ln in lanes)

    def _maybe_flush(self) -> None:
        """Continuous-batching admission: flush at the hard cap, or — with
        ``max_wait_us`` set and at least ``min_batch`` queued — when the
        in-flight slot is free/finished or the oldest request is overdue."""
        npend = self._queued()
        if npend >= self.max_batch:
            self.flush_async()
            return
        if self.max_wait_us is None or npend < self.min_batch:
            return
        idle = self._scalar.inflight is None and self._profile.inflight is None
        if idle or self._slot_done():
            self.stats.opportunistic_flushes += 1
            self.flush_async()
        elif (self._pending_since is not None
              and (time.perf_counter() - self._pending_since) * 1e6
              >= self.max_wait_us):
            self.stats.deadline_flushes += 1
            self.flush_async()

    def poll(self) -> None:
        """Deadline tick for continuous batching: harvest the in-flight
        batch if its device work is done, then re-check the triggers."""
        if self._slot_done():
            self._drain()
        self._maybe_flush()

    def latency_summary(self) -> dict:
        """p50/p99 (µs) of enqueue→deliver latency over every delivered
        request so far (memo hits included)."""
        if not self.latencies_us:
            return {"count": 0, "p50_us": 0.0, "p99_us": 0.0}
        arr = np.asarray(self.latencies_us)
        return {"count": int(arr.size),
                "p50_us": float(np.percentile(arr, 50)),
                "p99_us": float(np.percentile(arr, 99))}

    def _memo_put(self, key: tuple, value: int) -> None:
        self.memo[key] = value
        if len(self.memo) > self.memo_capacity:
            self.memo.popitem(last=False)

    def flush_async(self) -> None:
        """Enqueue the pending batches (scalar and profile; either may be
        empty) on the card without waiting for their results. At most one
        batch is in flight, so this first drains the previous one. The
        pending queue is cleared only after its dispatch returned."""
        if not self._queued():
            return
        self._drain()
        t0 = time.perf_counter()
        for lane, profile in ((self._scalar, False), (self._profile, True)):
            batch = lane.pending
            if not batch:
                continue
            s = np.array([b[1] for b in batch], dtype=np.int32)
            t = np.array([b[2] for b in batch], dtype=np.int32)
            if profile:
                handle = self.engine.query_profile_async(s, t)
                keys = [self._profile_key(b[1], b[2]) for b in batch]
            else:
                wl = np.array([b[3] for b in batch], dtype=np.int32)
                handle = self.engine.query_async(s, t, wl)
                keys = [self._memo_key(b[1], b[2], b[3]) for b in batch]
            n = lane.launch(handle, keys)
            self.stats.max_batch = max(self.stats.max_batch, n)
        self._pending_since = None
        self.stats.batches += 1
        self.stats.dispatch_time_s += time.perf_counter() - t0

    def _drain(self) -> None:
        """Materialize the in-flight batch into results + memos."""
        if self._scalar.inflight is None and self._profile.inflight is None:
            return
        t0 = time.perf_counter()
        landed = self._scalar.land()
        if landed is not None:
            handle, rids, keys, extra = landed
            out = handle.wait()[:len(rids)]
            for rid, key, d in zip(rids, keys, out.tolist()):
                self.results[rid] = d
                self._memo_put(key, d)
                self._deliver(rid)
            for rid, pos in extra:  # duplicates riding a batch slot
                self.results[rid] = int(out[pos])
                self._deliver(rid)
        landed = self._profile.land()
        if landed is not None:
            handle, rids, keys, extra = landed
            out = np.asarray(handle.wait())[:len(rids)]
            for rid, key, prof in zip(rids, keys, out):
                # np.array COPIES: the memo owns its staircase
                arr = np.array(prof, dtype=np.int32)
                self.profile_results[rid] = arr.copy()
                self.profile_memo[key] = arr
                if len(self.profile_memo) > self.memo_capacity:
                    self.profile_memo.popitem(last=False)
                self._deliver(rid)
            for rid, pos in extra:
                self.profile_results[rid] = np.array(out[pos],
                                                     dtype=np.int32)
                self._deliver(rid)
        self.stats.drain_wait_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Synchronous flush: dispatch anything pending and drain."""
        self.flush_async()
        self._drain()

    def result(self, rid: int) -> int:
        """Deliver (and evict) the answer for ``rid`` (read-once)."""
        if rid not in self.results:
            if rid in self._scalar.inflight_rids:
                self._drain()
            elif rid in self._scalar.pending_rids:
                self.flush()
        if rid in self.results:
            return self.results.pop(rid)
        raise UnknownRequestError(rid)

    def profile_result(self, rid: int) -> np.ndarray:
        """Deliver (and evict) the ``[num_levels + 1]`` staircase for a
        `submit_profile` rid (read-once; the array is the caller's)."""
        if rid not in self.profile_results:
            if rid in self._profile.inflight_rids:
                self._drain()
            elif rid in self._profile.pending_rids:
                self.flush()
        if rid in self.profile_results:
            return self.profile_results.pop(rid)
        raise UnknownRequestError(rid)

    def query_many(self, s, t, w_level) -> np.ndarray:
        rids = [self.submit(int(a), int(b), int(c))
                for a, b, c in zip(s, t, w_level)]
        self.flush()
        return np.array([self.result(r) for r in rids], dtype=np.int32)

    def query_profile_many(self, s, t) -> np.ndarray:
        """[n, num_levels + 1] staircases for n (s, t) pairs."""
        rids = [self.submit_profile(int(a), int(b)) for a, b in zip(s, t)]
        self.flush()
        out = [self.profile_result(r) for r in rids]
        if not out:
            return np.zeros((0, self.engine.num_levels + 1), dtype=np.int32)
        return np.stack(out).astype(np.int32)

    def query_profile(self, s: int, t: int) -> np.ndarray:
        """Synchronous single-pair staircase."""
        return self.query_profile_many([s], [t])[0]
