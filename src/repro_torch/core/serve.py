"""WCSD serving: request batching over the device query engine.

Port of the reference package's `core/serve.py` (`WCSDServer`):
requests accumulate into batches that the engine answers -- one kernel
launch per flush with ``dispatch="ragged"`` (over the compressed arena
with ``compressed=True``), one launch per populated bucket pair with
``dispatch="bucket_pair"``, one K9 launch per flush over the padded store
with ``layout="padded"`` -- on one device (``backend="device"``,
`DeviceQueryEngine`) or split over the shards of a mesh
(``backend="sharded"``, `ShardedQueryEngine` over ``mesh``, by default
every visible CUDA device: one launch per shard per flush, the labels
replicated or, past ``device_budget_bytes``, row-sharded) -- with

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
    same flush, `ServeStats` counters and p50/p99 enqueue→deliver latency;
  * the flush watchdog and the fallback ladder (`core/resilience.py`): a
    dispatch that raises, or a handle not ready by its deadline
    (``flush_timeout_ms``), is retried with exponential backoff and
    jitter; an exhausted retry budget demotes the server one rung down
    its ladder (compressed -> uncompressed -> bucket_pair -> the plain
    padded oracle), rebuilding the engine; ``probe_interval`` healthy
    flushes promote it one rung back. At the bottom rung exhaustion
    raises `FlushRetryExhausted` with the batch re-queued: no request is
    dropped. Every answer is stamped with the rung that computed it
    (`result_with_mode`); ``engine_wrapper`` wraps every engine built
    (fault injection, `checkpoint/fault.py`). A kernel that does not
    build, load or launch (`kernels._cuda.KernelError`) and a CUDA error
    are not engine faults: they propagate at once, with the batch
    re-queued, and never demote the server to a plain rung;
  * the dynamic index: ``graph=`` wraps the index in a `DynamicWCIndex`.
    `apply_updates` flushes what is queued, mutates the graph, folds the
    corrected rows into the delta store and rebuilds the engine over the
    delta-extended arena (a flush stays one K1 or K2 launch); crossing
    ``compact_threshold`` runs `compact`, the device build (K3, K4) on
    the server's device. Every answer is stamped with the graph version
    it was computed against (`result_full`, `result_with_staleness`).
    ``wal_path=`` logs every update batch to an `UpdateWAL` before the
    index is touched (fsynced unless ``wal_fsync=False``), and
    `replay_wal` re-applies the log's tail on a warm start. A dynamic
    sharded server serves the delta-extended arena on its mesh.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from ..checkpoint.ckpt import UpdateWAL
from ..kernels._cuda import NOT_RETRYABLE, resolve_device
from .query import DeviceQueryEngine, PendingResult, ShardedQueryEngine
from .resilience import (FlushRetryExhausted, RetryPolicy,
                         UnknownRequestError, WALReplayError,
                         build_fallback_ladder)
from .wc_index import DynamicWCIndex, PackedWCIndex, WCIndex


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
    # flush watchdog: per-cause retry counters
    timeout_retries: int = 0      # handle missed its deadline, re-dispatched
    error_retries: int = 0        # dispatch/wait raised, re-dispatched
    exhausted: int = 0            # a retry budget ran out (demote or raise)
    demotions: int = 0            # fallback-ladder steps down
    promotions: int = 0           # healthy probe windows stepping back up
    wal_appends: int = 0          # update batches logged to the WAL


class _Lane:
    """Queue state of one request kind (scalar or profile): the pending
    batch with its dedup table and piggyback riders, and the in-flight
    batch with the same, plus what the watchdog needs to re-dispatch it
    (its request tuples and dispatch closure)."""

    def __init__(self):
        self.pending: list[tuple] = []           # (rid, s, t[, wl])
        self.pending_rids: set[int] = set()
        self.pending_pos: dict[tuple, int] = {}  # key -> pending position
        self.pending_extra: list[tuple[int, int]] = []  # (rid, position)
        self.inflight: Optional[tuple] = None    # (handle, batch, keys,
        self.inflight_rids: set[int] = set()     #  dispatch)
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

    def launch(self, handle: PendingResult, keys: list, dispatch) -> int:
        """Move the pending batch in flight under ``handle``; ``dispatch``
        re-issues it on a retry."""
        batch = self.pending
        self.inflight = (handle, batch, keys, dispatch)
        self.inflight_rids = ({b[0] for b in batch}
                              | {r for r, _ in self.pending_extra})
        self.inflight_pos = {k: i for i, k in enumerate(keys)}
        self.inflight_extra = self.pending_extra
        self.pending, self.pending_rids = [], set()
        self.pending_pos, self.pending_extra = {}, []
        return len(batch)

    def land(self):
        """Take the in-flight batch: (handle, batch, keys, dispatch, extra)
        or None."""
        if self.inflight is None:
            return None
        landed = self.inflight + (self.inflight_extra,)
        self.inflight = None
        self.inflight_rids, self.inflight_pos = set(), {}
        self.inflight_extra = []
        return landed

    def requeue(self, batch: list, keys: list, extra: list) -> None:
        """Put a terminally failed in-flight batch back at the FRONT of the
        pending queue (nothing is dropped): the queued positions and their
        piggybacks shift by the batch length, the failed batch's own
        piggybacks keep their positions. On a duplicate key the queued copy
        wins (its piggybacks already point at its shifted position)."""
        n = len(batch)
        self.pending = list(batch) + self.pending
        shifted = {k: p + n for k, p in self.pending_pos.items()}
        for i, k in enumerate(keys):
            shifted.setdefault(k, i)
        self.pending_pos = shifted
        self.pending_extra = (list(extra)
                              + [(r, p + n) for r, p in self.pending_extra])
        self.pending_rids |= {b[0] for b in batch} | {r for r, _ in extra}


class WCSDServer:
    def __init__(self, idx: WCIndex | PackedWCIndex | None = None,
                 max_batch: int = 1024, memo_capacity: int = 65536,
                 layout: str = "csr", undirected: bool = True,
                 backend: str = "device", dispatch: str = "ragged",
                 compressed: bool = False, use_pallas: bool = True,
                 engine=None, graph=None,
                 compact_threshold: float | None = 0.25,
                 compact_kwargs: dict | None = None,
                 max_wait_us: float | None = None,
                 min_batch: int = 1, wal_path: str | None = None,
                 wal_fsync: bool = True,
                 flush_timeout_ms: float | None = None,
                 max_retries: int = 3, backoff_base_ms: float = 1.0,
                 backoff_factor: float = 2.0, jitter: float = 0.5,
                 probe_interval: int = 8, retry_seed: int = 0,
                 engine_wrapper=None, device=None, mesh=None,
                 device_budget_bytes: int | None = None,
                 multi_pod: bool = False):
        # undirected=False disables the symmetric memo canonicalization
        # for indices over directed graphs. max_wait_us/min_batch turn on
        # continuous batching; max_wait_us=None keeps epoch flushes
        # (a flush when max_batch requests are queued, or on demand).
        # flush_timeout_ms/max_retries/backoff_*/jitter/probe_interval arm
        # the flush watchdog and the fallback ladder; engine= serves a
        # prebuilt engine (no ladder: mode "injected"). graph= makes the
        # server dynamic; compact_kwargs are the device builder's keywords
        # for `compact` (the compaction always builds on the server's
        # device). backend="sharded" serves over ``mesh``
        # (`launch.mesh.make_serving_mesh`; None: every visible CUDA
        # device); ``device`` (by default the mesh's first device) is where
        # the single-device ladder rungs and the compaction run.
        if backend not in ("device", "sharded"):
            raise ValueError(f"unknown backend: {backend!r} (expected "
                             "'device' or 'sharded')")
        if graph is not None and engine is not None:
            raise ValueError("graph= (dynamic serving) cannot be combined "
                             "with an injected engine= — the server must "
                             "be able to rebuild the engine after an update")
        self.compact_threshold = compact_threshold
        self._compact_kwargs = dict(compact_kwargs or {})
        self.retry_policy = RetryPolicy(
            flush_timeout_ms=flush_timeout_ms, max_retries=int(max_retries),
            backoff_base_ms=float(backoff_base_ms),
            backoff_factor=float(backoff_factor), jitter=float(jitter),
            probe_interval=int(probe_interval))
        self._retry_rng = np.random.default_rng(retry_seed)
        self._engine_wrapper = engine_wrapper
        self._ladder = None          # injected engines have no fallback
        self.mode_index = 0
        self._healthy = 0            # consecutive retry-free drains
        self._retry_snapshot = 0     # retry-event total at last drain
        self._retrying = False       # a drain is mid-retry: poll() backs off
        if graph is not None and not isinstance(idx, DynamicWCIndex):
            idx = DynamicWCIndex(idx, graph)
        self.index = idx
        if engine is not None:
            self.engine = engine
        elif idx is None:
            raise ValueError("WCSDServer needs an index (idx=) or a "
                             "prebuilt engine (engine=)")
        else:
            if device is None and mesh is not None:
                device = mesh.devices[0]
            self.device = resolve_device(device)
            # the reference's engine config keys, so that the ladder is
            # the reference's for the same settings
            self._engine_config = dict(
                backend=backend, use_pallas=use_pallas, interpret=None,
                layout=layout, dispatch=dispatch, compressed=compressed,
                mesh=mesh, device_budget_bytes=device_budget_bytes,
                multi_pod=multi_pod)
            self._ladder = build_fallback_ladder(self._engine_config)
            self.engine = self._make_engine()
        self.wal = None
        if wal_path is not None:
            self.wal = UpdateWAL(wal_path, base_version=self.graph_version,
                                 fsync=wal_fsync)
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
        # the ladder rung each answer was computed under ("memo" for cache
        # hits); popped with the answer, read via result_with_mode
        self.result_modes: dict[int, str] = {}
        self.profile_result_modes: dict[int, str] = {}
        # the graph version each answer was computed against, popped with
        # it (the staleness flags)
        self.result_versions: dict[int, int] = {}
        self.profile_result_versions: dict[int, int] = {}
        self._next_rid = 0
        # enqueue→deliver latency: stamped per rid at submit, recorded
        # (µs) the moment the answer lands in the result dict
        self._enqueue_t: dict[int, float] = {}
        self.latencies_us: list[float] = []
        self._pending_since: float | None = None  # oldest queued enqueue
        self.stats = ServeStats()

    # ----------------------------------------------------------- engines
    def _make_engine(self):
        eng = self._build_engine(self._ladder[self.mode_index][1])
        if self._engine_wrapper is not None:
            eng = self._engine_wrapper(eng)
        return eng

    def _build_engine(self, cfg: dict):
        if cfg["backend"] == "sharded":
            return ShardedQueryEngine(
                self.index, mesh=cfg["mesh"], use_pallas=cfg["use_pallas"],
                layout=cfg["layout"],
                device_budget_bytes=cfg["device_budget_bytes"],
                multi_pod=cfg["multi_pod"], dispatch=cfg["dispatch"],
                compressed=cfg["compressed"])
        return DeviceQueryEngine(
            self.index, layout=cfg["layout"], dispatch=cfg["dispatch"],
            compressed=cfg["compressed"], use_pallas=cfg["use_pallas"],
            device=self.device)

    @property
    def graph_version(self) -> int:
        return int(getattr(self.index, "graph_version", 0))

    # ----------------------------------------------------------- dynamic
    def _require_dynamic(self, what: str) -> None:
        if not isinstance(self.index, DynamicWCIndex):
            raise ValueError(f"{what} requires a dynamic server — "
                             "construct WCSDServer(idx, graph=g, ...)")

    def apply_updates(self, inserts=(), deletes=()) -> dict:
        """Mutate the served graph and fold the label corrections into the
        delta store (`DynamicWCIndex.apply_updates`). Queued and in-flight
        requests are flushed first: their answers keep the graph version
        they were stamped with and read back as stale. The memos are
        dropped and the engine is rebuilt over the delta-extended store;
        crossing ``compact_threshold`` runs `compact` before returning.
        With a WAL, the batch is logged (and fsynced) before the index is
        touched, so a crash after the append loses nothing: `replay_wal`
        on a warm start re-applies it."""
        self._require_dynamic("apply_updates")
        self.flush()
        inserts = [(int(u), int(v), float(q)) for u, v, q in inserts]
        deletes = [(int(u), int(v)) for u, v in deletes]
        if self.wal is not None:
            self.wal.append(inserts, deletes,
                            graph_version=self.graph_version + 1)
            self.stats.wal_appends += 1
        stats = self.index.apply_updates(inserts=inserts, deletes=deletes)
        self.memo.clear()
        self.profile_memo.clear()
        self.engine = self._make_engine()
        stats["compacted"] = False
        if (self.compact_threshold is not None
                and self.index.delta_ratio() >= self.compact_threshold):
            self.compact()
            stats["compacted"] = True
        return stats

    def compact(self, **build_kwargs) -> dict:
        """Fold the delta into a fresh base store (the device build on the
        current graph, on the server's device: byte-identical to a build
        from scratch) and rebuild the engine over it. The answers do not
        change, so the memos survive; a WAL restarts at the current
        version."""
        self._require_dynamic("compact")
        self.flush()
        kw = dict(self._compact_kwargs)
        kw.update(build_kwargs)
        stats = self.index.compact(device=self.device, **kw)
        self.engine = self._make_engine()
        if self.wal is not None:
            self.wal.truncate(self.graph_version)
        return stats

    def replay_wal(self) -> int:
        """Warm start: re-apply the WAL's records past the server's graph
        version, in order. Returns the number applied. Raises
        `WALReplayError` where the log does not reach back to this
        server's version or skips one. Replayed batches are not logged
        again."""
        if self.wal is None:
            raise ValueError("replay_wal requires a WAL-backed server — "
                             "construct WCSDServer(..., wal_path=...)")
        self._require_dynamic("replay_wal")
        n = 0
        for rec in self.wal.replay(self.graph_version):
            if rec["graph_version"] != self.graph_version + 1:
                raise WALReplayError(
                    f"WAL record jumps to graph version "
                    f"{rec['graph_version']} but the server is at "
                    f"{self.graph_version}")
            self.flush()
            self.index.apply_updates(
                inserts=[(int(u), int(v), float(q))
                         for u, v, q in rec["inserts"]],
                deletes=[(int(u), int(v)) for u, v in rec["deletes"]])
            n += 1
        if n:
            self.memo.clear()
            self.profile_memo.clear()
            self.engine = self._make_engine()
        return n

    # -------------------------------------------------------- resilience
    @property
    def mode(self) -> str:
        """The fallback-ladder rung serving now ("primary" when healthy;
        "injected" for engine= servers, which have no ladder)."""
        if self._ladder is None:
            return "injected"
        return self._ladder[self.mode_index][0]

    def _demote(self) -> bool:
        """Step one rung down the ladder (rebuilding the engine) after an
        exhausted retry budget. False at the bottom. The memos survive:
        every rung serves the same index."""
        if self._ladder is None or self.mode_index >= len(self._ladder) - 1:
            return False
        self.mode_index += 1
        self.stats.demotions += 1
        self._healthy = 0
        self.engine = self._make_engine()
        return True

    def _stamp_deadline(self, handle) -> None:
        p = self.retry_policy
        if p.flush_timeout_ms is not None:
            try:
                handle.deadline = (time.monotonic()
                                   + p.flush_timeout_ms / 1e3)
            except AttributeError:
                pass  # foreign handle type without the attribute

    def _dispatch_with_retry(self, dispatch):
        """Run a zero-arg dispatch closure under the watchdog: a raise is
        retried with backoff up to ``max_retries``; an exhausted budget
        demotes one rung (resetting the budget) or, at the bottom of the
        ladder, raises `FlushRetryExhausted` with the queue intact. The
        closure reads ``self.engine`` at call time, so a retry after a
        demotion uses the new engine. `NOT_RETRYABLE` failures propagate
        as they are."""
        p = self.retry_policy
        attempt = 0
        while True:
            try:
                handle = dispatch()
            except NOT_RETRYABLE:
                raise
            except Exception as err:
                attempt += 1
                if attempt > p.max_retries:
                    self.stats.exhausted += 1
                    if self._demote():
                        attempt = 0
                    else:
                        raise FlushRetryExhausted(
                            f"dispatch failed after {p.max_retries} "
                            f"retries at mode {self.mode!r} (bottom of "
                            "the fallback ladder); the requests are "
                            "still queued") from err
                else:
                    self.stats.error_retries += 1
                time.sleep(p.backoff_s(max(attempt, 1), self._retry_rng))
                continue
            self._stamp_deadline(handle)
            return handle

    def _await_handle(self, handle, redispatch):
        """`handle.wait()` under the watchdog. A handle past its deadline
        that still is not ready is abandoned (its result is never read)
        and the SAME batch re-dispatched via ``redispatch``; a raising
        wait() retries the same way. Exhaustion demotes one rung and
        resets the budget; at the bottom it raises `FlushRetryExhausted`
        (the caller re-queues the batch); `NOT_RETRYABLE` failures
        propagate as they are. On the card `ready()` queries the CUDA event
        recorded after the batch's last launch. The redispatch goes to the
        same (current) stream, so this recovers from a handle that never
        reports ready while the card moves on (`FaultyEngine`'s injected
        hang), not from a kernel that really hangs: every later launch,
        the oracle's plain ops included, queues behind it, and the server
        ends in `FlushRetryExhausted`."""
        p = self.retry_policy
        attempt = 0
        while True:
            timed_out, err = False, None
            deadline = getattr(handle, "deadline", None)
            if deadline is not None:
                while not handle.ready():
                    if time.monotonic() > deadline:
                        timed_out = True
                        break
                    time.sleep(1e-4)
            if not timed_out:
                try:
                    return handle.wait()
                except NOT_RETRYABLE:
                    raise
                except Exception as e:
                    err = e
            attempt += 1
            if attempt > p.max_retries:
                self.stats.exhausted += 1
                if self._demote():
                    attempt = 0
                else:
                    raise FlushRetryExhausted(
                        f"flush failed after {p.max_retries} retries at "
                        f"mode {self.mode!r} (bottom of the fallback "
                        "ladder); the batch has been re-queued") from err
            elif timed_out:
                self.stats.timeout_retries += 1
            else:
                self.stats.error_retries += 1
            time.sleep(p.backoff_s(max(attempt, 1), self._retry_rng))
            handle = redispatch()

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
            self.result_versions[rid] = self.graph_version
            self.result_modes[rid] = "memo"
            self.stats.memo_hits += 1
            self._deliver(rid)
        elif (pkey in self.profile_memo
              and 0 <= w_level <= getattr(self.engine, "num_levels", -1)):
            # a cached profile answers every level of its pair
            self.profile_memo.move_to_end(pkey)
            self.results[rid] = int(self.profile_memo[pkey][w_level])
            self.result_versions[rid] = self.graph_version
            self.result_modes[rid] = "memo"
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
            self.profile_result_versions[rid] = self.graph_version
            self.profile_result_modes[rid] = "memo"
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
        in-flight slot is free/finished or the oldest request is overdue.
        No-op while a retry is in progress (a new batch would race the
        half-retried slot)."""
        if self._retrying:
            return
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
        batch if its device work is done, then re-check the triggers. A
        no-op while the watchdog is mid-retry: the retrying drain
        delivers."""
        if self._retrying:
            return
        if self._slot_done():
            self._drain()
        self._maybe_flush()

    def latency_summary(self) -> dict:
        """p50/p99 (µs) of enqueue→deliver latency over every delivered
        request so far (memo hits included); zeros before any."""
        if not self.latencies_us:
            return {"count": 0, "n": 0, "p50_us": 0.0, "p99_us": 0.0}
        arr = np.asarray(self.latencies_us)
        return {"count": int(arr.size), "n": int(arr.size),
                "p50_us": float(np.percentile(arr, 50)),
                "p99_us": float(np.percentile(arr, 99))}

    def _memo_put(self, key: tuple, value: int) -> None:
        self.memo[key] = value
        if len(self.memo) > self.memo_capacity:
            self.memo.popitem(last=False)

    def _dispatch_closure(self, batch: list, profile: bool):
        """A zero-arg closure that dispatches ``batch`` to whatever engine
        serves when it is called (a retry after a demotion reaches the
        new engine)."""
        s = np.array([b[1] for b in batch], dtype=np.int32)
        t = np.array([b[2] for b in batch], dtype=np.int32)
        if profile:
            def dispatch():
                qa = getattr(self.engine, "query_profile_async", None)
                if qa is not None:
                    return qa(s, t)
                res = self.engine.query_profile(s, t)
                return PendingResult(lambda: res)
            return dispatch
        wl = np.array([b[3] for b in batch], dtype=np.int32)

        def dispatch():
            qa = getattr(self.engine, "query_async", None)
            if qa is not None:
                return qa(s, t, wl)
            # an engine with only a blocking query
            res = self.engine.query(s, t, wl)
            return PendingResult(lambda: res)
        return dispatch

    def flush_async(self) -> None:
        """Enqueue the pending batches (scalar and profile; either may be
        empty) on the card without waiting for their results. At most one
        batch is in flight, so this first drains the previous one. Each
        dispatch runs under the watchdog, and the pending queue is cleared
        only after its dispatch returned: a `FlushRetryExhausted` leaves
        every queued request pending."""
        if not self._queued():
            return
        self._drain()
        t0 = time.perf_counter()
        for lane, profile in ((self._scalar, False), (self._profile, True)):
            batch = lane.pending
            if not batch:
                continue
            dispatch = self._dispatch_closure(batch, profile)
            handle = self._dispatch_with_retry(dispatch)
            if profile:
                keys = [self._profile_key(b[1], b[2]) for b in batch]
            else:
                keys = [self._memo_key(b[1], b[2], b[3]) for b in batch]
            n = lane.launch(handle, keys, dispatch)
            self.stats.max_batch = max(self.stats.max_batch, n)
        self._pending_since = None
        self.stats.batches += 1
        self.stats.dispatch_time_s += time.perf_counter() - t0

    def _land(self, lane: _Lane):
        """Wait for a lane's in-flight batch under the watchdog: (output,
        rids, keys, extra), or None when nothing is in flight. A terminal
        failure re-queues the batch and propagates."""
        landed = lane.land()
        if landed is None:
            return None
        handle, batch, keys, dispatch, extra = landed
        try:
            out = self._await_handle(
                handle, lambda: self._dispatch_with_retry(dispatch))
        except Exception:
            lane.requeue(batch, keys, extra)
            if self._pending_since is None:
                self._pending_since = time.perf_counter()
            raise
        return (np.asarray(out)[:len(batch)], [b[0] for b in batch], keys,
                extra)

    def _drain(self) -> None:
        """Materialize the in-flight batch into results + memos, under the
        watchdog. The ``_retrying`` guard makes the drain non-reentrant:
        a `poll()` issued during a retry must not harvest the
        half-retried slot. A drain with no new retry event is a healthy
        flush; ``probe_interval`` of them in a row promote a degraded
        server one rung."""
        if self._retrying:
            return
        if self._scalar.inflight is None and self._profile.inflight is None:
            return
        t0 = time.perf_counter()
        ver = self.graph_version
        self._retrying = True
        try:
            landed = self._land(self._scalar)
            if landed is not None:
                out, rids, keys, extra = landed
                mode = self.mode
                for rid, key, d in zip(rids, keys, out.tolist()):
                    self.results[rid] = d
                    self.result_versions[rid] = ver
                    self.result_modes[rid] = mode
                    self._memo_put(key, d)
                    self._deliver(rid)
                for rid, pos in extra:  # duplicates riding a batch slot
                    self.results[rid] = int(out[pos])
                    self.result_versions[rid] = ver
                    self.result_modes[rid] = mode
                    self._deliver(rid)
            landed = self._land(self._profile)
            if landed is not None:
                out, rids, keys, extra = landed
                mode = self.mode
                for rid, key, prof in zip(rids, keys, out):
                    # np.array COPIES: the memo owns its staircase
                    arr = np.array(prof, dtype=np.int32)
                    self.profile_results[rid] = arr.copy()
                    self.profile_result_versions[rid] = ver
                    self.profile_result_modes[rid] = mode
                    self.profile_memo[key] = arr
                    if len(self.profile_memo) > self.memo_capacity:
                        self.profile_memo.popitem(last=False)
                    self._deliver(rid)
                for rid, pos in extra:
                    self.profile_results[rid] = np.array(out[pos],
                                                         dtype=np.int32)
                    self.profile_result_versions[rid] = ver
                    self.profile_result_modes[rid] = mode
                    self._deliver(rid)
        finally:
            self._retrying = False
        self.stats.drain_wait_s += time.perf_counter() - t0
        events = (self.stats.timeout_retries + self.stats.error_retries
                  + self.stats.exhausted)
        self._healthy = self._healthy + 1 if events == self._retry_snapshot \
            else 0
        self._retry_snapshot = events
        if (self._ladder is not None and self.mode_index > 0
                and self._healthy >= self.retry_policy.probe_interval):
            self.mode_index -= 1
            self.stats.promotions += 1
            self._healthy = 0
            self.engine = self._make_engine()

    def flush(self) -> None:
        """Synchronous flush: dispatch anything pending and drain."""
        self.flush_async()
        self._drain()

    # ---------------------------------------------------------- results
    def _pop_result(self, rid: int):
        if rid not in self.results:
            if rid in self._scalar.inflight_rids:
                self._drain()
            elif rid in self._scalar.pending_rids:
                self.flush()
        if rid in self.results:
            return (self.results.pop(rid),
                    self.result_versions.pop(rid, self.graph_version),
                    self.result_modes.pop(rid, self.mode))
        raise UnknownRequestError(rid)

    def _pop_profile_result(self, rid: int):
        if rid not in self.profile_results:
            if rid in self._profile.inflight_rids:
                self._drain()
            elif rid in self._profile.pending_rids:
                self.flush()
        if rid in self.profile_results:
            return (self.profile_results.pop(rid),
                    self.profile_result_versions.pop(rid,
                                                     self.graph_version),
                    self.profile_result_modes.pop(rid, self.mode))
        raise UnknownRequestError(rid)

    def result(self, rid: int) -> int:
        """Deliver (and evict) the answer for ``rid`` (read-once)."""
        return self._pop_result(rid)[0]

    def result_with_mode(self, rid: int):
        """``(value, mode)``: the answer and the ladder rung that computed
        it ("primary", "uncompressed", "replicated", "single_device",
        "bucket_pair", "oracle", or "memo" for a cache hit)."""
        value, _ver, mode = self._pop_result(rid)
        return value, mode

    def result_full(self, rid: int):
        """``(value, graph_version, mode)``: the answer and everything
        stamped on it."""
        return self._pop_result(rid)

    def result_with_staleness(self, rid: int):
        """``(value, stale)``: stale iff the answer was computed against an
        earlier graph version than the server now holds (it was queued or
        in flight when `apply_updates` ran; never, for a static index)."""
        value, ver, _mode = self._pop_result(rid)
        return value, ver < self.graph_version

    def profile_result(self, rid: int) -> np.ndarray:
        """Deliver (and evict) the ``[num_levels + 1]`` staircase for a
        `submit_profile` rid (read-once; the array is the caller's)."""
        return self._pop_profile_result(rid)[0]

    def profile_result_with_mode(self, rid: int):
        """`profile_result` + the producing mode (see `result_with_mode`)."""
        value, _ver, mode = self._pop_profile_result(rid)
        return value, mode

    def profile_result_full(self, rid: int):
        """``(staircase, graph_version, mode)`` (see `result_full`)."""
        return self._pop_profile_result(rid)

    def profile_result_with_staleness(self, rid: int):
        """`profile_result` + the staleness flag."""
        value, ver, _mode = self._pop_profile_result(rid)
        return value, ver < self.graph_version

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
