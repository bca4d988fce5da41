"""Fault tolerance, ported from the reference package's
`checkpoint/fault.py`.

Training: `Heartbeat` (a simulated heartbeat table) and
`FaultTolerantRunner`, the checkpoint/restart loop a multi-host launcher
runs per host: dead peers -> `remesh_fn` to the survivors and a restore;
a step that raises -> restore the latest checkpoint and replay from its
step (`batch_for_step`); the step time watched for stragglers.

Serving: a seeded fault schedule, an engine
wrapper that raises or hangs on the schedule's draws (the flush watchdog
and fallback ladder of `core/serve.py` must absorb both), in-memory and
on-disk bit flips for the integrity checks, a torn write (`crashing_open`)
and a torn WAL tail (`tear_file_tail`), and the seeded end-to-end chaos
schedule `run_chaos_schedule` over a dynamic, WAL-backed server.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Callable, Iterable, Optional

import numpy as np

from ..core.query import PendingResult
from ..train.loop import StepTimeMonitor, _scalar
from .ckpt import CheckpointManager


@dataclasses.dataclass
class Heartbeat:
    """Simulated heartbeat table for N workers."""
    n_workers: int
    timeout_s: float = 10.0
    last: dict = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, t: Optional[float] = None):
        self.last[worker] = time.monotonic() if t is None else t

    def dead_workers(self, now: Optional[float] = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [w for w in range(self.n_workers)
                if now - self.last.get(w, -1e18) > self.timeout_s]


class FaultTolerantRunner:
    """Wraps a train step with restart-on-failure + straggler accounting.

    failure_schedule: {step: Exception} injected before the step runs
    (tests); in production the exception comes from the collective layer.
    remesh_fn: called with the surviving worker count when a peer dies;
    returns a (train_step, params, opt_state) rebuilt for the smaller mesh
    (elastic scaling)."""

    def __init__(self, train_step: Callable, params, opt_state,
                 ckpt: CheckpointManager, *, ckpt_every: int = 5,
                 max_restarts: int = 10,
                 failure_schedule: Optional[dict] = None,
                 heartbeat: Optional[Heartbeat] = None,
                 remesh_fn: Optional[Callable] = None):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.failures = dict(failure_schedule or {})
        self.heartbeat = heartbeat
        self.remesh_fn = remesh_fn
        self.monitor = StepTimeMonitor()
        self.restarts = 0
        self.step = 0
        self.log: list[dict] = []

    def _restore(self):
        state, step = self.ckpt.restore(
            {"params": self.params, "opt_state": self.opt_state})
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.step = step
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError("restart budget exhausted")

    def run(self, batches: Iterable, max_steps: int,
            batch_for_step: Optional[Callable] = None):
        """batch_for_step(step) lets restarts replay the right batch
        (deterministic data cursor)."""
        it = iter(batches) if batches is not None else None
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt_state": self.opt_state})
        while self.step < max_steps:
            if self.heartbeat:
                dead = self.heartbeat.dead_workers()
                if dead and self.remesh_fn:
                    self.train_step, self.params, self.opt_state = \
                        self.remesh_fn(self.heartbeat.n_workers - len(dead))
                    self.heartbeat = Heartbeat(
                        self.heartbeat.n_workers - len(dead),
                        self.heartbeat.timeout_s)
                    self._restore()
            batch = (batch_for_step(self.step) if batch_for_step
                     else next(it))
            t0 = time.perf_counter()
            try:
                if self.step in self.failures:
                    raise self.failures.pop(self.step)
                self.params, self.opt_state, m = self.train_step(
                    self.params, self.opt_state, batch)
                loss = _scalar(m["loss"])
            except Exception as e:  # noqa: BLE001 (restart on any fault)
                self.log.append({"step": self.step, "event": "failure",
                                 "error": repr(e)})
                self._restore()
                continue
            dt = time.perf_counter() - t0
            straggler = self.monitor.observe(dt)
            self.log.append({"step": self.step, "event": "step",
                             "loss": loss, "time_s": dt,
                             "straggler": straggler})
            self.step += 1
            if self.step % self.ckpt_every == 0:
                self.ckpt.save(self.step, {"params": self.params,
                                           "opt_state": self.opt_state})
        return self.log


# The index saver (`ckpt.save_packed_index`) takes an injectable
# ``_open``; `crashing_open` returns files that die after a byte budget,
# a crash in the middle of the tmp-file write. The target path is then
# either absent or a complete earlier version, never a torn file.


class MidWriteCrash(RuntimeError):
    """Injected crash while bytes were still being written."""


def crashing_open(fail_after_bytes: int):
    """An ``open()`` substitute whose writes raise `MidWriteCrash` once
    ``fail_after_bytes`` have been flushed (the partial prefix IS written,
    like a real torn write)."""

    class _CrashingFile:
        def __init__(self, f):
            self._f = f
            self._left = int(fail_after_bytes)

        def write(self, data):
            if len(data) > self._left:
                self._f.write(data[:self._left])
                self._f.flush()
                self._left = 0
                raise MidWriteCrash(
                    f"injected crash after {fail_after_bytes} bytes")
            self._left -= len(data)
            return self._f.write(data)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self._f.close()
            return False

        def __getattr__(self, name):
            return getattr(self._f, name)

    def _open(path, mode="wb"):
        return _CrashingFile(open(path, mode))

    return _open


class InjectedEngineError(RuntimeError):
    """An injected engine failure (stands in for a failed launch, an
    out-of-memory, a dead collective, ...)."""


class FaultSchedule:
    """Seeded draw-by-draw fault plan.

    ``rates`` maps a fault kind to its probability per draw (e.g.
    ``{"engine_raise": 0.05, "flush_hang": 0.02}``); ``fixed`` pins a
    kind to a specific draw index (``{7: "engine_raise"}``). The same
    seed replays the same faults, and draws the same numbers as the
    reference's schedule."""

    def __init__(self, seed: int = 0, rates: dict | None = None,
                 fixed: dict | None = None):
        self._rng = np.random.default_rng(seed)
        self.rates = dict(rates or {})
        self.fixed = dict(fixed or {})
        self.draws = 0
        self.injected: list[tuple[int, str]] = []  # (draw, kind) audit log

    def draw(self) -> str | None:
        """The fault kind for this draw, or None (healthy). One draw per
        protected operation."""
        i = self.draws
        self.draws += 1
        kind = self.fixed.get(i)
        if kind is None:
            for k, p in self.rates.items():
                if p > 0 and self._rng.random() < p:
                    kind = k
                    break
            else:
                self._rng.random()  # keep the stream aligned when rateless
        if kind is not None:
            self.injected.append((i, kind))
        return kind


class _HangingResult(PendingResult):
    """A handle that is never ready: `ready()` stays False (the launch
    never lands), while `wait()` still delegates -- so only a watchdog
    with a deadline recovers; a deadline-less server would block in
    `wait()` and get the answer."""

    def __init__(self, inner: PendingResult):
        super().__init__(inner.wait)
        self.deadline = getattr(inner, "deadline", None)

    def ready(self) -> bool:
        return False


class FaultyEngine:
    """Fault wrapper around a query engine: every dispatch draws from the
    `FaultSchedule` and either raises (`engine_raise`), returns a handle
    that never reports ready (`flush_hang`), or passes through. Every
    other attribute (num_levels, layout, ...) delegates to the wrapped
    engine, so the server cannot tell it apart from the real one."""

    def __init__(self, engine, schedule: FaultSchedule):
        self._engine = engine
        self._schedule = schedule

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _protect(self, dispatch, *args):
        kind = self._schedule.draw()
        if kind == "engine_raise":
            raise InjectedEngineError(
                f"injected engine raise (draw {self._schedule.draws - 1})")
        handle = dispatch(*args)
        if kind == "flush_hang":
            return _HangingResult(handle)
        return handle

    def query_async(self, s, t, wl):
        qa = getattr(self._engine, "query_async", None)
        if qa is None:
            def dispatch(s=s, t=t, wl=wl):
                return PendingResult(lambda: self._engine.query(s, t, wl))
            return self._protect(dispatch)
        return self._protect(qa, s, t, wl)

    def query_profile_async(self, s, t):
        qa = getattr(self._engine, "query_profile_async", None)
        if qa is None:
            def dispatch(s=s, t=t):
                return PendingResult(
                    lambda: self._engine.query_profile(s, t))
            return self._protect(dispatch)
        return self._protect(qa, s, t)


def flip_byte_on_disk(path: str, offset: int, mask: int = 0xFF) -> int:
    """XOR one byte of a file in place (bit rot / torn copy injection);
    returns the original byte so the caller can restore it."""
    with open(path, "r+b") as f:
        f.seek(offset)
        orig = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([orig ^ (mask & 0xFF)]))
    return orig


def flip_array_cell(arr, flat_index: int = 0, mask: int = 1):
    """XOR one byte of a live numpy array in place (in-memory corruption
    of an arena tile). Returns an undo closure restoring the byte."""
    flat = arr.reshape(-1).view(np.uint8)
    i = int(flat_index) % flat.size
    orig = int(flat[i])
    flat[i] = orig ^ (mask & 0xFF)

    def undo():
        flat[i] = orig
    return undo


def tear_file_tail(path: str, nbytes: int) -> int:
    """Truncate the last ``nbytes`` of a file (a torn append — the WAL's
    mid-crash tail). Returns the new size."""
    size = os.path.getsize(path)
    new = max(0, size - int(nbytes))
    with open(path, "r+b") as f:
        f.truncate(new)
    return new


def run_chaos_schedule(server_kwargs: dict | None = None, *, steps: int = 200,
                       seed: int = 0, rates: dict | None = None,
                       fixed: dict | None = None,
                       n_nodes: int = 36, avg_degree: float = 3.0,
                       num_levels: int = 4, workdir: str,
                       crash_step: int | None = None,
                       verbose: bool = False) -> dict:
    """The seeded end-to-end chaos schedule: ``steps`` randomized steps
    mixing submits, profile submits, result reads, polls, graph updates,
    injected engine raises/hangs, live bit-flip integrity probes and
    torn-WAL probes -- plus, at ``crash_step``, a simulated crash between
    the WAL append and the index apply followed by a checkpoint + WAL
    replay warm restart that replaces the server.

    Every answered query is checked against the BFS oracle
    (`constrained_distance_grid`) for exactly the graph version stamped on
    the answer; the run then goes fault-free until the server climbs back
    to its top (non-degraded) mode. Raises on any mismatch, lost request,
    or double delivery; returns a summary dict for reporting. The server
    runs on the card unless ``server_kwargs`` holds ``device="cpu"``."""
    from ..core.baselines import constrained_distance_grid
    from ..core.generators import erdos_renyi
    from ..core.graph import mutate_edges
    from ..core.resilience import IndexIntegrityError, UnknownRequestError
    from ..core.serve import WCSDServer
    from ..core.wc_index import as_packed_index, build_wc_index
    from .ckpt import UpdateWAL, load_packed_index, save_packed_index

    server_kwargs = dict(server_kwargs or {})
    rates = dict(rates if rates is not None
                 else {"engine_raise": 0.06, "flush_hang": 0.03})
    if fixed is None:
        # guaranteed coverage on top of the random rates: a retry chain
        # long enough to exhaust the budget (max_retries=2 -> draws 6-8
        # demote one rung, draw 9 retries on the demoted engine) and a
        # deterministic hang for the timeout path
        fixed = {6: "engine_raise", 7: "engine_raise", 8: "engine_raise",
                 9: "engine_raise", 18: "flush_hang"}
    rng = np.random.default_rng(seed + 1)
    sched = FaultSchedule(seed=seed, rates=rates, fixed=fixed)

    g0 = erdos_renyi(n_nodes, avg_degree, num_levels=num_levels, seed=seed)
    idx0 = as_packed_index(build_wc_index(g0))
    os.makedirs(workdir, exist_ok=True)
    ckpt_path = os.path.join(workdir, "chaos_base.wcx")
    wal_path = os.path.join(workdir, "chaos_wal.log")
    save_packed_index(ckpt_path, idx0, graph_version=0)

    kwargs = dict(layout="csr", backend="device", dispatch="ragged",
                  compact_threshold=None,   # keep the WAL reaching back to v0
                  flush_timeout_ms=50.0, max_retries=2,
                  backoff_base_ms=0.05, probe_interval=3, max_batch=32)
    kwargs.update(server_kwargs)
    kwargs.update(graph=g0, wal_path=wal_path,
                  engine_wrapper=lambda e: FaultyEngine(e, sched))
    srv = WCSDServer(idx0, **kwargs)

    graphs = {0: g0}          # version -> Graph (old objects stay valid)
    grids: dict = {}

    def grid(ver):
        if ver not in grids:
            grids[ver] = constrained_distance_grid(graphs[ver])
        return grids[ver]

    outstanding: dict = {}        # rid -> (s, t, wl)
    outstanding_prof: dict = {}   # rid -> (s, t)
    summary = {"submitted": 0, "answered": 0, "updates": 0, "crashes": 0,
               "integrity_probes": 0, "wal_probes": 0}
    # retry/mode counters survive the crash-restart (the dead server's
    # stats die with it; the run-level totals must not)
    dead_stats = {"timeout_retries": 0, "error_retries": 0, "exhausted": 0,
                  "demotions": 0, "promotions": 0, "wal_appends": 0}

    def check_scalar(rid):
        s, t, wl = outstanding.pop(rid)
        val, ver, mode = srv.result_full(rid)
        exp = int(grid(ver)[s, t, wl])
        if int(val) != exp:
            raise AssertionError(
                f"chaos mismatch rid={rid} ({s},{t},{wl}) v{ver} "
                f"mode={mode}: got {val}, oracle {exp}")
        try:                      # double delivery must be impossible
            srv.result(rid)
            raise AssertionError(f"rid {rid} delivered twice")
        except UnknownRequestError:
            pass
        summary["answered"] += 1

    def check_profile(rid):
        s, t = outstanding_prof.pop(rid)
        prof, ver, mode = srv.profile_result_full(rid)
        exp = grid(ver)[s, t, :]
        if not np.array_equal(np.asarray(prof), exp):
            raise AssertionError(
                f"chaos profile mismatch rid={rid} ({s},{t}) v{ver} "
                f"mode={mode}")
        summary["answered"] += 1

    def drain_all():
        srv.flush()
        for rid in list(outstanding):
            check_scalar(rid)
        for rid in list(outstanding_prof):
            check_profile(rid)

    def random_mutation():
        cur = srv.index.graph
        if rng.random() < 0.5 and cur.num_edges > 4:
            e = int(rng.integers(cur.num_edges))
            # src array from indptr: find the edge's endpoint pair
            u = int(np.searchsorted(cur.indptr, e, side="right") - 1)
            v = int(cur.nbr[e])
            return {"deletes": [(u, v)]}
        u = int(rng.integers(n_nodes))
        v = int(rng.integers(n_nodes))
        if u == v:
            v = (v + 1) % n_nodes
        q = float(cur.levels[int(rng.integers(len(cur.levels)))])
        return {"inserts": [(u, v, q)]}

    for step in range(int(steps)):
        if crash_step is not None and step == crash_step:
            # deliver everything, then crash between WAL append and apply
            drain_all()
            mut = random_mutation()
            pre_crash_version = srv.graph_version + 1
            srv.wal.append(mut.get("inserts", ()), mut.get("deletes", ()),
                           graph_version=pre_crash_version)
            graphs[pre_crash_version] = mutate_edges(
                graphs[srv.graph_version], inserts=mut.get("inserts", ()),
                deletes=mut.get("deletes", ()))
            # warm restart: checkpoint (v0) + WAL tail replay
            for k in dead_stats:
                dead_stats[k] += getattr(srv.stats, k)
            base, _hdr = load_packed_index(ckpt_path)
            srv = WCSDServer(base, **kwargs)
            replayed = srv.replay_wal()
            if srv.graph_version != pre_crash_version:
                raise AssertionError(
                    f"replay converged to v{srv.graph_version}, "
                    f"pre-crash was v{pre_crash_version}")
            summary["crashes"] += 1
            summary["replayed_records"] = replayed
            if verbose:
                print(f"[chaos {step}] crash+restart: replayed {replayed} "
                      f"records to v{srv.graph_version}", flush=True)
            continue
        r = rng.random()
        if r < 0.45:
            s = int(rng.integers(n_nodes)); t = int(rng.integers(n_nodes))
            wl = int(rng.integers(num_levels + 1))
            outstanding[srv.submit(s, t, wl)] = (s, t, wl)
            summary["submitted"] += 1
        elif r < 0.55:
            s = int(rng.integers(n_nodes)); t = int(rng.integers(n_nodes))
            outstanding_prof[srv.submit_profile(s, t)] = (s, t)
            summary["submitted"] += 1
        elif r < 0.75:
            if outstanding:
                check_scalar(next(iter(outstanding)))
            elif outstanding_prof:
                check_profile(next(iter(outstanding_prof)))
        elif r < 0.82:
            srv.poll()
        elif r < 0.88:
            drain_all()
            srv.apply_updates(**random_mutation())
            graphs[srv.graph_version] = srv.index.graph
            summary["updates"] += 1
        elif r < 0.94:
            # bit-flip: corruption must surface as the typed integrity
            # error, never a wrong distance — flip, observe, heal,
            # re-verify. Live arrays are flipped in place; a warm-started
            # (read-only mmap) base is probed through its on-disk file.
            base_idx = srv.index.base
            base_idx.verify_integrity()
            arr = base_idx.labels.dist
            if arr.flags.writeable:
                undo = flip_array_cell(arr, int(rng.integers(arr.size * 4)))
                try:
                    base_idx.verify_integrity()
                    raise AssertionError("bit flip passed verify_integrity")
                except IndexIntegrityError:
                    pass
                undo()
                base_idx.verify_integrity()
            else:
                corrupt = os.path.join(workdir, "corrupt.wcx")
                shutil.copyfile(ckpt_path, corrupt)
                flip_byte_on_disk(
                    corrupt, os.path.getsize(corrupt)
                    - 1 - int(rng.integers(64)))
                try:
                    load_packed_index(corrupt)
                    raise AssertionError("disk bit flip loaded silently")
                except IndexIntegrityError:
                    pass
                os.remove(corrupt)
            summary["integrity_probes"] += 1
        else:
            # torn-WAL probe on a COPY (the live log stays intact): a
            # mid-append crash tail must be tolerated, not fatal
            torn = os.path.join(workdir, "torn_wal.log")
            shutil.copyfile(wal_path, torn)
            committed = len(srv.wal.records())
            with open(torn, "ab") as f:     # half an append, then "crash"
                f.write(b"\x99\x00\x00\x00\xde\xad")
            kept = len(UpdateWAL(torn).records())
            if kept != committed:
                raise AssertionError(
                    f"torn WAL tail changed committed records: "
                    f"{kept} != {committed}")
            os.remove(torn)
            summary["wal_probes"] += 1

    # quiet tail: no more injections; drain and climb back to the top mode
    sched.rates = {}
    drain_all()
    guard = 0
    while srv.mode_index > 0:
        guard += 1
        if guard > 100:
            raise AssertionError(
                f"server stuck in degraded mode {srv.mode!r}")
        s = int(rng.integers(n_nodes)); t = int(rng.integers(n_nodes))
        wl = int(rng.integers(num_levels + 1))
        outstanding[srv.submit(s, t, wl)] = (s, t, wl)
        summary["submitted"] += 1
        drain_all()
    if srv.mode != "primary":
        raise AssertionError(f"final mode {srv.mode!r}, expected primary")
    if outstanding or outstanding_prof:
        raise AssertionError("requests lost: "
                             f"{len(outstanding)} scalar, "
                             f"{len(outstanding_prof)} profile")
    st = srv.stats
    summary.update(
        final_mode=srv.mode, graph_version=srv.graph_version,
        injected=len(sched.injected),
        **{k: v + getattr(st, k) for k, v in dead_stats.items()})
    return summary
