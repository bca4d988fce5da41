"""Fault injection for the serving path, ported from the reference
package's `checkpoint/fault.py`: a seeded fault schedule, an engine
wrapper that raises or hangs on the schedule's draws (the flush watchdog
and fallback ladder of `core/serve.py` must absorb both), and an
in-memory bit flip for the integrity checks.

Not ported yet, and why: the chaos harness `run_chaos_schedule` and the
write-path and on-disk faults (`crashing_open`, `flip_byte_on_disk`,
`tear_file_tail`) drive the update WAL and the dynamic index, which come
with the dynamic-index slice; `Heartbeat` and `FaultTolerantRunner`
belong to the training substrate.
"""
from __future__ import annotations

import numpy as np

from ..core.query import PendingResult


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
