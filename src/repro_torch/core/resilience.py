"""Serving-side resilience, ported from the reference package's
`core/resilience.py`: the typed failures, the flush retry/backoff policy
and the degraded-mode fallback ladder. Pure policy (no torch, no engine
imports), shared by `core/serve.py` (the enforcement point) and
`checkpoint/fault.py` (fault injection).

  * `UnknownRequestError` -- `result(rid)` on a rid the server has never
    seen or has already delivered (read-once contract).
  * `IndexIntegrityError` -- a CRC32 blob self-check failed.
  * `FlushRetryExhausted` -- the watchdog ran out of retries at the
    bottom of the fallback ladder; the batch was re-queued.
  * `WALError` / `WALReplayError` -- the update write-ahead log
    (`checkpoint/ckpt.py::UpdateWAL`) cannot be read, or its tail does
    not connect to the warm-start state.
  * `RetryPolicy` -- deadline / budget / exponential backoff with jitter.
  * `build_fallback_ladder` -- the declared degradation sequence from a
    server's engine config down to the plain padded oracle.
"""
from __future__ import annotations

import dataclasses


class UnknownRequestError(KeyError):
    """`result()`/`profile_result()` on an unknown or already-delivered
    rid (results are read-once)."""

    def __init__(self, rid):
        super().__init__(rid)
        self.rid = rid

    def __str__(self) -> str:
        return (f"request id {self.rid!r} is unknown or already "
                "delivered (results are read-once)")


class IndexIntegrityError(RuntimeError):
    """A CRC32 self-check of index/arena blobs failed — the bytes do not
    match the checksums recorded at baseline time. The store must not
    serve: corruption surfaces as this typed error, never as a wrong
    distance."""


class FlushRetryExhausted(RuntimeError):
    """The flush watchdog exhausted its retry budget on the LAST rung of
    the fallback ladder. The batch has been re-queued (requests are never
    dropped); the caller decides whether to keep retrying."""


class WALError(RuntimeError):
    """The update write-ahead log is unreadable (bad magic, torn header,
    record sequence gap before the tail)."""


class WALReplayError(WALError):
    """The WAL tail does not connect to the warm-start state: the log was
    compacted past the checkpoint's graph version, or a record's version
    does not extend the replayed sequence."""


@dataclasses.dataclass
class RetryPolicy:
    """Flush watchdog knobs.

    ``flush_timeout_ms=None`` disables the deadline: a flush may block
    forever on `wait()`. With a deadline set, an in-flight handle that is
    not `ready()` within the timeout is abandoned (device work is not
    interruptible; its result is never read) and the SAME batch is
    re-dispatched. Each retry backs off exponentially with jitter;
    `max_retries` failures in a row exhaust the budget, which demotes the
    server one rung down its fallback ladder (and resets the budget).
    After ``probe_interval`` consecutive healthy flushes a degraded
    server re-promotes one rung."""

    flush_timeout_ms: float | None = None
    max_retries: int = 3
    backoff_base_ms: float = 1.0
    backoff_factor: float = 2.0
    jitter: float = 0.5            # +/- fraction of the backoff step
    probe_interval: int = 8

    def backoff_s(self, attempt: int, rng) -> float:
        """Sleep before retry ``attempt`` (1-based): exponential in the
        attempt number, +/- ``jitter`` drawn from ``rng`` so replicas
        retrying the same fault do not re-dispatch in lockstep."""
        base = (self.backoff_base_ms / 1e3
                * self.backoff_factor ** max(attempt - 1, 0))
        if self.jitter <= 0:
            return base
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


def build_fallback_ladder(cfg: dict) -> list[tuple[str, dict]]:
    """The declared degradation sequence for an engine config: each rung
    drops ONE capability relative to the rung above, ending at the plain
    padded oracle (`query_batch_torch`: no kernel, no mesh, no
    compression, no CSR planning). Rung 0 is the configured engine; a
    server demotes one rung per exhausted retry budget and re-promotes
    one rung per healthy probe window.

      compressed arena   -> uncompressed arena
      sharded_labels     -> replicated labels (same mesh)
      sharded engine     -> single-device engine
      ragged dispatch    -> bucket_pair dispatch (the differential oracle)
      anything           -> plain padded oracle

    Rungs that would not change the config are skipped, so the ladder is
    minimal. The same config dict gives the reference's ladder."""
    ladder: list[tuple[str, dict]] = [("primary", dict(cfg))]
    cur = dict(cfg)

    def push(name, **changes):
        nonlocal cur
        nxt = dict(cur, **changes)
        if nxt != cur:
            ladder.append((name, nxt))
            cur = nxt

    if cur.get("compressed"):
        push("uncompressed", compressed=False)
    if (cur.get("backend") == "sharded"
            and cur.get("device_budget_bytes") is not None):
        push("replicated", device_budget_bytes=None)
    if cur.get("backend") == "sharded":
        push("single_device", backend="device", mesh=None,
             device_budget_bytes=None, multi_pod=False)
    if cur.get("layout") == "csr" and cur.get("dispatch") == "ragged":
        push("bucket_pair", dispatch="bucket_pair")
    push("oracle", backend="device", layout="padded", dispatch="ragged",
         use_pallas=False, compressed=False, mesh=None,
         device_budget_bytes=None, multi_pod=False, interpret=None)
    return ladder
