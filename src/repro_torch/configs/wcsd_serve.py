"""The paper's serving workload as a runnable `ServeConfig`, consumed by
`WCSDServer` and `launch.dryrun --serve`. Port of the reference
package's `configs/wcsd_serve.py` (its dry-run compile cell, `make_cell`
/ `get_config`, belongs to the compile substrate, which the port does
not carry)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ServeConfig:
    """Everything `WCSDServer` needs to stand up a serving stack.

    ``backend="sharded"`` builds a `ShardedQueryEngine` over a
    `launch.mesh.make_serving_mesh` mesh (batch split over the shards,
    labels replicated; row-sharded labels and a row gather once the store
    exceeds ``device_budget_bytes``); the mesh itself is passed to the
    server beside these keywords. ``dispatch`` picks the CSR query path:
    "ragged" (one kernel launch per shard per flush) or "bucket_pair".
    ``compressed`` (csr + ragged only) serves the `CompressedArena`.
    ``max_wait_us`` / ``min_batch`` turn on continuous batching; the
    resilience knobs arm the flush watchdog (``flush_timeout_ms``,
    ``max_retries``, ``backoff_base_ms``, ``probe_interval``);
    ``wal_path`` attaches the update WAL.

    The fields and defaults are the reference's, but for two: there is no
    ``interpret`` (the port has no interpret mode: a CUDA tensor runs the
    kernel, a CPU tensor its plain version), and ``use_pallas`` defaults
    to True, because the port's CSR layouts run only their kernels
    (``use_pallas=False`` is the padded plain join and needs
    ``layout="padded"``)."""

    backend: str = "sharded"          # "device" | "sharded"
    layout: str = "csr"               # "padded" | "csr"
    dispatch: str = "ragged"          # "ragged" | "bucket_pair"
    use_pallas: bool = True
    max_batch: int = 1024
    memo_capacity: int = 65536
    undirected: bool = True
    multi_pod: bool = False           # ("pod", "data") batch axes
    device_budget_bytes: int | None = None
    compressed: bool = False          # CompressedArena store (csr + ragged)
    max_wait_us: float | None = None  # continuous-batching deadline
    min_batch: int = 1                # admission floor for early flushes
    flush_timeout_ms: float | None = None  # watchdog deadline per flush
    max_retries: int = 3              # retry budget per flush, per rung
    backoff_base_ms: float = 1.0      # exponential backoff base (jittered)
    probe_interval: int = 8           # healthy flushes before re-promotion
    wal_path: str | None = None       # crash-safe update WAL (None = off)

    def server_kwargs(self) -> dict:
        """The `WCSDServer` keywords of this config."""
        return dict(backend=self.backend, layout=self.layout,
                    dispatch=self.dispatch, use_pallas=self.use_pallas,
                    max_batch=self.max_batch,
                    memo_capacity=self.memo_capacity,
                    undirected=self.undirected,
                    device_budget_bytes=self.device_budget_bytes,
                    multi_pod=self.multi_pod, compressed=self.compressed,
                    max_wait_us=self.max_wait_us, min_batch=self.min_batch,
                    flush_timeout_ms=self.flush_timeout_ms,
                    max_retries=self.max_retries,
                    backoff_base_ms=self.backoff_base_ms,
                    probe_interval=self.probe_interval,
                    wal_path=self.wal_path)


def serve_config() -> ServeConfig:
    """Production shape: kernels, CSR store, ragged dispatch, sharded
    batch, 500 us admission deadline (continuous batching), 5 s flush
    watchdog."""
    return ServeConfig(use_pallas=True, max_batch=4096,
                       max_wait_us=500.0, min_batch=32,
                       flush_timeout_ms=5000.0)


def smoke_serve_config() -> ServeConfig:
    """The dry run's shape: small flushes."""
    return ServeConfig(use_pallas=True, max_batch=256)
