"""The paper's serving workload: the dry-run cells (`make_cell`, below)
and the runnable `ServeConfig` consumed by `WCSDServer` and
`launch.dryrun --serve`. Port of the reference package's
`configs/wcsd_serve.py`.

The cells serve a ~1M-vertex padded store (width 256), replicated, with
the query batch over ("pod", "data"): `serve_1m` answers 2^20 queries
through `kernels.ops.wcsd_query` (K9 on the card), `profile_1m` 2^17
staircases through `core.query.profile_batch_torch` (the chunked plain
join, as the reference's `profile_batch_jnp` is jnp)."""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.query import profile_batch_torch
from ..kernels.ops import wcsd_query
from ..launch.mesh import Spec as P
from .cell import Cell, abstract

SHAPES = ["serve_1m", "profile_1m"]


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


_V = 1 << 20          # vertices
_L = 256              # padded label width
_B = 1 << 20          # queries per step
_W = 8                # quality levels of the profile serving cell
_BP = 1 << 17         # profile queries per step (each answers _W+1 levels)


def get_config():
    return {"V": _V, "L": _L, "B": _B}


def smoke_config():
    return {"V": 256, "L": 16, "B": 64}


def make_cell(shape: str = "serve_1m", multi_pod: bool = False) -> Cell:
    bd = ("pod", "data") if multi_pod else "data"
    lspec = P(None, None)   # labels replicated (3 GiB total)
    label_args = tuple(abstract((_V, _L), torch.int32)      # hub, dist, wlev
                       for _ in range(3)) + (abstract((_V,), torch.int32),)
    if shape == "profile_1m":
        # every query returns the full (W + 1)-level staircase from one
        # label sweep
        args = label_args + (abstract((_BP,), torch.int32),   # s
                             abstract((_BP,), torch.int32))   # t
        meta = {"family": "wcsd", "scan_trips": 1,
                # per query: L*L join + (W+1) bucketed min passes
                "model_flops": 2.0 * _BP * _L * _L * (_W + 1),
                "note": "one-pass profile serving cell (staircase per "
                        "query; see docs/profile-queries.md)"}
        return Cell("wcsd-serve", shape, "serve",
                    functools.partial(profile_batch_torch, num_levels=_W),
                    args, (lspec,) * 3 + (P(None), P(bd), P(bd)), P(bd), (),
                    meta, outs=abstract((_BP, _W + 1), torch.int32))
    args = label_args + tuple(abstract((_B,), torch.int32)   # s, t, w
                              for _ in range(3))
    meta = {"family": "wcsd", "scan_trips": 1,
            # per query: L*L compares + L*L adds (VPU op count proxy)
            "model_flops": 2.0 * _B * _L * _L,
            "note": "paper-technique serving cell (bonus, not in the 40)"}
    return Cell("wcsd-serve", shape, "serve", wcsd_query, args,
                (lspec, lspec, lspec, P(None), P(bd), P(bd), P(bd)), P(bd),
                (), meta, outs=abstract((_B,), torch.int32))


def label_rows(V: int, L: int, generator: torch.Generator,
               levels: int = _W) -> tuple:
    """A random padded store [V, L] on the generator's device, shaped as
    a built index's: each row ``count`` in [1, L] real cells, hubs skewed
    to the top ranks (``V u^4``) and sorted ascending, then pads (hub -1,
    dist INF_DIST, wlev -1); distances in [1, 2^16), levels in [0,
    ``levels``]. Returns (hub, dist, wlev, count), int32."""
    dev = generator.device
    count = torch.empty(V, dtype=torch.int32, device=dev)
    count.random_(1, L + 1, generator=generator)
    u = torch.rand((V, L), generator=generator, device=dev)
    hub = torch.sort((u.pow_(4) * V).to(torch.int32), dim=1).values
    del u
    pad = torch.arange(L, device=dev)[None, :] >= count[:, None]
    hub.masked_fill_(pad, -1)
    dist = torch.empty((V, L), dtype=torch.int32, device=dev)
    dist.random_(1, 1 << 16, generator=generator).masked_fill_(pad, 1 << 30)
    wlev = torch.empty((V, L), dtype=torch.int32, device=dev)
    wlev.random_(0, levels + 1, generator=generator).masked_fill_(pad, -1)
    return hub, dist, wlev, count


def concrete_args(cell: Cell, generator: torch.Generator) -> tuple:
    """A cell's arguments drawn on the generator's device: `label_rows`,
    then the queries' s and t among the vertices and (``serve_1m``)
    their levels in [0, W]."""
    V, L = cell.args[0].shape
    queries = []
    for k, q in enumerate(cell.args[4:]):
        x = torch.empty(q.shape, dtype=q.dtype, device=generator.device)
        queries.append(x.random_(0, V if k < 2 else _W + 1,
                                 generator=generator))
    return label_rows(V, L, generator) + tuple(queries)
