"""Host side of the WC-Index (paper §IV): the CSR-packed label store, the
lane-tiled arena the query kernels read (and its compressed form), the
incremental builder the device-resident construction streams into, and
the packed index.

Host-side numpy, ported from the reference package's `core/wc_index.py`
(`PackedLabels` with its padded ``[V, cap]`` mirror, `LabelArena`,
`CompressedArena`, `PackedLabelsBuilder`, `PackedWCIndex`).
Label entry layout, per vertex:
  hub_rank  rank of the hub; rows are hub-sorted and close with the self
            entry (rank[v], 0, num_levels).
  dist      w-constrained distance to the hub
  wlev      quality *level* of the minimal path; ``num_levels`` encodes
            the infinite quality of self entries.
Within one (vertex, hub) group both dist and wlev are strictly increasing
(Thm. 3).
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from .graph import INF_DIST
from .resilience import IndexIntegrityError

LANE = 128  # arena tile width; bucket widths are multiples of this


def round_to_lane(n: int, lane: int = LANE) -> int:
    """Smallest multiple of ``lane`` >= max(n, 1): the width the padded
    store is shipped at when it is served through the K9 kernel."""
    return max(lane, -(-int(n) // lane) * lane)


def _concat_ranges(lengths: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated, vectorized."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(cum, lengths)


@dataclasses.dataclass
class PackedLabels:
    """CSR-packed label store.

      hub_rank/dist/wlev : [E] flat arrays, vertex-major, hub-sorted rows.
      offsets            : [V+1] CSR row pointers.

    Vertices are also length-bucketed (widths lane * 2^b): bucket b holds
    every vertex whose label length fits ``bucket_widths[b]``.
    """

    hub_rank: np.ndarray       # [E] int32
    dist: np.ndarray           # [E] int32
    wlev: np.ndarray           # [E] int32
    offsets: np.ndarray        # [V+1] int64
    bucket_widths: np.ndarray  # [NB] int32 padded widths, ascending
    bucket_of: np.ndarray      # [V] int32 bucket id per vertex
    slot_of: np.ndarray        # [V] int32 row of the vertex inside its bucket
    bucket_vertices: list      # [NB] arrays: bucket slot -> vertex id

    @staticmethod
    def from_flat(hub: np.ndarray, dist: np.ndarray, wlev: np.ndarray,
                  offsets: np.ndarray, lane: int = LANE) -> "PackedLabels":
        """Wrap already-flat CSR label arrays (vertex-major, hub-sorted rows)
        and derive the length-bucketed routing tables."""
        offsets = np.asarray(offsets, dtype=np.int64)
        V = len(offsets) - 1
        count = offsets[1:] - offsets[:-1]
        need = np.maximum(count, 1)
        blog = np.ceil(np.log2(np.maximum(np.ceil(need / lane), 1))
                       ).astype(np.int64)
        widths_all = lane * (1 << blog)                      # [V]
        uniq = np.unique(widths_all)
        bucket_of = np.searchsorted(uniq, widths_all).astype(np.int32)
        slot_of = np.zeros(V, dtype=np.int32)
        bucket_vertices = []
        for b in range(len(uniq)):
            members = np.flatnonzero(bucket_of == b).astype(np.int32)
            slot_of[members] = np.arange(len(members), dtype=np.int32)
            bucket_vertices.append(members)
        return PackedLabels(hub_rank=np.ascontiguousarray(hub, dtype=np.int32),
                            dist=np.ascontiguousarray(dist, dtype=np.int32),
                            wlev=np.ascontiguousarray(wlev, dtype=np.int32),
                            offsets=offsets,
                            bucket_widths=uniq.astype(np.int32),
                            bucket_of=bucket_of, slot_of=slot_of,
                            bucket_vertices=bucket_vertices)

    @property
    def num_nodes(self) -> int:
        return int(len(self.offsets) - 1)

    @property
    def num_buckets(self) -> int:
        return int(len(self.bucket_widths))

    def size_entries(self) -> int:
        return int(len(self.hub_rank))

    def memory_bytes(self) -> int:
        """Flat CSR store: 3 int32 per entry + the offset array."""
        return int(self.hub_rank.nbytes + self.dist.nbytes + self.wlev.nbytes
                   + self.offsets.nbytes)

    def arena(self, lane: int = LANE) -> "LabelArena":
        """The lane-tiled arena view of this store (cached per lane)."""
        cache = self.__dict__.setdefault("_arena_cache", {})
        if lane not in cache:
            cache[lane] = LabelArena.from_packed(self, lane=lane)
        return cache[lane]

    def compressed_arena(self, lane: int = LANE,
                         dtype: str = "bfloat16") -> "CompressedArena":
        """Compressed view of `arena` (cached per (lane, dtype)); see
        `CompressedArena`."""
        cache = self.__dict__.setdefault("_carena_cache", {})
        key = (lane, dtype)
        if key not in cache:
            cache[key] = CompressedArena.from_arena(self.arena(lane=lane),
                                                    dtype=dtype)
        return cache[key]

    def bucket_tiles(self, b: int):
        """Bucket b as padded [n_b, W_b] (hub, dist, wlev) int32 tiles, the
        rows the bucket-pair kernels read. Pad cells carry hub -1, dist
        INF_DIST, wlev -1: a pad never passes the ``wlev >= w`` mask and
        falls below every profile level."""
        members = self.bucket_vertices[b]
        W = int(self.bucket_widths[b])
        n = len(members)
        hub = np.full((n, W), -1, dtype=np.int32)
        dist = np.full((n, W), INF_DIST, dtype=np.int32)
        wlev = np.full((n, W), -1, dtype=np.int32)
        lens = (self.offsets[members + 1] - self.offsets[members])
        rows = np.repeat(np.arange(n, dtype=np.int64), lens)
        cols = _concat_ranges(lens)
        flat = np.repeat(self.offsets[members], lens) + cols
        hub[rows, cols] = self.hub_rank[flat]
        dist[rows, cols] = self.dist[flat]
        wlev[rows, cols] = self.wlev[flat]
        return hub, dist, wlev

    def to_padded(self, cap: int | None = None):
        """The padded ``[V, cap]`` mirror of the store: (hub_rank, dist,
        wlev, count), pads hub -1, dist INF_DIST, wlev -1. ``cap=None`` is
        the longest row (at least 1). A row longer than ``cap`` keeps its
        first ``cap - 1`` entries plus its trailing self entry (dropping
        it would answer every ``s == t`` query wrongly), and count is
        clamped to ``cap``."""
        V = self.num_nodes
        count = (self.offsets[1:] - self.offsets[:-1]).astype(np.int32)
        c = int(cap if cap is not None else max(int(count.max()), 1))
        hub = np.full((V, c), -1, dtype=np.int32)
        dist = np.full((V, c), INF_DIST, dtype=np.int32)
        wlev = np.full((V, c), -1, dtype=np.int32)
        lens = np.minimum(count.astype(np.int64), c)
        rows = np.repeat(np.arange(V, dtype=np.int64), lens)
        cols = _concat_ranges(lens)
        flat = np.repeat(self.offsets[:-1], lens) + cols
        hub[rows, cols] = self.hub_rank[flat]
        dist[rows, cols] = self.dist[flat]
        wlev[rows, cols] = self.wlev[flat]
        over = np.flatnonzero(count > c)
        if len(over):
            last = self.offsets[over + 1] - 1        # the self entry
            hub[over, c - 1] = self.hub_rank[last]
            dist[over, c - 1] = self.dist[last]
            wlev[over, c - 1] = self.wlev[last]
        return hub, dist, wlev, np.minimum(count, c).astype(np.int32)


@dataclasses.dataclass
class LabelArena:
    """Lane-tiled flat label arena, the layout the ragged query kernels read.

    Every CSR row starts at a lane-aligned offset, so any row is
    ``tile_cnt[v]`` whole ``[lane]`` tiles from tile ``tile_base[v]``.

      hub/dist/wlev : [T, lane] int32 tiles; in-row pad cells carry hub -1,
                      dist INF_DIST, wlev -1.
      tile_base     : [V] int32 first tile of vertex v's row
      tile_cnt      : [V] int32 ``ceil(len(v) / lane)`` (>= 1)
      tile_lo/hi    : [T] int32 min/max real hub rank inside each tile
                      (rows are hub-sorted, so two tiles whose intervals
                      are disjoint cannot meet).
    """

    hub: np.ndarray        # [T, lane] int32
    dist: np.ndarray       # [T, lane] int32
    wlev: np.ndarray       # [T, lane] int32
    tile_base: np.ndarray  # [V] int32
    tile_cnt: np.ndarray   # [V] int32
    tile_lo: np.ndarray    # [T] int32
    tile_hi: np.ndarray    # [T] int32

    @property
    def num_tiles(self) -> int:
        return int(self.hub.shape[0])

    @property
    def lane(self) -> int:
        return int(self.hub.shape[1])

    def memory_bytes(self) -> int:
        """Device-resident footprint: 3 int32 per arena cell + the per-row
        and per-tile index tables."""
        return int(self.hub.nbytes + self.dist.nbytes + self.wlev.nbytes
                   + self.tile_base.nbytes + self.tile_cnt.nbytes
                   + self.tile_lo.nbytes + self.tile_hi.nbytes)

    @staticmethod
    def from_packed(packed: "PackedLabels", lane: int = LANE) -> "LabelArena":
        offsets = packed.offsets
        V = packed.num_nodes
        count = offsets[1:] - offsets[:-1]                     # [V] int64
        tile_cnt = np.maximum(-(-count // lane), 1).astype(np.int64)
        tile_base = np.zeros(V, dtype=np.int64)
        np.cumsum(tile_cnt[:-1], out=tile_base[1:])
        T = int(tile_cnt.sum())
        hub = np.full((T, lane), -1, dtype=np.int32)
        dist = np.full((T, lane), INF_DIST, dtype=np.int32)
        wlev = np.full((T, lane), -1, dtype=np.int32)
        pos = np.repeat(tile_base * lane, count) + _concat_ranges(count)
        hub.reshape(-1)[pos] = packed.hub_rank
        dist.reshape(-1)[pos] = packed.dist
        wlev.reshape(-1)[pos] = packed.wlev
        # hub-sorted rows + tail pads of -1: lo is the first cell, hi the max
        tile_lo = hub[:, 0].copy()
        tile_hi = hub.max(axis=1).astype(np.int32)
        return LabelArena(hub=hub, dist=dist, wlev=wlev,
                          tile_base=tile_base.astype(np.int32),
                          tile_cnt=tile_cnt.astype(np.int32),
                          tile_lo=tile_lo, tile_hi=tile_hi)

    def checksums(self) -> dict:
        """CRC32 of every arena blob."""
        return {name: zlib.crc32(np.ascontiguousarray(
                    getattr(self, name)).tobytes())
                for name in ("hub", "dist", "wlev", "tile_base",
                             "tile_cnt", "tile_lo", "tile_hi")}

    def verify_integrity(self, expected: dict | None = None) -> dict:
        """Re-hash the tiles against a baseline and raise
        `IndexIntegrityError` on any mismatch. The first call with no
        ``expected`` stamps the current checksums as the baseline."""
        sums = self.checksums()
        baseline = expected or getattr(self, "_expected_crc", None)
        if baseline is None:
            object.__setattr__(self, "_expected_crc", sums)
            return sums
        bad = sorted(name for name, crc in baseline.items()
                     if sums.get(name) != crc)
        if bad:
            raise IndexIntegrityError(
                f"LabelArena: blob checksum mismatch in {bad} — the live "
                "arrays no longer match their recorded CRC32 baseline; "
                "refusing to serve")
        return sums


# any stored distance at or above the kernels' DEV_INF is "no path" and
# decodes back to INF_DIST
_DEV_INF = 1 << 29
_I16_MAX = int(np.iinfo(np.int16).max)   # 32767: hub-delta ceiling
_I8_MAX = int(np.iinfo(np.int8).max)     # 127: wlev ceiling
_F16_MAX_DIST = 65000                    # fp16 finite headroom
# the compressed distance formats, by the name `CompressedArena.dist_dtype`
# carries
FLOAT_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def float16_bits(x: np.ndarray, dtype: str) -> np.ndarray:
    """float64 values -> the uint16 bit patterns of ``dtype`` ("bfloat16"
    or "float16"), rounded to nearest even straight from float64 by
    torch's cast (values past the format's range become +inf)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))
    return t.to(FLOAT_DTYPES[dtype]).view(torch.int16).numpy() \
        .view(np.uint16)


@dataclasses.dataclass
class CompressedArena:
    """Compressed lane-tiled arena: the tile geometry of `LabelArena` at
    5 bytes per cell instead of 12, decoded inside the compressed ragged
    kernels (K5, K6).

    Per-cell encoding (the reference package's docs/index-format.md §6):

      hub_delta : [T, lane] int16 -- ``hub - tile_lo[t]`` for real cells
                  (rows are hub-sorted, so deltas are non-negative); pad
                  cells keep -1, so the sign is the pad flag.
      dist      : [T, lane] uint16 -- the bit patterns of ``dist_dtype``
                  ("bfloat16" or "float16"): real distances rounded to
                  the float format; INF_DIST pads and any value >= DEV_INF
                  encode as +inf, which the decoder clamps to DEV_INF.
                  (numpy has no bfloat16: on the card the array is viewed
                  as ``torch.bfloat16`` / ``torch.float16``.)
      wlev      : [T, lane] int8 -- quality levels; pads keep -1.

    A tile the narrow encoding cannot hold -- a real hub more than 32,767
    ranks above ``tile_lo``, a level past 127, or (float16 only) a finite
    distance past 65,000 -- is flagged in ``overflow`` and kept verbatim
    in the int32 side tables (``side_*``, one row per flagged tile, found
    through ``side_slot``). `decode` restores it exactly; the engine
    refuses to serve a store with any flagged tile compressed and serves
    the uncompressed arena instead.

    Distance precision: bfloat16 is exact up to 256 and within 2^-8
    relative error beyond; float16 exact up to 2048, 2^-11 beyond.
    """

    hub_delta: np.ndarray  # [T, lane] int16
    dist: np.ndarray       # [T, lane] uint16 bit patterns of dist_dtype
    dist_dtype: str        # "bfloat16" | "float16"
    wlev: np.ndarray       # [T, lane] int8
    tile_base: np.ndarray  # [V] int32
    tile_cnt: np.ndarray   # [V] int32
    tile_lo: np.ndarray    # [T] int32
    tile_hi: np.ndarray    # [T] int32
    overflow: np.ndarray   # [T] bool: the tile lives in the side tables
    side_slot: np.ndarray  # [T] int32: row in side_* (0 where not flagged)
    side_hub: np.ndarray   # [n_overflow, lane] int32
    side_dist: np.ndarray  # [n_overflow, lane] int32
    side_wlev: np.ndarray  # [n_overflow, lane] int32

    @property
    def num_tiles(self) -> int:
        return int(self.hub_delta.shape[0])

    @property
    def lane(self) -> int:
        return int(self.hub_delta.shape[1])

    @property
    def num_overflow_tiles(self) -> int:
        return int(self.side_hub.shape[0])

    def memory_bytes(self) -> int:
        """Device-resident footprint: compressed cells + index tables +
        whatever side tables the overflowed tiles forced."""
        return int(self.hub_delta.nbytes + self.dist.nbytes
                   + self.wlev.nbytes + self.tile_base.nbytes
                   + self.tile_cnt.nbytes + self.tile_lo.nbytes
                   + self.tile_hi.nbytes + self.overflow.nbytes
                   + self.side_slot.nbytes + self.side_hub.nbytes
                   + self.side_dist.nbytes + self.side_wlev.nbytes)

    @staticmethod
    def from_arena(ar: "LabelArena",
                   dtype: str = "bfloat16") -> "CompressedArena":
        if dtype not in FLOAT_DTYPES:
            raise ValueError(f"unsupported compressed dist dtype: {dtype!r}")
        hub, dist, wlev = ar.hub, ar.dist, ar.wlev
        pad = hub < 0
        real = ~pad
        delta = hub.astype(np.int64) - ar.tile_lo[:, None].astype(np.int64)
        no_path = dist >= _DEV_INF
        ovf = ((real & (delta > _I16_MAX)).any(axis=1)
               | (real & (wlev > _I8_MAX)).any(axis=1))
        if dtype == "float16":
            ovf |= (real & ~no_path & (dist > _F16_MAX_DIST)).any(axis=1)
        hub_delta = np.where(pad, -1, np.clip(delta, 0, _I16_MAX)
                             ).astype(np.int16)
        dist_c = float16_bits(np.where(no_path, np.inf,
                                       dist.astype(np.float64)), dtype)
        wlev_c = np.clip(wlev, -1, _I8_MAX).astype(np.int8)
        slots = np.flatnonzero(ovf)
        side_slot = np.zeros(hub.shape[0], dtype=np.int32)
        side_slot[slots] = np.arange(len(slots), dtype=np.int32)
        return CompressedArena(
            hub_delta=hub_delta, dist=dist_c, dist_dtype=dtype, wlev=wlev_c,
            tile_base=ar.tile_base, tile_cnt=ar.tile_cnt,
            tile_lo=ar.tile_lo, tile_hi=ar.tile_hi,
            overflow=ovf, side_slot=side_slot,
            side_hub=hub[slots].copy(), side_dist=dist[slots].copy(),
            side_wlev=wlev[slots].copy())

    def decode(self) -> "LabelArena":
        """Inverse of the encoding: hub ids and levels bit-exact, distances
        within the float bound above, flagged tiles verbatim from the side
        tables."""
        d16 = self.hub_delta.astype(np.int32)
        hub = np.where(d16 >= 0, self.tile_lo[:, None] + d16,
                       -1).astype(np.int32)
        df = torch.from_numpy(self.dist.view(np.int16)).view(
            FLOAT_DTYPES[self.dist_dtype]).to(torch.float64).numpy()
        inf = ~np.isfinite(df) | (df >= float(_DEV_INF))
        dist = np.where(inf, INF_DIST,
                        np.rint(np.where(inf, 0.0, df))).astype(np.int32)
        wlev = self.wlev.astype(np.int32)
        if self.overflow.any():
            rows = np.flatnonzero(self.overflow)
            slot = self.side_slot[rows]
            hub[rows] = self.side_hub[slot]
            dist[rows] = self.side_dist[slot]
            wlev[rows] = self.side_wlev[slot]
        return LabelArena(hub=hub, dist=dist, wlev=wlev,
                          tile_base=self.tile_base, tile_cnt=self.tile_cnt,
                          tile_lo=self.tile_lo, tile_hi=self.tile_hi)


class PackedLabelsBuilder:
    """Incremental-append producer of a `PackedLabels` store.

    The device builder emits labels one root batch at a time; each batch
    covers an ascending slice of hub ranks. `finalize` runs the fused
    Pareto post-pass + one vertex-major sort + self-entry append.

    append_batch contract: within a batch, entries sorted by (vertex, hub
    ascending, dist ascending), and every hub rank strictly exceeds all hub
    ranks previously appended for that vertex.
    """

    def __init__(self, num_nodes: int, lane: int = LANE):
        self.num_nodes = int(num_nodes)
        self.lane = int(lane)
        self._chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]] = []
        self._total = 0

    def append_batch(self, v: np.ndarray, hub: np.ndarray, dist: np.ndarray,
                     wlev: np.ndarray) -> None:
        if len(v) == 0:
            return
        self._chunks.append((np.asarray(v, dtype=np.int32).copy(),
                             np.asarray(hub, dtype=np.int32).copy(),
                             np.asarray(dist, dtype=np.int32).copy(),
                             np.asarray(wlev, dtype=np.int32).copy()))
        self._total += len(v)

    def size_entries(self) -> int:
        return self._total

    def finalize(self, rank: np.ndarray, num_levels: int,
                 minimalize: bool = True) -> tuple["PackedLabels", int]:
        """Emit the CSR store: Pareto-filter per (vertex, hub), scatter into
        vertex-major flat arrays, append one self entry per vertex. Returns
        (store, dominated_entries_removed)."""
        from .dominance import pareto_csr_emit

        V, W = self.num_nodes, int(num_levels)
        if self._chunks:
            v_all = np.concatenate([c[0] for c in self._chunks])
            h_all = np.concatenate([c[1] for c in self._chunks])
            d_all = np.concatenate([c[2] for c in self._chunks])
            w_all = np.concatenate([c[3] for c in self._chunks])
        else:
            v_all = h_all = d_all = w_all = np.zeros(0, dtype=np.int32)
        removed = 0
        if minimalize:
            order, keep = pareto_csr_emit(v_all, h_all, d_all, w_all, V)
            order = order[keep]
            removed = int(len(keep) - keep.sum())
        else:
            order = np.lexsort((d_all, h_all, v_all))
        v_all, h_all = v_all[order], h_all[order]
        d_all, w_all = d_all[order], w_all[order]
        count = np.bincount(v_all, minlength=V).astype(np.int64) + 1
        offsets = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(count, out=offsets[1:])
        E = int(offsets[-1])
        hub = np.empty(E, dtype=np.int32)
        dist = np.empty(E, dtype=np.int32)
        wlev = np.empty(E, dtype=np.int32)
        pos = np.repeat(offsets[:-1], count - 1) + _concat_ranges(count - 1)
        hub[pos], dist[pos], wlev[pos] = h_all, d_all, w_all
        # self entries close each row; rank[v] exceeds every stored hub rank
        self_pos = offsets[1:] - 1
        hub[self_pos] = np.asarray(rank, dtype=np.int32)
        dist[self_pos] = 0
        wlev[self_pos] = W
        store = PackedLabels.from_flat(hub, dist, wlev, offsets,
                                       lane=self.lane)
        return store, removed


@dataclasses.dataclass
class PackedWCIndex:
    """A WC-Index whose labels live only in the CSR-packed store — the
    output of `core.wc_index_batched.build_wc_index_batched_packed`, served
    as-is by `core.query.DeviceQueryEngine`."""

    order: np.ndarray        # [V] rank -> vertex
    rank: np.ndarray         # [V] vertex -> rank
    levels: np.ndarray       # [W] quality values
    labels: "PackedLabels"

    @property
    def num_levels(self) -> int:
        return int(len(self.levels))

    @property
    def num_nodes(self) -> int:
        return int(len(self.order))

    def size_entries(self) -> int:
        return self.labels.size_entries()

    def memory_bytes(self) -> int:
        return self.labels.memory_bytes()

    def packed(self, lane: int = LANE) -> "PackedLabels":
        """The store itself; a non-default ``lane`` re-buckets the flat
        arrays (only the routing tables are rebuilt)."""
        if lane != LANE:
            return PackedLabels.from_flat(self.labels.hub_rank,
                                          self.labels.dist, self.labels.wlev,
                                          self.labels.offsets, lane=lane)
        return self.labels

    def padded_device_arrays(self, cap: int | None = None):
        """(hub_rank, dist, wlev, count) of the padded ``[V, cap]`` store
        (see `PackedLabels.to_padded`)."""
        return self.labels.to_padded(cap)


def packed_index_from_arrays(arrays: dict) -> PackedWCIndex:
    """Rebuild a `PackedWCIndex` from its fields as numpy arrays: ``order``,
    ``rank``, ``levels``, ``hub_rank``, ``dist``, ``wlev``, ``offsets``
    (and optionally ``lane``). The bucket tables are re-derived through
    `PackedLabels.from_flat`. This is how an index crosses over from
    another implementation."""
    lane = int(arrays.get("lane", LANE))
    labels = PackedLabels.from_flat(
        np.asarray(arrays["hub_rank"]), np.asarray(arrays["dist"]),
        np.asarray(arrays["wlev"]), np.asarray(arrays["offsets"]), lane=lane)
    return PackedWCIndex(order=np.asarray(arrays["order"], dtype=np.int32),
                         rank=np.asarray(arrays["rank"], dtype=np.int32),
                         levels=np.asarray(arrays["levels"],
                                           dtype=np.float64),
                         labels=labels)
