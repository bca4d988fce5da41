"""Host side of the WC-Index (paper §IV): the padded index and the
sequential builder (Algorithm 3), the CSR-packed label store, the
lane-tiled arena the query kernels read (and its compressed form), the
incremental builder the device-resident construction streams into, the
packed index, and the dynamic index (a base store plus a delta of
corrected rows) that follows a mutating graph.

Host-side numpy, ported from the reference package's `core/wc_index.py`
(`WCIndex`, `build_wc_index`, `PackedLabels` with its padded ``[V, cap]``
mirror, `LabelArena`, `CompressedArena`, `PackedLabelsBuilder`,
`PackedWCIndex`, `DeltaLabelStore`, `DynamicWCIndex`).
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

from ..checkpoint.ckpt import _wcx_arrays
from .graph import Graph, INF_DIST, expand_frontier_csr, mutate_edges
from .ordering import make_order
from .resilience import IndexIntegrityError

LANE = 128  # arena tile width; bucket widths are multiples of this


def round_to_lane(n: int, lane: int = LANE) -> int:
    """Smallest multiple of ``lane`` >= max(n, 1): the width the padded
    store is shipped at when it is served through the K9 kernel."""
    return max(lane, -(-int(n) // lane) * lane)


def ceil_to(n: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``n``."""
    return -(-int(n) // m) * m


def _concat_ranges(lengths: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated, vectorized."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(cum, lengths)


def _verify_blob_crcs(owner: str, checksums: dict, expected: dict) -> None:
    """Compare live blob CRC32s against a recorded baseline: any drift
    (bit rot, an injected flip, a torn copy) raises the typed error and
    never serves a wrong distance."""
    bad = sorted(name for name, crc in expected.items()
                 if checksums.get(name) != crc)
    if bad:
        raise IndexIntegrityError(
            f"{owner}: blob checksum mismatch in {bad} — the live arrays "
            "no longer match their recorded CRC32 baseline; refusing to "
            "serve")


def merge_query_rows(hs, ds, ws, ht, dt, wt, w_level: int) -> int:
    """Sort-merge over two hub-sorted label rows (paper Algorithm 5).
    Within a (vertex, hub) group dist and wlev both rise (Thm. 3), so the
    first entry with wlev >= w carries the least feasible distance."""
    cs, ct = len(hs), len(ht)
    best = int(INF_DIST)
    i = j = 0
    while i < cs and j < ct:
        if hs[i] < ht[j]:
            i += 1
        elif hs[i] > ht[j]:
            j += 1
        else:
            hub = hs[i]
            di = dj = -1
            while i < cs and hs[i] == hub:
                if di < 0 and ws[i] >= w_level:
                    di = int(ds[i])
                i += 1
            while j < ct and ht[j] == hub:
                if dj < 0 and wt[j] >= w_level:
                    dj = int(dt[j])
                j += 1
            if di >= 0 and dj >= 0 and di + dj < best:
                best = di + dj
    return best


@dataclasses.dataclass
class WCIndex:
    """The padded index `build_wc_index` returns: ``[V, cap]`` label rows
    (pads hub -1, dist INF_DIST, wlev -1) and their lengths."""

    order: np.ndarray      # [V] rank -> vertex
    rank: np.ndarray       # [V] vertex -> rank
    levels: np.ndarray     # [W] quality values
    hub_rank: np.ndarray   # [V, cap]
    dist: np.ndarray       # [V, cap]
    wlev: np.ndarray       # [V, cap]
    count: np.ndarray      # [V]

    @property
    def num_levels(self) -> int:
        return int(len(self.levels))

    @property
    def num_nodes(self) -> int:
        return int(len(self.order))

    @property
    def label_capacity(self) -> int:
        return int(self.hub_rank.shape[1])

    def size_entries(self) -> int:
        return int(self.count.sum())

    def memory_bytes(self) -> int:
        # 3 int32 per entry + count array (logical size, not capacity)
        return int(self.size_entries() * 12 + self.count.nbytes)

    def labels_of(self, v: int) -> np.ndarray:
        """[(hub_vertex, dist, wlev)] rows, for inspection and tests."""
        c = int(self.count[v])
        return np.stack([self.order[self.hub_rank[v, :c]],
                         self.dist[v, :c], self.wlev[v, :c]], axis=1)

    def level_of(self, w: float) -> int:
        return int(np.searchsorted(self.levels, w, side="left"))

    def query_one(self, s: int, t: int, w_level: int) -> int:
        """One query: the sort-merge over the two hub-sorted rows."""
        cs, ct = int(self.count[s]), int(self.count[t])
        return merge_query_rows(self.hub_rank[s, :cs], self.dist[s, :cs],
                                self.wlev[s, :cs], self.hub_rank[t, :ct],
                                self.dist[t, :ct], self.wlev[t, :ct],
                                w_level)

    def query_batch(self, s: np.ndarray, t: np.ndarray, w_level: np.ndarray
                    ) -> np.ndarray:
        """Batched queries by the masked outer join over the padded rows."""
        s = np.asarray(s)
        t = np.asarray(t)
        w_level = np.asarray(w_level)
        col = np.arange(self.hub_rank.shape[1])
        ms = (col[None, :] < self.count[s, None]) & \
             (self.wlev[s] >= w_level[:, None])
        mt = (col[None, :] < self.count[t, None]) & \
             (self.wlev[t] >= w_level[:, None])
        hub_eq = self.hub_rank[s][:, :, None] == self.hub_rank[t][:, None, :]
        ok = hub_eq & ms[:, :, None] & mt[:, None, :]
        dsum = self.dist[s][:, :, None].astype(np.int64) + \
            self.dist[t][:, None, :]
        dsum = np.where(ok, dsum, INF_DIST)
        return np.minimum(dsum.min(axis=(1, 2)), INF_DIST).astype(np.int32)

    def packed(self, lane: int = LANE) -> "PackedLabels":
        """CSR-packed view of the labels (see `PackedLabels`)."""
        return PackedLabels.from_index(self, lane=lane)

    def padded_device_arrays(self, cap: int | None = None):
        """(hub_rank, dist, wlev, count) trimmed or padded to ``cap``
        columns; an overlong row keeps its first ``cap - 1`` entries plus
        its trailing self entry, and count is clamped to ``cap``."""
        c = int(cap if cap is not None else max(int(self.count.max()), 1))
        V = self.num_nodes

        def fit(a, fill):
            out = np.full((V, c), fill, dtype=np.int32)
            k = min(c, a.shape[1])
            out[:, :k] = a[:, :k]
            return out
        hub, dist, wlev = (fit(self.hub_rank, -1), fit(self.dist, INF_DIST),
                           fit(self.wlev, -1))
        over = np.flatnonzero(self.count > c)
        if len(over):
            last = self.count[over].astype(np.int64) - 1  # the self entry
            hub[over, c - 1] = self.hub_rank[over, last]
            dist[over, c - 1] = self.dist[over, last]
            wlev[over, c - 1] = self.wlev[over, last]
        return hub, dist, wlev, np.minimum(self.count, c).astype(np.int32)


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

    @staticmethod
    def from_index(idx: "WCIndex", lane: int = LANE) -> "PackedLabels":
        """Flatten a padded `WCIndex` (entry j of vertex v -> offsets[v]
        + j)."""
        V = idx.num_nodes
        count = idx.count.astype(np.int64)
        offsets = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(count, out=offsets[1:])
        rows = np.repeat(np.arange(V, dtype=np.int64), count)
        cols = _concat_ranges(count)
        return PackedLabels.from_flat(idx.hub_rank[rows, cols],
                                      idx.dist[rows, cols],
                                      idx.wlev[rows, cols], offsets,
                                      lane=lane)

    @property
    def num_nodes(self) -> int:
        return int(len(self.offsets) - 1)

    @property
    def num_buckets(self) -> int:
        return int(len(self.bucket_widths))

    def size_entries(self) -> int:
        return int(len(self.hub_rank))

    def row(self, v: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        s, e = int(self.offsets[v]), int(self.offsets[v + 1])
        return self.hub_rank[s:e], self.dist[s:e], self.wlev[s:e]

    def memory_bytes(self) -> int:
        """Flat CSR store: 3 int32 per entry + the offset array."""
        return int(self.hub_rank.nbytes + self.dist.nbytes + self.wlev.nbytes
                   + self.offsets.nbytes)

    def tile_memory_bytes(self) -> int:
        """Bucket tiles: sum_b n_b * W_b entries * 3 int32."""
        n_b = np.array([len(m) for m in self.bucket_vertices], dtype=np.int64)
        return int((n_b * self.bucket_widths.astype(np.int64)).sum() * 12)

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

    def level_of(self, w: float) -> int:
        return int(np.searchsorted(self.levels, w, side="left"))

    def query_one(self, s: int, t: int, w_level: int) -> int:
        """Host sort-merge (Alg. 5) straight over the CSR rows."""
        return merge_query_rows(*self.labels.row(s), *self.labels.row(t),
                                w_level)

    def query_batch(self, s, t, w_level) -> np.ndarray:
        """Numpy oracle through the padded mirror (small workloads)."""
        return self.to_index().query_batch(s, t, w_level)

    def to_index(self) -> WCIndex:
        """The padded `WCIndex` of the same labels."""
        hub, dist, wlev, count = self.labels.to_padded()
        return WCIndex(order=self.order, rank=self.rank, levels=self.levels,
                       hub_rank=hub, dist=dist, wlev=wlev, count=count)

    def checksums(self) -> dict:
        """CRC32 per blob, the table `checkpoint.ckpt.save_packed_index`
        writes (same names, same dtypes), so checksums of a loaded file, a
        live index and a saved one all compare."""
        return {name: zlib.crc32(a.tobytes())
                for name, a in _wcx_arrays(self).items()}

    def verify_integrity(self, expected: dict | None = None) -> dict:
        """Re-hash every blob against a baseline: ``expected``, else the
        table `load_packed_index` stamped, else the current state (stamped
        as the new baseline). A mismatch raises `IndexIntegrityError`;
        returns the passing checksums."""
        sums = self.checksums()
        baseline = expected or getattr(self, "_expected_crc", None)
        if baseline is None:
            self._expected_crc = sums
            return sums
        _verify_blob_crcs("PackedWCIndex", sums, baseline)
        return sums


def as_packed_index(idx: "WCIndex | PackedWCIndex") -> PackedWCIndex:
    """Either index flavor in the CSR-packed form (the base format the
    dynamic index keeps)."""
    if isinstance(idx, PackedWCIndex):
        return idx
    return PackedWCIndex(order=idx.order, rank=idx.rank, levels=idx.levels,
                         labels=idx.packed())


def _row_key(hub: np.ndarray, dist: np.ndarray, wlev: np.ndarray) -> set:
    """Hashable entry set of one label row (tombstone accounting)."""
    return set(zip(hub.tolist(), dist.tolist(), wlev.tolist()))


@dataclasses.dataclass
class DeltaLabelStore:
    """Correction layer over an immutable base `PackedLabels` store.

    ``rows`` maps a touched vertex to its full corrected label row
    (hub-sorted, closed by the self entry, as the base rows are). A
    corrected row replaces the vertex's base row when serving; the base
    store is never written: its entries for touched vertices are
    tombstoned (no tile pointer reaches them any more) until the next
    compaction. ``tombstoned`` / ``corrections`` count base entries
    invalidated and delta entries added since the last compaction.
    """

    graph_version: int = 0
    rows: dict = dataclasses.field(default_factory=dict)
    tombstoned: int = 0
    corrections: int = 0

    def is_empty(self) -> bool:
        return not self.rows

    def delta_entries(self) -> int:
        """Entries resident in the delta (full corrected rows, self
        entries included)."""
        return int(sum(len(h) for h, _, _ in self.rows.values()))

    def record(self, base: "PackedLabels", new_rows: dict) -> None:
        """Fold freshly recomputed rows in: a row equal to its base row
        leaves the delta; the counters track the symmetric difference
        against the base store."""
        for v, (h, d, w) in new_rows.items():
            bh, bd, bw = base.row(v)
            if (len(bh) == len(h) and np.array_equal(bh, h)
                    and np.array_equal(bd, d) and np.array_equal(bw, w)):
                self.rows.pop(v, None)
                continue
            self.rows[v] = (np.ascontiguousarray(h, dtype=np.int32),
                            np.ascontiguousarray(d, dtype=np.int32),
                            np.ascontiguousarray(w, dtype=np.int32))
        self.tombstoned = 0
        self.corrections = 0
        for v, (h, d, w) in self.rows.items():
            bset = _row_key(*base.row(v))
            nset = _row_key(h, d, w)
            self.tombstoned += len(bset - nset)
            self.corrections += len(nset - bset)

    def reset(self) -> None:
        """Drop every correction (after a compaction). ``graph_version``
        stays: it counts graph mutations, not delta generations."""
        self.rows.clear()
        self.tombstoned = 0
        self.corrections = 0

    def extend_arena(self, base_arena: "LabelArena",
                     lane: int | None = None) -> "LabelArena":
        """The serving arena: the base arena's tiles verbatim, then one
        lane-tiled delta region holding every corrected row, with the
        touched vertices' ``tile_base`` redirected into it. Both regions
        are one tile space, so a ragged flush over them stays one kernel
        launch (delta tiles are ordinary worklist items)."""
        lane = base_arena.lane if lane is None else int(lane)
        if lane != base_arena.lane:
            raise ValueError(f"lane {lane} differs from the base arena's "
                             f"{base_arena.lane}")
        if not self.rows:
            return base_arena
        touched = sorted(self.rows)
        cnts = np.array([max(-(-len(self.rows[v][0]) // lane), 1)
                         for v in touched], dtype=np.int64)
        Td = int(cnts.sum())
        dh = np.full((Td, lane), -1, dtype=np.int32)
        dd = np.full((Td, lane), INF_DIST, dtype=np.int32)
        dw = np.full((Td, lane), -1, dtype=np.int32)
        tile_base = base_arena.tile_base.copy()
        tile_cnt = base_arena.tile_cnt.copy()
        T0 = base_arena.num_tiles
        at = 0
        for v, c in zip(touched, cnts):
            h, d, w = self.rows[v]
            n = len(h)
            dh[at:at + c].reshape(-1)[:n] = h
            dd[at:at + c].reshape(-1)[:n] = d
            dw[at:at + c].reshape(-1)[:n] = w
            tile_base[v] = T0 + at
            tile_cnt[v] = int(c)
            at += int(c)
        return LabelArena(
            hub=np.concatenate([base_arena.hub, dh]),
            dist=np.concatenate([base_arena.dist, dd]),
            wlev=np.concatenate([base_arena.wlev, dw]),
            tile_base=tile_base, tile_cnt=tile_cnt,
            tile_lo=np.concatenate([base_arena.tile_lo, dh[:, 0]]),
            tile_hi=np.concatenate([base_arena.tile_hi,
                                    dh.max(axis=1).astype(np.int32)]))

    def merged_flat(self, base: "PackedLabels"):
        """Merged flat CSR arrays (hub, dist, wlev, offsets): base rows
        for untouched vertices, corrected rows for touched ones -- the
        store the bucket-pair and padded paths and the host oracles
        read."""
        V = base.num_nodes
        count = (base.offsets[1:] - base.offsets[:-1]).astype(np.int64)
        for v, (h, _, _) in self.rows.items():
            count[v] = len(h)
        offsets = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(count, out=offsets[1:])
        E = int(offsets[-1])
        hub = np.empty(E, dtype=np.int32)
        dist = np.empty(E, dtype=np.int32)
        wlev = np.empty(E, dtype=np.int32)
        untouched = np.ones(V, dtype=bool)
        if self.rows:
            untouched[np.fromiter(self.rows, dtype=np.int64,
                                  count=len(self.rows))] = False
        uv = np.flatnonzero(untouched)
        lens = count[uv]
        pos = np.repeat(offsets[uv], lens) + _concat_ranges(lens)
        src = np.repeat(base.offsets[uv], lens) + _concat_ranges(lens)
        hub[pos] = base.hub_rank[src]
        dist[pos] = base.dist[src]
        wlev[pos] = base.wlev[src]
        for v, (h, d, w) in self.rows.items():
            o = int(offsets[v])
            hub[o:o + len(h)] = h
            dist[o:o + len(h)] = d
            wlev[o:o + len(h)] = w
        return hub, dist, wlev, offsets


class DynamicWCIndex:
    """A WC-Index that follows a mutating graph: an immutable base
    `PackedWCIndex` plus a `DeltaLabelStore` of corrected rows, re-derived
    on every update by re-running the pruned rank-ordered BFS rounds for
    the affected roots only (`wc_index_batched.rebuild_affected_rows`,
    host numpy).

    It has the engine interface (``packed()``, ``padded_device_arrays()``,
    ``num_levels``), so `DeviceQueryEngine` and `WCSDServer` serve it as
    any static index. Under the ragged dispatch its arena is the base
    arena with the delta region appended (`DeltaLabelStore.extend_arena`):
    every flush stays one kernel launch.

    `compact()` re-runs the device builder on the current graph: the new
    base is byte-identical to a from-scratch build on the mutated graph.
    """

    def __init__(self, base: "WCIndex | PackedWCIndex", graph: Graph):
        self.base = as_packed_index(base)
        self.graph = graph
        self.delta = DeltaLabelStore(graph_version=int(
            getattr(graph, "version", 0)))
        self._packed_cache: dict = {}

    @property
    def order(self):
        return self.base.order

    @property
    def rank(self):
        return self.base.rank

    @property
    def levels(self):
        return self.base.levels

    @property
    def num_levels(self) -> int:
        return self.base.num_levels

    @property
    def num_nodes(self) -> int:
        return self.base.num_nodes

    @property
    def graph_version(self) -> int:
        return self.delta.graph_version

    def level_of(self, w: float) -> int:
        return self.base.level_of(w)

    def size_entries(self) -> int:
        return self.packed().size_entries()

    def delta_ratio(self) -> float:
        """Compaction trigger: delta-resident entries relative to the base
        store's size."""
        return self.delta.delta_entries() / max(self.base.size_entries(), 1)

    def apply_updates(self, inserts=(), deletes=()) -> dict:
        """Mutate the graph and fold the label corrections into the delta.
        Exact: serving equals a from-scratch build on the mutated graph at
        every level. Returns stats."""
        from .wc_index_batched import affected_vertices, rebuild_affected_rows

        g_old = self.graph
        g_new = mutate_edges(g_old, inserts=inserts, deletes=deletes)
        endpoints = sorted({int(x) for e in inserts for x in e[:2]}
                           | {int(x) for e in deletes for x in e[:2]})
        affected = affected_vertices(g_old, g_new, endpoints)
        new_rows = rebuild_affected_rows(
            g_new, self.base.order, self.base.rank,
            num_levels=self.num_levels,
            merged_flat=self.delta.merged_flat(self.base.labels),
            affected=affected)
        self.delta.record(self.base.labels, new_rows)
        self.delta.graph_version += 1
        self.graph = g_new
        self._packed_cache.clear()
        return {"affected_roots": int(len(affected)),
                "touched_rows": int(len(new_rows)),
                "delta_rows": int(len(self.delta.rows)),
                "delta_entries": self.delta.delta_entries(),
                "tombstoned": int(self.delta.tombstoned),
                "corrections": int(self.delta.corrections),
                "graph_version": self.graph_version}

    def compact(self, device=None, **build_kwargs) -> dict:
        """Fold the delta into a fresh base: the device builder
        (`build_wc_index_batched_packed`, K3/K4 on the card unless
        ``device="cpu"``) on the current graph; byte-identical to a build
        from scratch on the mutated graph."""
        from .wc_index_batched import build_wc_index_batched_packed
        idx, stats = build_wc_index_batched_packed(self.graph, device=device,
                                                   **build_kwargs)
        self.base = idx
        self.delta.reset()
        self._packed_cache.clear()
        return stats

    def packed(self, lane: int = LANE) -> "PackedLabels":
        """The merged serving store: the base store itself while the delta
        is empty; otherwise a merged `PackedLabels` whose arena (its
        ``_arena_cache``) is the base arena with the delta region appended,
        not a repack of the base tiles."""
        if self.delta.is_empty():
            return self.base.packed(lane=lane)
        if lane not in self._packed_cache:
            merged = PackedLabels.from_flat(
                *self.delta.merged_flat(self.base.labels), lane=lane)
            base_packed = self.base.packed(lane=lane)
            merged.__dict__["_arena_cache"] = {
                lane: self.delta.extend_arena(base_packed.arena(lane=lane),
                                              lane=lane)}
            self._packed_cache[lane] = merged
        return self._packed_cache[lane]

    def padded_device_arrays(self, cap: int | None = None):
        return self.packed().to_padded(cap)

    def to_index(self) -> WCIndex:
        hub, dist, wlev, count = self.packed().to_padded()
        return WCIndex(order=self.order, rank=self.rank, levels=self.levels,
                       hub_rank=hub, dist=dist, wlev=wlev, count=count)

    def query_one(self, s: int, t: int, w_level: int) -> int:
        store = self.packed()
        return merge_query_rows(*store.row(s), *store.row(t), w_level)

    def query_batch(self, s, t, w_level) -> np.ndarray:
        return self.to_index().query_batch(s, t, w_level)


def _ensure_capacity(idx_arrays, count, need):
    """Grow padded label arrays so every vertex in `need` fits one more."""
    hub, dist, wlev = idx_arrays
    cap = hub.shape[1]
    max_need = int((count[need] + 1).max()) if len(need) else 0
    if max_need <= cap:
        return idx_arrays
    new_cap = max(max_need, cap * 2, 4)
    V = hub.shape[0]

    def grow(a, fill):
        out = np.full((V, new_cap), fill, dtype=a.dtype)
        out[:, :cap] = a
        return out
    return grow(hub, -1), grow(dist, INF_DIST), grow(wlev, -1)


def append_self_entries(hub, dist, wlev, count, rank, W):
    """Append (rank[v], 0, W) to every vertex, keeping rows hub-sorted
    (rank[v] exceeds every stored hub rank of v by construction)."""
    V = len(count)
    allv = np.arange(V, dtype=np.int32)
    hub, dist, wlev = _ensure_capacity((hub, dist, wlev), count, allv)
    pos = count[allv]
    hub[allv, pos] = rank[allv]
    dist[allv, pos] = 0
    wlev[allv, pos] = W
    count = count + 1
    return hub, dist, wlev, count


def _relax_root(g: Graph, rank, k: int, root: int, W: int, T, R, touched_R,
                hub, dist, wlev, count, prune: bool):
    """One root's pruned constrained BFS (Algorithm 3, lines 7-17): rounds
    in distance order, R keeping the best bottleneck level per vertex,
    each frontier vertex pruned by a query on the partial index through
    the root's hub table T, survivors emitted as (k, d, level) entries.
    Returns the (possibly grown) label arrays and the emitted vertices."""
    frontier_v = np.array([root], dtype=np.int32)
    frontier_w = np.array([W], dtype=np.int32)
    emitted = []
    d = 0
    while len(frontier_v):
        if d > 0:
            if prune:
                col = np.arange(hub.shape[1])
                m = (col[None, :] < count[frontier_v, None]) & \
                    (wlev[frontier_v] >= frontier_w[:, None])
                tv = T[np.clip(hub[frontier_v], 0, len(count) - 1),
                       frontier_w[:, None]]
                cand = np.where(
                    m, dist[frontier_v].astype(np.int64) + tv, INF_DIST)
                survive = cand.min(axis=1) > d
                frontier_v = frontier_v[survive]
                frontier_w = frontier_w[survive]
                if len(frontier_v) == 0:
                    break
            hub, dist, wlev = _ensure_capacity((hub, dist, wlev), count,
                                               frontier_v)
            pos = count[frontier_v]
            hub[frontier_v, pos] = k
            dist[frontier_v, pos] = d
            wlev[frontier_v, pos] = frontier_w
            count[frontier_v] += 1
            emitted.append(frontier_v)
        src_pos, nbrs, lvls = expand_frontier_csr(g, frontier_v)
        w_new = np.minimum(frontier_w[src_pos], lvls)
        valid = (rank[nbrs] > k) & (w_new > R[nbrs])
        nbrs, w_new = nbrs[valid], w_new[valid]
        if len(nbrs):
            np.maximum.at(R, nbrs, w_new)
            cands = np.unique(nbrs)
            touched_R.append(cands)
            frontier_v = cands
            frontier_w = R[cands].copy()
        else:
            frontier_v = np.zeros(0, dtype=np.int32)
            frontier_w = np.zeros(0, dtype=np.int32)
        d += 1
    return hub, dist, wlev, emitted


def _seed_hub_table(T, hr, dr, wr, W: int) -> None:
    """T[h, f] = min(T[h, f], d) for every entry (h, d, wl) and f <= wl: an
    entry answers every query level up to its own."""
    reps = (wr + 1).astype(np.int64)
    rows = np.repeat(hr.astype(np.int64), reps)
    np.minimum.at(T.reshape(-1), rows * (W + 1) + _concat_ranges(reps),
                  np.repeat(dr, reps))


def build_wc_index(g: Graph, order: np.ndarray | None = None,
                   ordering: str = "degree", prune: bool = True,
                   max_roots: int | None = None) -> WCIndex:
    """Sequential construction (paper Algorithm 3 + §IV-C), host numpy.

    ``prune=False`` disables index-based pruning (R-pruning still bounds
    the BFS). ``max_roots`` limits the hub set (a partial index: queries
    are sound only for pairs the processed hubs cover)."""
    V, W = g.num_nodes, g.num_levels
    if order is None:
        order = make_order(g, ordering)
    order = np.asarray(order, dtype=np.int32)
    rank = np.empty(V, dtype=np.int32)
    rank[order] = np.arange(V, dtype=np.int32)

    cap0 = 8
    hub = np.full((V, cap0), -1, dtype=np.int32)
    dist = np.full((V, cap0), INF_DIST, dtype=np.int32)
    wlev = np.full((V, cap0), -1, dtype=np.int32)
    count = np.zeros(V, dtype=np.int32)

    # per-root hub table T[hub_rank, level], width W+1 (column W: the
    # infinite quality of self entries), and R, reset lazily through the
    # touched lists (no O(V) clear per root)
    T = np.full((V, W + 1), INF_DIST, dtype=np.int32)
    touched_T: list[np.ndarray] = []
    R = np.full(V, -1, dtype=np.int32)
    touched_R: list[np.ndarray] = []

    n_roots = V if max_roots is None else min(V, max_roots)
    for k in range(n_roots):
        root = int(order[k])
        c = int(count[root])
        if c:
            hr = hub[root, :c]
            _seed_hub_table(T, hr, dist[root, :c], wlev[root, :c], W)
            touched_T.append(hr.copy())
        T[k, :] = 0  # the root reaches itself at distance 0, any quality
        touched_T.append(np.array([k], dtype=np.int32))
        R[root] = W
        touched_R.append(np.array([root], dtype=np.int32))
        hub, dist, wlev, _ = _relax_root(g, rank, k, root, W, T, R,
                                         touched_R, hub, dist, wlev, count,
                                         prune)
        for arr in touched_T:
            T[arr] = INF_DIST
        touched_T.clear()
        for arr in touched_R:
            R[arr] = -1
        touched_R.clear()

    hub, dist, wlev, count = append_self_entries(hub, dist, wlev, count,
                                                 rank, W)
    return WCIndex(order=order, rank=rank, levels=g.levels.copy(),
                   hub_rank=hub, dist=dist, wlev=wlev, count=count)


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


def index_from_arrays(arrays: dict) -> WCIndex:
    """Rebuild a padded `WCIndex` from its fields as numpy arrays
    (``order``, ``rank``, ``levels``, ``hub_rank``, ``dist``, ``wlev``,
    ``count``): how a padded index crosses over from another
    implementation."""
    return WCIndex(
        order=np.asarray(arrays["order"], dtype=np.int32),
        rank=np.asarray(arrays["rank"], dtype=np.int32),
        levels=np.asarray(arrays["levels"], dtype=np.float64),
        **{k: np.array(arrays[k], dtype=np.int32)
           for k in ("hub_rank", "dist", "wlev", "count")})


def delta_store_from_arrays(arrays: dict) -> DeltaLabelStore:
    """Rebuild a `DeltaLabelStore` from ``graph_version``, ``rows``
    ({vertex: (hub, dist, wlev)}), ``tombstoned`` and ``corrections``."""
    return DeltaLabelStore(
        graph_version=int(arrays["graph_version"]),
        rows={int(v): tuple(np.ascontiguousarray(a, dtype=np.int32)
                            for a in r)
              for v, r in arrays["rows"].items()},
        tombstoned=int(arrays.get("tombstoned", 0)),
        corrections=int(arrays.get("corrections", 0)))
