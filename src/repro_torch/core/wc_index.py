"""Host side of the WC-Index (paper §IV): the CSR-packed label store, the
lane-tiled arena the query kernels read, the incremental builder the
device-resident construction streams into, and the packed index.

Host-side numpy, ported from the reference package's `core/wc_index.py`
(`PackedLabels`, `LabelArena`, `PackedLabelsBuilder`, `PackedWCIndex`).
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

from .graph import INF_DIST
from .resilience import IndexIntegrityError

LANE = 128  # arena tile width; bucket widths are multiples of this


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
