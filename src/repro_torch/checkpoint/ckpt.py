"""Checkpoints, on-disk WC-Index persistence and the crash-safe update
WAL, host numpy: the port's own reader and writer of the reference
package's formats (`checkpoint/ckpt.py` there), so that each package
loads the files the other writes, byte for byte the same for the same
index.

  * `CheckpointManager`: training state (a tree of tensors, `train.tree`)
    as ``step_%08d/state.npz`` + ``manifest.json``, written to a ``.tmp``
    directory and moved into place with `os.replace`, the oldest removed
    beyond ``keep``. The npz keys are the reference's (``params/cin/w0``,
    ``opt_state/.m/embed``, ``opt_state/.step``), so a checkpoint of
    either package restores in the other. A leaf stored by its `Spec`
    over a mesh (`launch.mesh.Sharded`) is written as the global array
    under its own key, as the reference writes a sharded `jax.Array`,
    and restored onto the like-state leaf's mesh by that leaf's spec:
    a restart may land on a mesh of another size.
  * `save_packed_index` / `load_packed_index`: the WCX v2 file (magic,
    JSON header, 64-byte aligned blobs with a CRC32 each, mmap loads,
    read-only arrays) and the typed `IndexPersistenceError` family.
  * `UpdateWAL`: the checksummed append-only log of `apply_updates`
    batches that `core/serve.py` replays on a warm start.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
import zlib

import numpy as np
import torch

from ..core.resilience import IndexIntegrityError, WALError, WALReplayError
from ..launch.mesh import Sharded, join_leaf, shard_leaf
from ..train.tree import flatten_global, map_sharded

CPU = torch.device("cpu")


def _host(leaf) -> np.ndarray:
    """A leaf as a host array; a `Sharded` leaf joined there (the global
    array)."""
    if isinstance(leaf, Sharded):
        leaf = join_leaf(leaf, CPU)
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _write_npz(path: str, leaves: dict) -> dict:
    """`np.savez(path, **arrays)`, entry for entry the same bytes, with
    each array made (`_host`) only as it is written: the host holds one
    gathered leaf at a time. Returns {key: (shape, dtype)}."""
    meta = {}
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in leaves.items():
            a = np.asanyarray(_host(leaf))
            # np.savez forces zip64 on every entry (numpy gh-10776)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=True)
            meta[key] = (list(a.shape), str(a.dtype))
            del a
    return meta


def _restore_leaf(a: np.ndarray, like):
    """A loaded array in the place of ``like``: a `Sharded` leaf stored
    by its spec over its mesh (each block on its device), a tensor on
    its device, anything else the array."""
    if isinstance(like, Sharded):
        return shard_leaf(torch.from_numpy(a), like.spec, like.mesh)
    if torch.is_tensor(like):
        return torch.from_numpy(a).to(like.device)
    return a


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, state, extra: dict | None = None) -> str:
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        meta = _write_npz(os.path.join(tmp, "state.npz"),
                          flatten_global(state))
        manifest = {
            "step": step,
            "leaves": {k: {"shape": shape, "dtype": dtype}
                       for k, (shape, dtype) in meta.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        self._gc()
        return path

    # -------------------------------------------------------------- restore
    def _steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, like_state, step: int | None = None):
        """(state, step): the checkpoint at ``step`` (the latest by
        default) in the structure of ``like_state``, whose leaves' (global)
        shapes must match. A tensor leaf comes back as a tensor of the
        saved dtype on that leaf's device, a `Sharded` leaf as the saved
        array stored by that leaf's spec over its mesh (each block on its
        device), any other leaf as a numpy array."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        restored = {}
        with np.load(os.path.join(path, "state.npz")) as data:
            for k, leaf in flatten_global(like_state).items():
                a = data[k]
                want = tuple(getattr(leaf, "shape", np.shape(leaf)))
                if tuple(a.shape) != want:
                    raise ValueError(f"shape mismatch for {k}: {a.shape} vs "
                                     f"{want}")
                restored[k] = _restore_leaf(a, leaf)
        keys = iter(restored)
        return map_sharded(lambda _: restored[next(keys)], like_state), step

    def manifest(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)


# ---------------------------------------------------------------------------
# On-disk WC-Index persistence.
#
# Single-file format, designed for mmap zero-copy loads so sharded serving
# replicas warm-start without rebuilding (and without even reading the whole
# file eagerly):
#
#   [ 8B magic "WCSDIDX\x01" ][ 8B little-endian header length H ]
#   [ H bytes JSON header ][ zero pad to 64 ][ raw array blobs, 64-aligned ]
#
# The JSON header carries the format version, the graph version the index
# was built against, num_nodes / num_levels, and for every array its dtype,
# shape, absolute byte offset, length and CRC32, plus the expected payload
# end — a truncation check that does not require hashing the payload.
# Loads go through numpy memmaps: `PackedLabels.from_flat` keeps contiguous
# int32 views as-is, so the arena pages in lazily on first query. Format
# version 2 added the per-blob CRC32 table: `load_packed_index` verifies
# every blob against it by default (a single byte flipped anywhere in the
# payload raises `IndexIntegrityError` instead of loading silently), and
# stamps the expected checksums onto the returned index so
# `PackedWCIndex.verify_integrity()` can re-check the live arrays on
# demand.

WCX_MAGIC = b"WCSDIDX\x01"
WCX_VERSION = 2
_WCX_ALIGN = 64


class IndexPersistenceError(RuntimeError):
    """Base class: a persisted index file cannot be served."""


class IndexHeaderError(IndexPersistenceError):
    """Bad magic or unparseable header — not a WC-Index file."""


class IndexVersionError(IndexPersistenceError):
    """The file's format version is not one this reader understands."""


class IndexTruncatedError(IndexPersistenceError):
    """The payload ends before the header says it should (torn write,
    partial copy, mid-write crash)."""


def _wcx_arrays(idx) -> dict:
    labels = idx.labels
    return {
        "order": np.ascontiguousarray(idx.order, dtype=np.int32),
        "rank": np.ascontiguousarray(idx.rank, dtype=np.int32),
        "levels": np.ascontiguousarray(idx.levels, dtype=np.float64),
        "hub_rank": np.ascontiguousarray(labels.hub_rank, dtype=np.int32),
        "dist": np.ascontiguousarray(labels.dist, dtype=np.int32),
        "wlev": np.ascontiguousarray(labels.wlev, dtype=np.int32),
        "offsets": np.ascontiguousarray(labels.offsets, dtype=np.int64),
    }


def save_packed_index(path: str, idx, *, graph_version: int = 0,
                      _open=open) -> str:
    """Persist a `PackedWCIndex` (or anything `as_packed_index` accepts).

    Atomic: writes to ``path + ".tmp"`` then `os.replace`, so readers never
    observe a half-written file under ``path`` — a crash mid-write leaves at
    most a stale tmp file behind. ``_open`` is injectable for fault tests
    (checkpoint/fault.py `crashing_open`)."""
    from ..core.wc_index import as_packed_index
    idx = as_packed_index(idx)
    arrays = _wcx_arrays(idx)
    table = {}
    base = 0  # filled once the header length is known
    blobs = []
    off = 0
    for name, a in arrays.items():
        off = -(-off // _WCX_ALIGN) * _WCX_ALIGN
        table[name] = {"dtype": str(a.dtype), "shape": list(a.shape),
                       "offset": off, "nbytes": int(a.nbytes),
                       "crc32": zlib.crc32(a.tobytes())}
        blobs.append((off, a))
        off += int(a.nbytes)
    header = {
        "version": WCX_VERSION,
        "graph_version": int(graph_version),
        "num_nodes": int(idx.num_nodes),
        "num_levels": int(idx.num_levels),
        "arrays": table,
        "payload_bytes": off,
    }
    hjson = json.dumps(header, sort_keys=True).encode()
    base = len(WCX_MAGIC) + 8 + len(hjson)
    base = -(-base // _WCX_ALIGN) * _WCX_ALIGN
    tmp = path + ".tmp"
    with _open(tmp, "wb") as f:
        f.write(WCX_MAGIC)
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        f.write(b"\0" * (base - len(WCX_MAGIC) - 8 - len(hjson)))
        at = 0
        for off, a in blobs:
            if off > at:
                f.write(b"\0" * (off - at))
                at = off
            f.write(a.tobytes())
            at += a.nbytes
    os.replace(tmp, path)
    return path


def load_packed_index(path: str, *, mmap: bool = True, verify: bool = True):
    """Load a persisted index; returns ``(PackedWCIndex, header_dict)``.

    Validates magic, format version and payload length BEFORE constructing
    anything — a truncated or foreign file raises the typed error and never
    yields a partially-loaded arena. With ``mmap=True`` (default) array
    blobs are `np.memmap` views: zero-copy, paged in on first touch.

    With ``verify=True`` (default) every blob is additionally checked
    against the header's CRC32 table: a single flipped byte anywhere in
    the payload raises `IndexIntegrityError` instead of loading silently
    (the cost is one sequential read of the payload — under mmap the
    pages stay warm for serving). The expected checksums are stamped on
    the returned index, so `PackedWCIndex.verify_integrity()` re-checks
    the live arrays on demand. ``verify=False`` keeps loads lazy/zero-
    copy; `verify_integrity(expected={name: crc...})` with the header's
    table performs the same check later."""
    from ..core.wc_index import PackedLabels, PackedWCIndex
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise IndexPersistenceError(f"cannot stat {path!r}: {e}") from e
    with open(path, "rb") as f:
        magic = f.read(len(WCX_MAGIC))
        if magic != WCX_MAGIC:
            raise IndexHeaderError(
                f"{path!r} is not a WC-Index file (magic {magic!r})")
        raw = f.read(8)
        if len(raw) < 8:
            raise IndexTruncatedError(f"{path!r}: truncated header length")
        hlen = int.from_bytes(raw, "little")
        hjson = f.read(hlen)
        if len(hjson) < hlen:
            raise IndexTruncatedError(f"{path!r}: truncated header")
        try:
            header = json.loads(hjson)
        except ValueError as e:
            raise IndexHeaderError(f"{path!r}: unparseable header") from e
    version = header.get("version")
    if version != WCX_VERSION:
        raise IndexVersionError(
            f"{path!r}: format version {version!r}, reader supports "
            f"{WCX_VERSION}")
    base = len(WCX_MAGIC) + 8 + hlen
    base = -(-base // _WCX_ALIGN) * _WCX_ALIGN
    expected = base + int(header["payload_bytes"])
    if size < expected:
        raise IndexTruncatedError(
            f"{path!r}: {size} bytes on disk, header promises {expected}")
    out = {}
    for name, spec in header["arrays"].items():
        shape = tuple(spec["shape"])
        dtype = np.dtype(spec["dtype"])
        off = base + int(spec["offset"])
        if mmap:
            out[name] = np.memmap(path, mode="r", dtype=dtype, shape=shape,
                                  offset=off)
        else:
            with open(path, "rb") as f:
                f.seek(off)
                buf = f.read(int(spec["nbytes"]))
            if len(buf) < int(spec["nbytes"]):
                raise IndexTruncatedError(f"{path!r}: short read of {name}")
            out[name] = np.frombuffer(buf, dtype=dtype).reshape(shape)
    expected = {name: spec["crc32"]
                for name, spec in header["arrays"].items()
                if "crc32" in spec}
    if verify:
        bad = [name for name, crc in expected.items()
               if zlib.crc32(out[name].tobytes()) != crc]
        if bad:
            raise IndexIntegrityError(
                f"{path!r}: blob checksum mismatch in {sorted(bad)} — "
                "bit rot or torn copy; refusing to serve")
    labels = PackedLabels.from_flat(out["hub_rank"], out["dist"],
                                    out["wlev"], out["offsets"])
    idx = PackedWCIndex(order=out["order"], rank=out["rank"],
                        levels=out["levels"], labels=labels)
    idx._expected_crc = expected or None
    return idx, header


# ---------------------------------------------------------------------------
# Crash-safe update WAL.
#
# `WCSDServer.apply_updates` appends each mutation batch here BEFORE the
# index is touched, so a crash anywhere between the append and the engine
# rebuild loses nothing: a replica warm-starting from the last persisted
# index (`load_packed_index`) replays the WAL tail and converges to the
# pre-crash graph version exactly (applying a logged record from the
# pre-crash state is idempotent by construction — it is the apply that
# never happened). Layout:
#
#   [ 8B magic "WCSDWAL\x01" ][ 8B little-endian base_version ]
#   [ records: 4B LE payload length | 4B LE CRC32 | JSON payload ]...
#
# ``base_version`` is the graph version the log starts from; record k
# carries ``graph_version == base_version + k + 1`` (every apply bumps by
# exactly one — a gap is corruption, not truncation). A torn TAIL record
# (mid-append crash, injected via `fault.crashing_open`) is tolerated:
# replay stops at the first short/CRC-failing record, which is exactly
# the append that never committed. `truncate` reuses the save path's
# atomic tmp + `os.replace` idiom, so compaction can never tear the log.

WAL_MAGIC = b"WCSDWAL\x01"


class UpdateWAL:
    """Checksummed append-only log of `apply_updates` mutation batches.

    ``_open`` is injectable for fault tests (`fault.crashing_open` tears
    an append mid-record); ``fsync=False`` trades durability for append
    speed (benchmarked as ``wal_append_us``)."""

    def __init__(self, path: str, *, base_version: int = 0,
                 fsync: bool = True, _open=open):
        self.path = path
        self._fsync = bool(fsync)
        self._open = _open
        if not os.path.exists(path):
            self._reset(base_version)

    # ------------------------------------------------------------ plumbing
    def _reset(self, base_version: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(WAL_MAGIC)
            f.write(int(base_version).to_bytes(8, "little"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def base_version(self) -> int:
        return self._scan()[0]

    def _scan(self) -> tuple[int, list[dict], bool]:
        """(base_version, committed records, torn_tail). Stops at the
        first short or checksum-failing record — under the append
        protocol that can only be the mid-crash tail; anything after it
        was never acknowledged."""
        try:
            with open(self.path, "rb") as f:
                head = f.read(len(WAL_MAGIC) + 8)
                if (len(head) < len(WAL_MAGIC) + 8
                        or head[:len(WAL_MAGIC)] != WAL_MAGIC):
                    raise WALError(f"{self.path!r} is not a WCSD WAL "
                                   f"(header {head[:8]!r})")
                base = int.from_bytes(head[len(WAL_MAGIC):], "little")
                records, torn, expect = [], False, base + 1
                while True:
                    hdr = f.read(8)
                    if not hdr:
                        break                      # clean EOF
                    if len(hdr) < 8:
                        torn = True
                        break
                    n = int.from_bytes(hdr[:4], "little")
                    crc = int.from_bytes(hdr[4:], "little")
                    payload = f.read(n)
                    if len(payload) < n or zlib.crc32(payload) != crc:
                        torn = True
                        break
                    try:
                        rec = json.loads(payload)
                    except ValueError:
                        torn = True
                        break
                    if rec.get("graph_version") != expect:
                        raise WALError(
                            f"{self.path!r}: record sequence gap — got "
                            f"graph_version {rec.get('graph_version')!r}, "
                            f"expected {expect}")
                    records.append(rec)
                    expect += 1
        except OSError as e:
            raise WALError(f"cannot read WAL {self.path!r}: {e}") from e
        return base, records, torn

    # ------------------------------------------------------------- writing
    def append(self, inserts=(), deletes=(), *, graph_version: int) -> int:
        """Log one mutation batch (the graph version it will PRODUCE);
        returns the record's byte size. Flushed (and fsynced unless
        constructed with ``fsync=False``) before returning — once this
        returns, a crash-restart replay re-applies the batch."""
        payload = json.dumps(
            {"graph_version": int(graph_version),
             "inserts": [[int(u), int(v), float(q)] for u, v, q in inserts],
             "deletes": [[int(u), int(v)] for u, v in deletes]},
            sort_keys=True).encode()
        rec = (len(payload).to_bytes(4, "little")
               + zlib.crc32(payload).to_bytes(4, "little") + payload)
        with self._open(self.path, "ab") as f:
            f.write(rec)
            f.flush()
            if self._fsync:
                try:
                    os.fsync(f.fileno())
                except (AttributeError, OSError):
                    pass
        return len(rec)

    def truncate(self, base_version: int) -> None:
        """Drop every record (compaction folded them into the base
        index) and restart the log at ``base_version``. Atomic."""
        self._reset(int(base_version))

    # ------------------------------------------------------------- reading
    def records(self) -> list[dict]:
        """Every committed record, oldest first (torn tail excluded)."""
        return self._scan()[1]

    def replay(self, start_version: int = 0) -> list[dict]:
        """The records a warm start from ``start_version`` must apply,
        in order. Raises `WALReplayError` when the log no longer reaches
        back to ``start_version`` (compacted past the checkpoint)."""
        base, records, _torn = self._scan()
        if start_version < base:
            raise WALReplayError(
                f"{self.path!r}: checkpoint at graph version "
                f"{start_version} predates the WAL base {base} — the log "
                "was compacted past it; warm-start from a newer "
                "checkpoint")
        return [r for r in records if r["graph_version"] > start_version]
