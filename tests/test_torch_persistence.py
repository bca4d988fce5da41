"""The port's WCX v2 reader and writer and its update WAL against the
reference package's, on the CPU: the same bytes for the same index and
graph version, files loading both ways (mmap or not), the per-blob
bit-flip matrix, truncated / foreign / wrong-version files refused by the
same error classes, a torn write never tearing the served file, the WAL's
round trip, torn tail, sequence gap and compaction past a checkpoint, and
WAL files replayed across packages by warm-started dynamic servers."""
import json
import os
import warnings

import numpy as np
import pytest

from _torch_parity import PACKED_FIELDS, assert_same_fields, port_graph
from repro.checkpoint import ckpt as JC
from repro.checkpoint.fault import crashing_open as j_crashing_open
from repro.core.generators import erdos_renyi, scale_free
from repro.core.wc_index import as_packed_index as j_as_packed
from repro.core.wc_index import build_wc_index as j_build
from repro_torch.checkpoint import ckpt as TC
from repro_torch.checkpoint.fault import (MidWriteCrash, crashing_open,
                                          flip_byte_on_disk, tear_file_tail)
from repro_torch.core.baselines import constrained_distance_grid
from repro_torch.core.resilience import (IndexIntegrityError, WALError,
                                         WALReplayError)
from repro_torch.core.serve import WCSDServer as TServer
from repro_torch.core.wc_index import as_packed_index, build_wc_index

BLOBS = ("order", "rank", "levels", "hub_rank", "dist", "wlev", "offsets")


@pytest.fixture(scope="module")
def world():
    jg = erdos_renyi(30, 3.0, num_levels=4, seed=3)
    tg = port_graph(jg)
    return jg, tg, j_as_packed(j_build(jg)), as_packed_index(build_wc_index(tg))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("graph_version", [0, 7])
@pytest.mark.parametrize("gen", ["er", "sf"])
def test_wcx_bytes_equal_reference(tmp_path, gen, graph_version):
    """Same index, same graph version: the port writes the reference's
    bytes; a padded `WCIndex` is packed first, as the reference does."""
    jg = (erdos_renyi(30, 3.0, num_levels=4, seed=3) if gen == "er"
          else scale_free(120, 4, num_levels=5, seed=1))
    j, t = j_build(jg), build_wc_index(port_graph(jg))
    pj = JC.save_packed_index(str(tmp_path / "j.wcx"), j,
                              graph_version=graph_version)
    pt = TC.save_packed_index(str(tmp_path / "t.wcx"), t,
                              graph_version=graph_version)
    assert _read(pt) == _read(pj)
    assert not os.path.exists(pt + ".tmp")


@pytest.mark.parametrize("mmap", [True, False])
def test_files_load_both_ways(tmp_path, world, mmap):
    """Each package loads the other's file: equal arrays and header, the
    CRC table stamped for `verify_integrity`, read-only arrays."""
    jg, tg, jidx, tidx = world
    pj = JC.save_packed_index(str(tmp_path / "j.wcx"), jidx,
                              graph_version=3)
    pt = TC.save_packed_index(str(tmp_path / "t.wcx"), tidx,
                              graph_version=3)
    t_of_j, th = TC.load_packed_index(pj, mmap=mmap)
    j_of_t, jh = JC.load_packed_index(pt, mmap=mmap)
    assert th == jh and th["graph_version"] == 3
    assert_same_fields(t_of_j.labels, jidx.labels, PACKED_FIELDS)
    assert_same_fields(j_of_t.labels, tidx.labels, PACKED_FIELDS)
    for name in ("order", "rank", "levels"):
        np.testing.assert_array_equal(getattr(t_of_j, name),
                                      getattr(jidx, name))
    assert t_of_j.verify_integrity() == j_of_t.verify_integrity()
    assert not t_of_j.labels.dist.flags.writeable


def _flip_offset(path, name) -> int:
    with open(path, "rb") as f:
        f.read(8)
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
    base = -(-(16 + hlen) // 64) * 64
    spec = header["arrays"][name]
    return base + int(spec["offset"]) + int(spec["nbytes"]) // 2


@pytest.mark.parametrize("blob", BLOBS)
def test_bit_flip_in_every_blob_refused(tmp_path, world, blob):
    """One flipped byte in any blob: both readers raise
    `IndexIntegrityError` naming it; with ``verify=False`` the load is
    lazy, and `verify_integrity` against the header's table finds it."""
    _, _, _, tidx = world
    p = TC.save_packed_index(str(tmp_path / "i.wcx"), tidx)
    flip_byte_on_disk(p, _flip_offset(p, blob))
    for mod in (TC, JC):
        with pytest.raises(Exception) as e:
            mod.load_packed_index(p)
        assert type(e.value).__name__ == "IndexIntegrityError"
        assert blob in str(e.value)
    lazy, hdr = TC.load_packed_index(p, verify=False)
    with pytest.raises(IndexIntegrityError, match=blob):
        lazy.verify_integrity(
            {n: s["crc32"] for n, s in hdr["arrays"].items()})


@pytest.mark.parametrize("case,cls", [
    ("magic", "IndexHeaderError"), ("version", "IndexVersionError"),
    ("truncated", "IndexTruncatedError"), ("torn-header",
                                           "IndexTruncatedError"),
    ("missing", "IndexPersistenceError")])
def test_bad_files_refused_by_class(tmp_path, world, case, cls):
    """Foreign, wrong-version, truncated and missing files raise the same
    typed errors in both packages (subclasses of
    `IndexPersistenceError`)."""
    _, _, _, tidx = world
    p = TC.save_packed_index(str(tmp_path / "i.wcx"), tidx)
    raw = _read(p)
    if case == "magic":
        raw = b"NOTANIDX" + raw[8:]
    elif case == "version":
        hlen = int.from_bytes(raw[8:16], "little")
        hj = raw[16:16 + hlen].replace(b'"version": 2', b'"version": 9')
        raw = raw[:16] + hj + raw[16 + hlen:]
    elif case == "truncated":
        raw = raw[:-40]
    elif case == "torn-header":
        raw = raw[:20]
    if case == "missing":
        p = str(tmp_path / "absent.wcx")
    else:
        with open(p, "wb") as f:
            f.write(raw)
    for mod in (TC, JC):
        with pytest.raises(mod.IndexPersistenceError) as e:
            mod.load_packed_index(p)
        assert type(e.value).__name__ == cls


@pytest.mark.parametrize("budget", [0, 100, 1000])
def test_mid_write_crash_never_tears_the_served_file(tmp_path, world,
                                                     budget):
    """A crash while the tmp file is written leaves the served path as it
    was (absent, or the previous complete file) in the port, as with the
    reference's `crashing_open`."""
    _, _, jidx, tidx = world
    p = str(tmp_path / "i.wcx")
    with pytest.raises(MidWriteCrash):
        TC.save_packed_index(p, tidx, _open=crashing_open(budget))
    assert not os.path.exists(p)
    TC.save_packed_index(p, tidx, graph_version=1)
    good = _read(p)
    for opener in (crashing_open(budget), j_crashing_open(budget)):
        with pytest.raises(Exception, match="injected crash"):
            TC.save_packed_index(p, tidx, graph_version=2, _open=opener)
        assert _read(p) == good
    assert TC.load_packed_index(p)[1]["graph_version"] == 1


def test_loaded_index_serves_without_writable_arrays(tmp_path, world):
    """A read-only mmap load serves through every mode without a
    non-writable-tensor warning, equal to the BFS grid."""
    _, tg, _, tidx = world
    p = TC.save_packed_index(str(tmp_path / "i.wcx"), tidx)
    loaded, _ = TC.load_packed_index(p)
    D = constrained_distance_grid(tg)
    rng = np.random.default_rng(0)
    s, t = rng.integers(0, 30, 200), rng.integers(0, 30, 200)
    w = rng.integers(0, 5, 200)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for kw in (dict(), dict(compressed=True), dict(layout="padded"),
                   dict(dispatch="bucket_pair")):
            srv = TServer(loaded, device="cpu", **kw)
            np.testing.assert_array_equal(srv.query_many(s, t, w),
                                          D[s, t, w])
        dyn = TServer(loaded, graph=tg, device="cpu", compact_threshold=None)
        dyn.apply_updates(deletes=[(int(tg.edges_src[0]),
                                    int(tg.edges_dst[0]))])
        D2 = constrained_distance_grid(dyn.index.graph)
        np.testing.assert_array_equal(dyn.query_many(s, t, w), D2[s, t, w])


# -------------------------------------------------------------------- WAL
BATCHES = [([(0, 5, 1.0)], []), ([], [(1, 2)]), ([(3, 4, 2.0)], [(0, 5)])]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_round_trip_and_bytes(tmp_path, writer):
    """Records written by either package read back equal in both, the log
    files are byte-identical, and `truncate` restarts at a version."""
    paths = {}
    for name, mod in (("port", TC), ("reference", JC)):
        p = str(tmp_path / f"{name}.wal")
        wal = mod.UpdateWAL(p, base_version=4, fsync=False)
        for k, (ins, dels) in enumerate(BATCHES):
            wal.append(ins, dels, graph_version=5 + k)
        paths[name] = p
    assert _read(paths["port"]) == _read(paths["reference"])
    p = paths[writer]
    for mod in (TC, JC):
        wal = mod.UpdateWAL(p)
        assert wal.base_version() == 4
        assert [r["graph_version"] for r in wal.records()] == [5, 6, 7]
        assert [r["graph_version"] for r in wal.replay(5)] == [6, 7]
    assert TC.UpdateWAL(p).records() == JC.UpdateWAL(p).records()
    TC.UpdateWAL(p).truncate(9)
    assert JC.UpdateWAL(p).base_version() == 9
    assert TC.UpdateWAL(p).records() == []


@pytest.mark.parametrize("nbytes", [1, 5, 9, 30])
def test_wal_torn_tail_is_dropped(tmp_path, nbytes):
    """A torn last record (a crash mid-append) drops that record only, in
    both readers."""
    p = str(tmp_path / "w.wal")
    wal = TC.UpdateWAL(p, fsync=False)
    for k, (ins, dels) in enumerate(BATCHES):
        wal.append(ins, dels, graph_version=k + 1)
    tear_file_tail(p, nbytes)
    for mod in (TC, JC):
        assert [r["graph_version"] for r in mod.UpdateWAL(p).records()] \
            == [1, 2]
    with open(p, "ab") as f:
        f.write(b"\x99\x00\x00\x00\xde\xad")
    assert len(TC.UpdateWAL(p).records()) == 2


@pytest.mark.parametrize("case", ["gap", "magic", "compacted-past"])
def test_wal_errors_match_reference(tmp_path, case):
    p = str(tmp_path / "w.wal")
    wal = TC.UpdateWAL(p, base_version=2, fsync=False)
    wal.append(*BATCHES[0], graph_version=3)
    if case == "gap":
        wal.append(*BATCHES[1], graph_version=5)
        call, cls = (lambda w: w.records()), WALError
    elif case == "magic":
        with open(p, "r+b") as f:
            f.write(b"XXXXXXXX")
        call, cls = (lambda w: w.records()), WALError
    else:
        call, cls = (lambda w: w.replay(1)), WALReplayError
    with pytest.raises(cls) as e:
        call(TC.UpdateWAL(p))
    with pytest.raises(Exception) as ej:
        call(JC.UpdateWAL(p))
    assert type(ej.value).__name__ == type(e.value).__name__


def _mutations(g, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < 0.5:
            e = int(rng.choice(np.flatnonzero(g.edges_src < g.edges_dst)))
            out.append(([], [(int(g.edges_src[e]), int(g.edges_dst[e]))]))
        else:
            u, v = (int(x) for x in rng.choice(g.num_nodes, 2,
                                               replace=False))
            out.append(([(u, v, float(rng.choice(g.levels)))], []))
    return out


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_warm_start_replays_either_packages_wal(tmp_path, world, writer):
    """A WAL-backed dynamic server of either package logs a schedule of
    updates; a fresh port server warm-started from the v0 checkpoint
    replays that log (written by either package) to the same graph
    version, graph and answers; a replica whose checkpoint predates a
    compacted log is refused."""
    from repro.core.serve import WCSDServer as JServer
    jg, tg, jidx, tidx = world
    ck = TC.save_packed_index(str(tmp_path / "base.wcx"), tidx)
    wal = str(tmp_path / "u.wal")
    if writer == "port":
        live = TServer(tidx, graph=tg, device="cpu", wal_path=wal,
                       wal_fsync=False, compact_threshold=None)
    else:
        live = JServer(jidx, graph=jg, layout="csr", wal_path=wal,
                       wal_fsync=False, compact_threshold=None)
    for ins, dels in _mutations(tg, 4, seed=9):
        live.apply_updates(ins, dels)
    assert live.stats.wal_appends == 4
    base, _ = TC.load_packed_index(ck)
    fresh = TServer(base, graph=tg, device="cpu", wal_path=wal,
                    compact_threshold=None)
    assert fresh.replay_wal() == 4
    assert fresh.graph_version == live.graph_version == 4
    for name in ("indptr", "nbr", "nbr_level"):
        np.testing.assert_array_equal(getattr(fresh.index.graph, name),
                                      getattr(live.index.graph, name))
    D = constrained_distance_grid(fresh.index.graph)
    s, t = np.meshgrid(np.arange(30), np.arange(30), indexing="ij")
    s, t = s.ravel(), t.ravel()
    np.testing.assert_array_equal(fresh.query_profile_many(s, t), D[s, t])
    assert fresh.replay_wal() == 0            # nothing past its version
    live.compact(**({} if writer == "port" else {"use_kernel": False}))
    late = TServer(base, graph=tg, device="cpu", wal_path=wal)
    with pytest.raises(WALReplayError):
        late.replay_wal()
