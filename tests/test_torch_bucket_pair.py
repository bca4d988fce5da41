"""The port's bucket-pair dispatch and its kernels (K7
`wcsd_query_segmented`, K8 `wcsd_profile_segmented`) against the JAX
package, exactly.

`PackedLabels.bucket_tiles` equals the reference's for every bucket;
`plan_query_batch` gives the same sub-batches and positions, and
`stage_sub_batch` the staging arrays of the reference's `_pad_sub_batch`
(without its pad lanes). The plain K7/K8 and their
`ops` wrappers equal the reference Pallas kernels (interpret mode) and
its jnp oracles, on real stores and on a skewed multi-bucket store. The
engine and server with ``dispatch="bucket_pair"`` equal the reference
engine, the port's ragged engine and the BFS grid.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import assert_same_array, port_index
from repro.core.baselines import constrained_distance_grid
from repro.core.generators import erdos_renyi, scale_free
from repro.core.query import DeviceQueryEngine as JEngine
from repro.core.query import _pad_sub_batch as j_pad
from repro.core.query import plan_query_batch as j_plan
from repro.core.serve import WCSDServer as JServer
from repro.core.wc_index import build_wc_index
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels import wcsd_query as j_wq
from repro_torch.core.query import DeviceQueryEngine as TEngine
from repro_torch.core.query import plan_query_batch as t_plan
from repro_torch.core.query import stage_sub_batch as t_stage
from repro_torch.core.serve import WCSDServer as TServer
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import wcsd_segmented as t_seg

W = 3


def _skewed(lane=8, seed=2):
    from benchmarks.bench_wcsd import make_skewed_store
    return make_skewed_store(V=48, W=W, lane=lane, buckets=4,
                             rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def stores():
    g = scale_free(90, m=3, num_levels=W, seed=5)
    idx = build_wc_index(g, ordering="degree")
    pidx, heavy = _skewed()
    return {"real-lane128": (idx, 128, None), "real-lane16": (idx, 16, None),
            "skewed-lane8": (pidx, 8, heavy)}


STORES = ["real-lane128", "real-lane16", "skewed-lane8"]


def _batch(V, n, seed, heavy=None):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, V, n).astype(np.int32)
    t = rng.integers(0, V, n).astype(np.int32)
    wl = rng.integers(0, W + 1, n).astype(np.int32)
    t[:3] = s[:3]
    wl[3:6] = W
    if heavy is not None:
        s[6:9] = np.resize(heavy, 3)
        t[6:9] = np.resize(heavy[::-1], 3)
    return s, t, wl


# ------------------------------------------------------------ host side
@pytest.mark.parametrize("store", STORES)
def test_bucket_tiles_match_reference(stores, store):
    idx, lane, _ = stores[store]
    jp = idx.packed(lane=lane)
    tp = port_index(idx, lane=lane).packed(lane=lane)
    assert tp.num_buckets == jp.num_buckets
    for b in range(jp.num_buckets):
        for name, a, e in zip(("hub", "dist", "wlev"), tp.bucket_tiles(b),
                              jp.bucket_tiles(b)):
            assert_same_array(a, e, f"bucket {b} {name}")


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("num_buckets", [None, "store"])
def test_plan_and_staging_match_reference(stores, store, num_buckets):
    idx, lane, heavy = stores[store]
    jp = idx.packed(lane=lane)
    tp = port_index(idx, lane=lane).packed(lane=lane)
    nb = None if num_buckets is None else jp.num_buckets
    s, t, wl = _batch(idx.num_nodes, 200, 1, heavy)
    jplan = j_plan(jp.bucket_of, s, t, num_buckets=nb)
    tplan = t_plan(tp.bucket_of, s, t, num_buckets=nb)
    assert len(tplan) == len(jplan)
    for a, e in zip(tplan, jplan):
        assert (a.bucket_s, a.bucket_t) == (e.bucket_s, e.bucket_t)
        assert_same_array(a.positions, e.positions)
        n = len(e.positions)
        exp = j_pad(jp.slot_of, W, e.positions, s, t, wl, n)
        assert_same_array(t_stage(tp.slot_of, a.positions, s, t, wl), exp)
        assert_same_array(t_stage(tp.slot_of, a.positions, s, t), exp[:2])
        # the reference's pad lanes come after the sub-batch, untouched
        assert_same_array(j_pad(jp.slot_of, W, e.positions, s, t, wl,
                                n + 5)[:, :n], exp)
    empty = np.array([], np.int32)
    assert t_plan(tp.bucket_of, empty, empty) == []
    assert j_plan(jp.bucket_of, empty, empty) == []


# ------------------------------------------------------------ K7 and K8
def _sub_batches(idx, lane, heavy, seed=3, n=40):
    """Every planned sub-batch of one batch, staged exactly, with the
    bucket tiles it reads."""
    jp = idx.packed(lane=lane)
    s, t, wl = _batch(idx.num_nodes, n, seed, heavy)
    out = []
    for sub in j_plan(jp.bucket_of, s, t):
        stq = j_pad(jp.slot_of, W, sub.positions, s, t, wl,
                    len(sub.positions))
        out.append((jp.bucket_tiles(sub.bucket_s)
                    + jp.bucket_tiles(sub.bucket_t), stq))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("store", STORES)
def test_query_segmented_plain_matches_pallas_and_ref(stores, store):
    """K7 raw best sums on every sub-batch: port plain == Pallas
    (interpret) == jnp oracle (both capped at DEV_INF, as the kernels'
    accumulators are)."""
    idx, lane, heavy = stores[store]
    for tiles, stq in _sub_batches(idx, lane, heavy):
        jt = [jnp.asarray(a) for a in tiles]
        rows = [jnp.asarray(r) for r in stq]
        pallas = np.asarray(j_wq.wcsd_query_segmented(*jt, *rows,
                                                      interpret=True))
        ref = np.minimum(np.asarray(j_ref.wcsd_query_segmented_ref(
            *jt, *rows)), t_seg.DEV_INF)
        plain = t_seg.wcsd_query_segmented_plain(
            *(_t(a) for a in tiles), *(_t(r) for r in stq))
        assert_same_array(pallas, ref)
        assert_same_array(plain.numpy(), pallas)


@pytest.mark.parametrize("store", STORES)
def test_profile_segmented_plain_matches_pallas_and_ref(stores, store):
    idx, lane, heavy = stores[store]
    for tiles, stq in _sub_batches(idx, lane, heavy):
        jt = [jnp.asarray(a) for a in tiles]
        rows = [jnp.asarray(r) for r in stq[:2]]
        pallas = np.asarray(j_wq.wcsd_profile_segmented(
            *jt, *rows, num_levels=W, interpret=True))
        ref = np.minimum(np.asarray(j_ref.wcsd_profile_segmented_ref(
            *jt, *rows, W)), t_seg.DEV_INF)
        plain = t_seg.wcsd_profile_segmented_plain(
            *(_t(a) for a in tiles), *(_t(r) for r in stq[:2]), W)
        assert_same_array(pallas, ref)
        assert_same_array(plain.numpy(), pallas)


def test_plain_caps_at_dev_inf_where_every_pair_meets():
    """A one-cell row pair whose only entries meet at an infeasible
    level: the oracle's raw min is DEV_INF + dt, the kernels' (and the
    plain versions') DEV_INF; every wrapper says INF_DIST."""
    hub = np.array([[7]], np.int32)
    dist = np.array([[3]], np.int32)
    wlev = np.array([[0]], np.int32)
    rows = np.zeros(1, np.int32)
    wq = np.array([1], np.int32)
    tiles = (hub, dist, wlev) * 2
    jt = [jnp.asarray(a) for a in tiles]
    assert int(j_ref.wcsd_query_segmented_ref(
        *jt, *(jnp.asarray(x) for x in (rows, rows, wq)))[0]) > \
        t_seg.DEV_INF
    assert int(j_wq.wcsd_query_segmented(
        *jt, *(jnp.asarray(x) for x in (rows, rows, wq)),
        interpret=True)[0]) == t_seg.DEV_INF
    tt = [_t(a) for a in tiles]
    assert int(t_seg.wcsd_query_segmented_plain(
        *tt, _t(rows), _t(rows), _t(wq))[0]) == t_seg.DEV_INF
    assert int(t_ops.wcsd_query_segmented(*tt, _t(rows), _t(rows),
                                          _t(wq))[0]) == 1 << 30


@pytest.mark.parametrize("store", ["real-lane16", "skewed-lane8"])
def test_ops_segmented_wrappers_match_reference_ops(stores, store):
    """The wrappers: >= DEV_INF -> INF_DIST and the profile suffix min
    equal the reference ops' (fed the same rows through their staging
    arrays)."""
    idx, lane, heavy = stores[store]
    for tiles, stq in _sub_batches(idx, lane, heavy, seed=4):
        jt = [jnp.asarray(a) for a in tiles]
        tt = [_t(a) for a in tiles]
        exp = np.asarray(j_ops.wcsd_query_segmented_staged(
            *jt, jnp.asarray(stq), interpret=True, use_kernel=True))
        assert_same_array(t_ops.wcsd_query_segmented(
            *tt, *(_t(r) for r in stq)).numpy(), exp)
        exp = np.asarray(j_ops.wcsd_profile_segmented_staged(
            *jt, jnp.asarray(stq[:2]), num_levels=W, interpret=True,
            use_kernel=True))
        assert_same_array(t_ops.wcsd_profile_segmented(
            *tt, *(_t(r) for r in stq[:2]), num_levels=W).numpy(), exp)


@pytest.mark.parametrize("store", STORES)
def test_grouped_staging_matches_per_sub_batch(stores, store):
    """A flush staged for the one-launch K7 (`GroupedFlush`: the table of
    sub-batches and the staged [3, B] array, in one upload as the engine
    makes it) gives, through the plain versions, the per-sub-batch
    answers; the table holds each sub-batch's tile pointers, widths and
    offsets, and staging refuses sub-batches that do not cover the
    queries."""
    idx, lane, heavy = stores[store]
    eng = TEngine(port_index(idx, lane=lane), lane=lane,
                  dispatch="bucket_pair", device="cpu")
    s, t, wl = _batch(idx.num_nodes, 80, 7, heavy)
    plan = t_plan(eng._bucket_of, s, t, num_buckets=eng.num_buckets)
    groups = [(eng._tiles[p.bucket_s], eng._tiles[p.bucket_t],
               len(p.positions)) for p in plan]
    pos = np.concatenate([p.positions for p in plan])
    stq = t_stage(eng._slot_of, pos, s, t, wl)
    flush = t_seg.GroupedFlush(groups + [(*groups[0][:2], 0)], stq, "cpu")
    assert len(flush.groups) == len(plan)       # the empty one has no row
    table = flush.table.numpy()
    assert table.shape == (len(plan), t_seg.GROUP_WORDS)
    assert_same_array(table, t_seg.segmented_group_table(groups))
    n = np.array([len(p.positions) for p in plan], np.int32)
    assert_same_array(table[:, 15], n)
    assert_same_array(table[:, 14], (np.cumsum(n) - n).astype(np.int32))
    for row, (ts, tt, _) in zip(table, groups):
        assert list(row.view(np.int64)[:6]) == [x.data_ptr()
                                                for x in (*ts, *tt)]
        assert (row[12], row[13]) == (ts[0].shape[1], tt[0].shape[1])
    assert_same_array(flush.st.numpy(), stq)
    got = t_seg.wcsd_query_segmented_grouped_plain(flush)
    parts = [t_seg.wcsd_query_segmented_plain(
        *ts, *tt, *_t(t_stage(eng._slot_of, p.positions, s, t, wl)))
        for (ts, tt, _), p in zip(groups, plan)]
    assert_same_array(got.numpy(), torch.cat(parts).numpy())
    wrapped = t_ops.wcsd_query_segmented_grouped(flush)
    out = np.empty(len(s), np.int32)
    out[pos] = wrapped.numpy()
    assert_same_array(out, eng.query(s, t, wl))
    with pytest.raises(ValueError, match="cover"):
        t_seg.GroupedFlush(groups[:-1], stq, "cpu")
    with pytest.raises(ValueError, match="cover"):
        t_seg.GroupedFlush(groups, stq[:1], "cpu")


@pytest.mark.parametrize("store", STORES)
def test_grouped_profile_matches_per_sub_batch_and_reference(stores, store):
    """A profile flush staged for the one-launch K8 (`GroupedFlush` over
    a [2, B] array, as the engine stages it): the grouped plain version
    equals the per-sub-batch plain versions and the reference's Pallas
    K8 (interpret) on every sub-batch; the ops wrapper, scattered back
    to batch order, equals the engine's profiles. A [2, B] array that
    does not cover the sub-batches is refused, and K7's grouped version
    refuses a flush staged without levels."""
    idx, lane, heavy = stores[store]
    eng = TEngine(port_index(idx, lane=lane), lane=lane,
                  dispatch="bucket_pair", device="cpu")
    s, t, _ = _batch(idx.num_nodes, 80, 8, heavy)
    plan = t_plan(eng._bucket_of, s, t, num_buckets=eng.num_buckets)
    groups = [(eng._tiles[p.bucket_s], eng._tiles[p.bucket_t],
               len(p.positions)) for p in plan]
    pos = np.concatenate([p.positions for p in plan])
    stq = t_stage(eng._slot_of, pos, s, t)
    assert stq.shape == (2, len(s))
    flush = t_seg.GroupedFlush(groups, stq, "cpu")
    assert_same_array(flush.st.numpy(), stq)
    got = t_seg.wcsd_profile_segmented_grouped_plain(flush, W).numpy()
    assert got.shape == (len(s), W + 1)
    a = 0
    for (ts, tt, n), p in zip(groups, plan):
        rows = t_stage(eng._slot_of, p.positions, s, t)
        plain = t_seg.wcsd_profile_segmented_plain(*ts, *tt, *_t(rows), W)
        pallas = np.asarray(j_wq.wcsd_profile_segmented(
            *(jnp.asarray(x.numpy()) for x in (*ts, *tt)),
            *(jnp.asarray(r) for r in rows), num_levels=W, interpret=True))
        assert_same_array(got[a:a + n], plain.numpy())
        assert_same_array(got[a:a + n], pallas)
        a += n
    wrapped = t_ops.wcsd_profile_segmented_grouped(flush, num_levels=W)
    out = np.empty((len(s), W + 1), np.int32)
    out[pos] = wrapped.numpy()
    assert_same_array(out, eng.query_profile(s, t))
    with pytest.raises(ValueError, match="cover"):
        t_seg.GroupedFlush(groups, stq[:, 1:], "cpu")
    with pytest.raises(ValueError, match="needs 3 rows"):
        t_seg.wcsd_query_segmented_grouped_plain(flush)


# ------------------------------------------------------ engine and server
def _grid(V, Wl):
    s, t, w = np.meshgrid(np.arange(V), np.arange(V), np.arange(Wl + 1),
                          indexing="ij")
    return (s.ravel().astype(np.int32), t.ravel().astype(np.int32),
            w.ravel().astype(np.int32))


@pytest.mark.parametrize("lane", [128, 16, 8])
def test_bucket_pair_engine_matches_reference_and_bfs(lane):
    """Every (s, t, w) and every profile of the graph: bucket-pair ==
    the reference bucket-pair engine (jnp path) == the port's ragged
    engine == the BFS grid."""
    g = erdos_renyi(30, 3.0, num_levels=3, seed=13)
    idx = build_wc_index(g)
    D = constrained_distance_grid(g)
    s, t, wl = _grid(g.num_nodes, g.num_levels)
    tidx = port_index(idx, lane=lane)
    eng = TEngine(tidx, lane=lane, dispatch="bucket_pair", device="cpu")
    if lane == 8:
        assert eng.num_buckets > 1
    got = eng.query(s, t, wl)
    assert_same_array(got, D[s, t, wl])
    ref = JEngine(idx, layout="csr", lane=lane, dispatch="bucket_pair",
                  use_pallas=False)
    assert_same_array(got, np.asarray(ref.query(s, t, wl)))
    rag = TEngine(tidx, lane=lane, device="cpu")
    assert_same_array(got, rag.query(s, t, wl))
    s2, t2 = s[::g.num_levels + 1], t[::g.num_levels + 1]
    prof = eng.query_profile(s2, t2)
    assert_same_array(prof, D[s2, t2, :])
    assert_same_array(prof, np.asarray(ref.query_profile(s2, t2)))


def test_bucket_pair_engine_matches_reference_pallas_on_skew(stores):
    """The skewed multi-bucket store (heavy x heavy pairs included):
    bucket-pair == the reference running the Pallas K7/K8 in interpret
    mode; one handle per flush, answers in batch order."""
    idx, lane, heavy = stores["skewed-lane8"]
    s, t, wl = _batch(idx.num_nodes, 60, 5, heavy)
    ref = JEngine(idx, layout="csr", lane=lane, dispatch="bucket_pair",
                  use_pallas=True, interpret=True)
    eng = TEngine(port_index(idx, lane=lane), lane=lane,
                  dispatch="bucket_pair", device="cpu")
    assert len(t_plan(eng._bucket_of, s, t)) > 4
    h = eng.query_async(s, t, wl)
    assert h.ready()
    assert_same_array(h.wait(), np.asarray(ref.query(s, t, wl)))
    assert h.wait() is h.wait()
    assert_same_array(eng.query_profile(s, t),
                      np.asarray(ref.query_profile(s, t)))
    empty = np.array([], np.int32)
    assert eng.query(empty, empty, empty).shape == (0,)
    assert eng.query_profile(empty, empty).shape == (0, W + 1)


@pytest.mark.parametrize("dispatch,compressed", [("bucket_pair", False),
                                                 ("ragged", True)])
def test_server_sequence_matches_reference(dispatch, compressed):
    """A seeded request stream through `WCSDServer` in each new mode
    (epoch flushes, duplicates, profiles): every answer equals the
    reference server's in the same mode and the BFS grid."""
    g = erdos_renyi(40, 3.0, num_levels=3, seed=21)
    idx = build_wc_index(g, ordering="degree")
    D = constrained_distance_grid(g)
    kw = dict(max_batch=16, dispatch=dispatch, compressed=compressed)
    ref = JServer(idx, layout="csr", use_pallas=False, **kw)
    srv = TServer(port_index(idx), device="cpu", **kw)
    assert srv.engine.compressed is compressed
    rng = np.random.default_rng(0)
    s = rng.integers(0, 40, 150)
    t = rng.integers(0, 40, 150)
    wl = rng.integers(0, W + 1, 150)
    s[100:120], t[100:120] = t[:20], s[:20]       # duplicates, flipped
    got = srv.query_many(s, t, wl)
    assert_same_array(got, np.asarray(ref.query_many(s, t, wl)))
    assert_same_array(got, D[s, t, wl])
    prof = srv.query_profile_many(s[:50], t[:50])
    assert_same_array(prof, np.asarray(ref.query_profile_many(s[:50],
                                                              t[:50])))
    assert_same_array(prof, D[s[:50], t[:50], :])
    assert srv.stats.batches == ref.stats.batches
    assert srv.stats.memo_hits == ref.stats.memo_hits
