"""The port's host layer for the dynamic index against the reference
package, on the CPU: `mutate_edges` and the rest of `Graph`, the oracles
of `core/ref.py`, `pareto_filter`, the sequential `build_wc_index`, the
host-orchestrated `build_wc_index_batched` and `clean_index`, the
baselines, `affected_vertices` / `rebuild_affected_rows`, the
`DeltaLabelStore` (rows, `merged_flat`, `extend_arena`), the dynamic
server in every serving mode against the reference's `DynamicWCIndex`
and the BFS grid, `compact()` against a fresh build and the reference's
compaction, and the chaos schedule. The bar is exact equality throughout.
"""
import numpy as np
import pytest

from _torch_parity import (ARENA_FIELDS, GRAPH_FIELDS, PACKED_FIELDS,
                           assert_same_array, assert_same_fields,
                           port_graph)
from repro.core import baselines as JB
from repro.core import ref as JR
from repro.core.dominance import pareto_filter as j_pareto_filter
from repro.core.generators import erdos_renyi, road_grid, scale_free
from repro.core.graph import mutate_edges as j_mutate
from repro.core.serve import WCSDServer as JServer
from repro.core.wc_index import DynamicWCIndex as JDynamic
from repro.core.wc_index import build_wc_index as j_build
from repro.core.wc_index_batched import affected_vertices as j_affected
from repro.core.wc_index_batched import \
    build_wc_index_batched as j_build_batched
from repro.core.wc_index_batched import \
    build_wc_index_batched_packed as j_build_packed
from repro.core.wc_index_batched import clean_index as j_clean
from repro.core.wc_index_batched import \
    rebuild_affected_rows as j_rebuild_rows
from repro_torch.core import baselines as TB
from repro_torch.core import ref as TR
from repro_torch.core.dominance import pareto_filter as t_pareto_filter
from repro_torch.core.graph import Graph as TGraph
from repro_torch.core.graph import mutate_edges as t_mutate
from repro_torch.core.resilience import UnknownRequestError
from repro_torch.core.serve import WCSDServer as TServer
from repro_torch.core.wc_index import DynamicWCIndex as TDynamic
from repro_torch.core.wc_index import (as_packed_index,
                                       delta_store_from_arrays,
                                       index_from_arrays)
from repro_torch.core.wc_index import build_wc_index as t_build
from repro_torch.core.wc_index_batched import affected_vertices as t_affected
from repro_torch.core.wc_index_batched import \
    build_wc_index_batched as t_build_batched
from repro_torch.core.wc_index_batched import \
    build_wc_index_batched_packed as t_build_packed
from repro_torch.core.wc_index_batched import clean_index as t_clean
from repro_torch.core.wc_index_batched import \
    rebuild_affected_rows as t_rebuild_rows

INDEX_FIELDS = ("order", "rank", "levels", "hub_rank", "dist", "wlev",
                "count")
BUILD_KW = dict(ordering="degree", batch_size=16)

GRAPHS = {
    "er36": lambda: erdos_renyi(36, 3.0, num_levels=4, seed=3),
    "er64": lambda: erdos_renyi(64, 4.0, num_levels=3, seed=11),
    "sf300": lambda: scale_free(300, 4, num_levels=5, seed=0),
    "road": lambda: road_grid(8, 9, num_levels=4, seed=2),
}


def _index_arrays(idx) -> dict:
    return {n: getattr(idx, n) for n in INDEX_FIELDS}


def _random_mutation(rng, g):
    """One randomized update batch of 1-2 inserts / deletes over ``g``."""
    inserts, deletes = [], []
    for _ in range(int(rng.integers(1, 3))):
        half = np.flatnonzero(g.edges_src < g.edges_dst)
        if rng.random() < 0.45 and len(half):
            e = int(rng.choice(half))
            deletes.append((int(g.edges_src[e]), int(g.edges_dst[e])))
        else:
            u, v = (int(x) for x in rng.choice(g.num_nodes, 2, replace=False))
            inserts.append((u, v, float(rng.choice(g.levels))))
    return inserts, deletes


def _full_grid(V, W):
    s, t, w = np.meshgrid(np.arange(V), np.arange(V), np.arange(W + 1),
                          indexing="ij")
    return (s.ravel().astype(np.int32), t.ravel().astype(np.int32),
            w.ravel().astype(np.int32))


# ------------------------------------------------------------------ graph
@pytest.mark.parametrize("seed", range(6))
def test_mutate_edges_schedule_matches_reference(seed):
    """A seeded schedule of upserts, orientation-swapped deletes and
    mixed batches gives the same graph, field for field, version
    included."""
    rng = np.random.default_rng(seed)
    jg = erdos_renyi(int(rng.integers(12, 40)), 3.0,
                     num_levels=int(rng.integers(2, 5)), seed=seed)
    tg = port_graph(jg)
    for _ in range(5):
        ins, dels = _random_mutation(rng, jg)
        if dels and rng.random() < 0.5:
            dels = [(b, a) for a, b in dels]
        jg, tg = j_mutate(jg, ins, dels), t_mutate(tg, ins, dels)
        assert_same_fields(tg, jg, GRAPH_FIELDS)
        assert tg.version == jg.version and tg.num_nodes == jg.num_nodes


@pytest.mark.parametrize("case,match", [
    ("self-loop", "self loop"),
    ("new-quality", "not in the graph's level table"),
])
def test_mutate_edges_errors_match_reference(case, match):
    jg = erdos_renyi(12, 3.0, num_levels=3, seed=7)
    tg = port_graph(jg)
    ins = ([(3, 3, float(jg.levels[0]))] if case == "self-loop"
           else [(0, 1, 123.456)])
    for mut, g in ((j_mutate, jg), (t_mutate, tg)):
        with pytest.raises(ValueError, match=match):
            mut(g, inserts=ins)


def test_mutate_edges_keeps_the_level_table():
    """Deleting every edge of one quality keeps the global level table
    (and the level indices) in both packages."""
    jg = erdos_renyi(20, 3.0, num_levels=3, seed=1)
    half = np.flatnonzero((jg.edges_src < jg.edges_dst)
                          & (jg.edges_level == 0))
    dels = [(int(jg.edges_src[e]), int(jg.edges_dst[e])) for e in half]
    jg2, tg2 = j_mutate(jg, deletes=dels), t_mutate(port_graph(jg),
                                                    deletes=dels)
    assert_same_fields(tg2, jg2, GRAPH_FIELDS)
    assert len(tg2.levels) == 3 and not (tg2.edges_level == 0).any()


@pytest.mark.parametrize("name", ["er36", "road"])
def test_graph_methods_match_reference(name):
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    for w in (-1.0, 0.5, float(jg.levels[1]), 1e9):
        assert tg.level_of(w) == jg.level_of(w)
    for u in (0, 5, jg.num_nodes - 1):
        for a, b in zip(tg.neighbors(u), jg.neighbors(u)):
            assert_same_array(a, b)
    for lev in range(jg.num_levels + 1):
        assert_same_fields(tg.filtered(lev), jg.filtered(lev), GRAPH_FIELDS)
    assert tg.memory_bytes() == jg.memory_bytes()


@pytest.mark.parametrize("name", ["er36", "road"])
def test_ref_oracles_match_reference(name):
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    for s in (0, 7, jg.num_nodes - 1):
        assert_same_array(TR.pareto_dists(tg, s), JR.pareto_dists(jg, s))
        for w in range(jg.num_levels + 1):
            assert_same_array(TR.wcsd_all_dists(tg, s, w),
                              JR.wcsd_all_dists(jg, s, w))
            assert_same_array(TR.wcsd_all_dists(tg, s, w),
                              TR.wcsd_bfs_all(tg, s, w))


def test_pareto_filter_matches_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 200):
        d = rng.integers(0, 6, n)
        w = rng.integers(0, 4, n)
        assert_same_array(t_pareto_filter(d, w), j_pareto_filter(d, w))


# --------------------------------------------------------------- builders
@pytest.mark.parametrize("kw", [dict(), dict(ordering="hybrid"),
                                dict(prune=False), dict(max_roots=10)])
@pytest.mark.parametrize("name", ["er36", "sf300"])
def test_build_wc_index_byte_identical(name, kw):
    jg = GRAPHS[name]()
    j = j_build(jg, **kw)
    t = t_build(port_graph(jg), **kw)
    assert_same_fields(t, j, INDEX_FIELDS)
    assert t.size_entries() == j.size_entries()
    assert t.memory_bytes() == j.memory_bytes()
    assert_same_array(t.labels_of(3), j.labels_of(3))
    # the packed view and its padded round trip, as the reference's
    assert_same_fields(t.packed(), j.packed(), PACKED_FIELDS)
    tp, jp = as_packed_index(t), as_packed_index(j)
    assert_same_fields(tp.to_index(), jp.to_index(), INDEX_FIELDS)
    assert tp.checksums() == jp.checksums()
    assert tp.packed().tile_memory_bytes() == jp.packed().tile_memory_bytes()
    for cap in (None, 3):
        for a, b in zip(t.padded_device_arrays(cap),
                        j.padded_device_arrays(cap)):
            assert_same_array(a, b)


@pytest.mark.parametrize("name", ["er36", "er64"])
def test_query_paths_match_reference_and_grid(name):
    """`WCIndex` / `PackedWCIndex` host queries (`query_one`,
    `query_batch`) equal the reference's and the BFS grid over every
    (s, t, w)."""
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    t = t_build(tg)
    tp = as_packed_index(t)
    D = TB.constrained_distance_grid(tg)
    s, tt, w = _full_grid(jg.num_nodes, jg.num_levels)
    np.testing.assert_array_equal(t.query_batch(s, tt, w), D[s, tt, w])
    np.testing.assert_array_equal(tp.query_batch(s, tt, w), D[s, tt, w])
    sub = np.random.default_rng(1).choice(len(s), 300, replace=False)
    for i in sub:
        exp = int(D[s[i], tt[i], w[i]])
        assert t.query_one(s[i], tt[i], w[i]) == exp
        assert tp.query_one(s[i], tt[i], w[i]) == exp
    assert tp.level_of(float(jg.levels[1])) == 1


@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("name", ["er64", "sf300", "road"])
def test_build_batched_and_clean_match_reference(name, B):
    """The host-orchestrated rank-batched build (rounds as torch ops on
    the CPU): equal stats (``rounds``, ``raw_entries``, sync counts,
    ``dominated_removed``) and the same padded index; `clean_index` on it
    removes the same entries."""
    jg = GRAPHS[name]()
    j, js = j_build_batched(jg, batch_size=B)
    t, ts = t_build_batched(port_graph(jg), batch_size=B, device="cpu")
    assert ts == js
    assert_same_fields(t, j, INDEX_FIELDS)
    jc, jr = j_clean(j)
    tc, tr = t_clean(t)
    assert tr == jr
    assert_same_fields(tc, jc, INDEX_FIELDS)


def test_clean_index_restores_sequential_minimality():
    jg = GRAPHS["sf300"]()
    tg = port_graph(jg)
    t, _ = t_build_batched(tg, batch_size=64, device="cpu")
    tc, removed = t_clean(t)
    seq = t_build(tg)
    assert removed >= 0 and tc.size_entries() <= t.size_entries()
    assert tc.size_entries() == seq.size_entries()


# -------------------------------------------------------------- baselines
@pytest.mark.parametrize("name", ["er36", "road"])
def test_constrained_distance_grid_matches_reference(name):
    jg = GRAPHS[name]()
    assert_same_array(TB.constrained_distance_grid(port_graph(jg)),
                      JB.constrained_distance_grid(jg))


@pytest.mark.parametrize("name", ["er36", "road"])
def test_baselines_match_reference(name):
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    D = TB.constrained_distance_grid(tg)
    jw, tw = JB.WBFS.build(jg), TB.WBFS.build(tg)
    jn, tn = JB.NaiveIndex.build(jg), TB.NaiveIndex.build(tg)
    jl, tl = JB.LCRAdapt.build(jg), TB.LCRAdapt.build(tg)
    assert tw.memory_bytes() == jw.memory_bytes()
    assert (tn.size_entries(), tn.memory_bytes()) == \
        (jn.size_entries(), jn.memory_bytes())
    assert tl.memory_bytes() == jl.memory_bytes()
    rng = np.random.default_rng(5)
    V, W = jg.num_nodes, jg.num_levels
    s = rng.integers(0, V, 60)
    t = rng.integers(0, V, 60)
    w = rng.integers(0, W + 1, 60)
    for a, b, c in zip(s.tolist(), t.tolist(), w.tolist()):
        exp = int(D[a, b, c])
        got = (TB.cbfs_query(tg, a, b, c), tw.query(a, b, c),
               TB.dijkstra_query(tg, a, b, c), tn.query(a, b, c),
               tl.query(a, b, c))
        ref = (JB.cbfs_query(jg, a, b, c), jw.query(a, b, c),
               JB.dijkstra_query(jg, a, b, c), jn.query(a, b, c),
               jl.query(a, b, c))
        assert got == ref
        assert all(int(x) == exp for x in got), (a, b, c, got, exp)
    assert_same_array(tn.query_batch(s, t, w), jn.query_batch(s, t, w))


# ------------------------------------------------- incremental maintenance
def test_affected_vertices_is_component_closure():
    u = np.array([0, 1, 3], dtype=np.int32)
    v = np.array([1, 2, 4], dtype=np.int32)
    g = TGraph.from_edges(5, u, v, np.ones(3))
    assert set(t_affected(g, t_mutate(g, deletes=[(0, 1)]),
                          [0, 1]).tolist()) == {0, 1, 2}
    assert set(t_affected(g, t_mutate(g, inserts=[(2, 3, 1.0)]),
                          [2, 3]).tolist()) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("seed", range(4))
def test_affected_and_rebuilt_rows_match_reference(seed):
    """`affected_vertices` and `rebuild_affected_rows` give the same
    vertex sets and replacement rows as the reference, on a graph of
    several components (so the closure is not the whole graph)."""
    rng = np.random.default_rng(seed)
    jg = erdos_renyi(48, 1.6, num_levels=3, seed=seed + 40)
    tg = port_graph(jg)
    idx = j_build(jg)
    tidx = t_build(tg)
    ins, dels = _random_mutation(rng, jg)
    jg2, tg2 = j_mutate(jg, ins, dels), t_mutate(tg, ins, dels)
    ends = sorted({x for e in ins for x in e[:2]}
                  | {x for e in dels for x in e[:2]})
    ja, ta = j_affected(jg, jg2, ends), t_affected(tg, tg2, ends)
    assert_same_array(ta, ja)
    assert len(ja) < jg.num_nodes or seed > 0
    jp, tp = idx.packed(), tidx.packed()
    flat = lambda p: (p.hub_rank, p.dist, p.wlev, p.offsets)  # noqa: E731
    jr = j_rebuild_rows(jg2, idx.order, idx.rank, jg.num_levels, flat(jp),
                        ja)
    tr = t_rebuild_rows(tg2, tidx.order, tidx.rank, tg.num_levels, flat(tp),
                        ta)
    assert sorted(tr) == sorted(jr)
    for v in jr:
        for a, b in zip(tr[v], jr[v]):
            assert_same_array(a, b)


def _delta_arrays(delta) -> dict:
    return {"graph_version": delta.graph_version, "rows": delta.rows,
            "tombstoned": delta.tombstoned,
            "corrections": delta.corrections}


def _assert_same_delta(td, jd):
    assert sorted(td.rows) == sorted(jd.rows)
    for v in jd.rows:
        for a, b in zip(td.rows[v], jd.rows[v]):
            assert_same_array(a, b)
    assert (td.graph_version, td.tombstoned, td.corrections) == \
        (jd.graph_version, jd.tombstoned, jd.corrections)


@pytest.mark.parametrize("seed", range(4))
def test_delta_store_tracks_reference_through_a_schedule(seed):
    """After each update of a seeded schedule: the delta's rows and
    counters, `merged_flat`, `extend_arena` (the arena the ragged engine
    reads), the merged store's routing tables and every
    `apply_updates` stat equal the reference's `DynamicWCIndex`."""
    rng = np.random.default_rng(seed)
    jg = erdos_renyi(int(rng.integers(20, 40)), 3.0, num_levels=3,
                     seed=seed + 100)
    base = j_build_packed(jg, use_kernel=False, **BUILD_KW)[0]
    jd = JDynamic(base, jg)
    td = TDynamic(t_build_packed(port_graph(jg), device="cpu",
                                 **BUILD_KW)[0], port_graph(jg))
    for _ in range(4):
        ins, dels = _random_mutation(rng, jd.graph)
        assert td.apply_updates(ins, dels) == jd.apply_updates(ins, dels)
        _assert_same_delta(td.delta, jd.delta)
        for a, b in zip(td.delta.merged_flat(td.base.labels),
                        jd.delta.merged_flat(jd.base.labels)):
            assert_same_array(a, b)
        assert_same_fields(td.packed(), jd.packed(), PACKED_FIELDS)
        assert_same_fields(td.packed().arena(), jd.packed().arena(),
                           ARENA_FIELDS)
        for lane in (8, 128):
            assert_same_fields(
                td.delta.extend_arena(td.base.labels.arena(lane=lane)),
                jd.delta.extend_arena(jd.base.labels.arena(lane=lane)),
                ARENA_FIELDS)
        assert td.delta_ratio() == jd.delta_ratio()
        assert td.size_entries() == jd.size_entries()
        # the reference's delta carried across answers as the port's
        carried = delta_store_from_arrays(_delta_arrays(jd.delta))
        _assert_same_delta(carried, jd.delta)


def test_index_carried_across_from_arrays():
    """A reference `WCIndex` crosses over to a port `WCIndex` (and its
    packed form) through numpy arrays."""
    jg = GRAPHS["er36"]()
    j = j_build(jg)
    t = index_from_arrays(_index_arrays(j))
    assert_same_fields(t, j, INDEX_FIELDS)
    assert_same_fields(t.packed(), j.packed(), PACKED_FIELDS)


# ------------------------------------------------------ dynamic serving
SERVER_MODES = {
    "ragged": dict(),
    "compressed": dict(compressed=True),
    "bucket_pair": dict(dispatch="bucket_pair"),
    "padded": dict(layout="padded"),
}


@pytest.mark.parametrize("mode", sorted(SERVER_MODES))
@pytest.mark.parametrize("seed", range(2))
def test_dynamic_server_exact_through_updates(seed, mode):
    """The port's dynamic server (plain path) in every serving mode,
    after each update of a seeded schedule: every (s, t, w) answer and
    every profile equals the BFS grid of the mutated graph and the
    reference `DynamicWCIndex`'s answers; the engine reads the
    delta-extended arena of the reference's dynamic index."""
    rng = np.random.default_rng(seed + 7)
    jg = erdos_renyi(int(rng.integers(10, 16)), 3.0, num_levels=3,
                     seed=seed + 20)
    tg = port_graph(jg)
    jd = JDynamic(j_build(jg), jg)
    srv = TServer(t_build(tg), graph=tg, device="cpu", max_batch=4096,
                  compact_threshold=None, **SERVER_MODES[mode])
    V, W = jg.num_nodes, jg.num_levels
    s, t, w = _full_grid(V, W)
    for step in range(3):
        ins, dels = _random_mutation(rng, jd.graph)
        jd.apply_updates(ins, dels)
        srv.apply_updates(ins, dels)
        assert srv.graph_version == jd.graph_version == step + 1
        D = JB.constrained_distance_grid(jd.graph)
        got = srv.query_many(s, t, w)
        np.testing.assert_array_equal(got, D[s, t, w])
        np.testing.assert_array_equal(got, jd.query_batch(s, t, w))
        ps, pt = _full_grid(V, 0)[:2]
        np.testing.assert_array_equal(srv.query_profile_many(ps, pt),
                                      D[ps, pt, :])
        if mode == "ragged":
            assert_same_fields(srv.engine.arena, jd.packed().arena(),
                               ARENA_FIELDS)
            delta_tiles = (srv.engine.arena.num_tiles
                           - srv.index.base.labels.arena().num_tiles)
            assert (delta_tiles > 0) == (not srv.index.delta.is_empty())
        if mode == "compressed":
            assert srv.engine.compressed


def test_server_stamps_and_stale_flags_match_reference():
    """Versions and stale flags of queued, in-flight, memo and fresh
    answers across updates equal the reference server's, answer for
    answer."""
    jg = erdos_renyi(24, 3.0, num_levels=3, seed=11)
    tg = port_graph(jg)
    jidx = j_build_packed(jg, use_kernel=False, **BUILD_KW)[0]
    tidx = t_build_packed(tg, device="cpu", **BUILD_KW)[0]
    jsrv = JServer(jidx, graph=jg, max_batch=4, compact_threshold=None,
                   compact_kwargs=dict(use_kernel=False, **BUILD_KW))
    tsrv = TServer(tidx, graph=tg, device="cpu", max_batch=4,
                   compact_threshold=None, compact_kwargs=BUILD_KW)
    rng = np.random.default_rng(2)
    rids = []
    for step in range(60):
        op = rng.random()
        if op < 0.45:
            a, b, c = (int(x) for x in (rng.integers(24), rng.integers(24),
                                        rng.integers(4)))
            rids.append(("q", jsrv.submit(a, b, c), tsrv.submit(a, b, c)))
        elif op < 0.6:
            a, b = int(rng.integers(24)), int(rng.integers(24))
            rids.append(("p", jsrv.submit_profile(a, b),
                         tsrv.submit_profile(a, b)))
        elif op < 0.75 and rids:
            kind, jr, tr = rids.pop(int(rng.integers(len(rids))))
            if kind == "q":
                assert tsrv.result_full(tr)[:2] == jsrv.result_full(jr)[:2]
            else:
                ja, jv, _ = jsrv.profile_result_full(jr)
                ta, tv, _ = tsrv.profile_result_full(tr)
                assert tv == jv
                np.testing.assert_array_equal(ta, ja)
        elif op < 0.85:
            ins, dels = _random_mutation(rng, jsrv.index.graph)
            assert (tsrv.apply_updates(ins, dels)
                    == jsrv.apply_updates(ins, dels))
        elif op < 0.9:
            tsrv.compact()
            jsrv.compact()
            assert_same_fields(tsrv.index.base.labels,
                               jsrv.index.base.labels, PACKED_FIELDS)
        else:
            tsrv.poll()
            jsrv.poll()
    for kind, jr, tr in rids:
        if kind == "q":
            assert tsrv.result_with_staleness(tr) == \
                jsrv.result_with_staleness(jr)
        else:
            ja, js = jsrv.profile_result_with_staleness(jr)
            ta, ts = tsrv.profile_result_with_staleness(tr)
            assert ts == js
            np.testing.assert_array_equal(ta, ja)
    assert tsrv.graph_version == jsrv.graph_version > 0
    assert tsrv.stats.memo_hits == jsrv.stats.memo_hits


def test_server_staleness_flags():
    """A request queued before an update reads back stale; a fresh one
    and a memo hit after it do not; the memo holds the new answers."""
    jg = erdos_renyi(24, 3.0, num_levels=3, seed=11)
    tg = port_graph(jg)
    srv = TServer(t_build(tg), graph=tg, device="cpu", max_batch=512,
                  compact_threshold=None)
    r_old = srv.submit(0, 5, 1)
    p_old = srv.submit_profile(1, 6)
    srv.apply_updates(inserts=[(0, 5, float(tg.levels[0]))])
    assert srv.graph_version == 1
    assert srv.result_with_staleness(r_old)[1] is True
    assert srv.profile_result_with_staleness(p_old)[1] is True
    D = TB.constrained_distance_grid(srv.index.graph)
    val, stale = srv.result_with_staleness(srv.submit(0, 5, 0))
    assert (val, stale) == (int(D[0, 5, 0]), False)
    assert srv.result_with_staleness(srv.submit(0, 5, 0)) == (val, False)
    assert srv.result_full(srv.submit(5, 0, 0))[1] == 1
    with pytest.raises(UnknownRequestError):
        srv.result_with_staleness(10_000)


def test_static_server_refuses_updates():
    jg = erdos_renyi(10, 3.0, num_levels=2, seed=0)
    tg = port_graph(jg)
    idx = t_build(tg)
    srv = TServer(idx, device="cpu")
    assert srv.graph_version == 0
    for call in (lambda: srv.apply_updates(
                     inserts=[(0, 1, float(tg.levels[0]))]),
                 srv.compact, srv.replay_wal):
        with pytest.raises(ValueError):
            call()
    from repro_torch.core.query import DeviceQueryEngine
    eng = DeviceQueryEngine(as_packed_index(idx), device="cpu")
    with pytest.raises(ValueError, match="injected engine"):
        TServer(engine=eng, graph=tg)
    with pytest.raises(TypeError):
        TServer(idx, graph=tg, device="cpu",
                compact_kwargs=dict(use_kernel=False)).compact()


# ------------------------------------------------------------- compaction
@pytest.mark.parametrize("seed", range(4))
def test_compact_byte_identical_to_fresh_build_and_reference(seed):
    """`compact()` (the device builder, on the CPU here) leaves a base
    byte-identical to a fresh build on the mutated graph and to the
    reference's compaction; the auto trigger compacts on the first
    update with a tiny threshold."""
    rng = np.random.default_rng(seed)
    jg = erdos_renyi(int(rng.integers(10, 30)), 3.0, num_levels=3,
                     seed=seed + 13)
    tg = port_graph(jg)
    jd = JDynamic(j_build_packed(jg, use_kernel=False, **BUILD_KW)[0], jg)
    td = TDynamic(t_build_packed(tg, device="cpu", **BUILD_KW)[0], tg)
    for _ in range(int(rng.integers(1, 4))):
        ins, dels = _random_mutation(rng, jd.graph)
        jd.apply_updates(ins, dels)
        td.apply_updates(ins, dels)
    ts = td.compact(device="cpu", **BUILD_KW)
    js = jd.compact(use_kernel=False, **BUILD_KW)
    fresh, fs = t_build_packed(td.graph, device="cpu", **BUILD_KW)
    for field in ("order", "rank", "levels"):
        assert_same_array(getattr(td.base, field), getattr(fresh, field))
        assert_same_array(getattr(td.base, field), getattr(jd.base, field))
    assert_same_fields(td.base.labels, fresh.labels, PACKED_FIELDS)
    assert_same_fields(td.base.labels, jd.base.labels, PACKED_FIELDS)
    assert {k: ts[k] for k in ("rounds", "raw_entries", "entries")} == \
        {k: js[k] for k in ("rounds", "raw_entries", "entries")}
    assert td.delta.is_empty() and td.delta_ratio() == 0.0
    assert td.graph_version == jd.graph_version
    srv = TServer(td.base, graph=td.graph, device="cpu",
                  compact_threshold=1e-9, compact_kwargs=BUILD_KW)
    ins, dels = _random_mutation(rng, td.graph)
    assert srv.apply_updates(ins, dels)["compacted"] is True
    assert srv.index.delta.is_empty()


# ------------------------------------------------------------------ chaos
@pytest.fixture(scope="module")
def reference_chaos(tmp_path_factory):
    from repro.checkpoint.fault import run_chaos_schedule
    return run_chaos_schedule(steps=200, seed=3, crash_step=100,
                              workdir=str(tmp_path_factory.mktemp("jchaos")))


SCHEDULE_KEYS = ("submitted", "answered", "updates", "crashes",
                 "integrity_probes", "wal_probes", "replayed_records",
                 "graph_version", "final_mode", "injected", "wal_appends")
# counts that follow the wall clock: the 50 ms flush deadline decides
# whether an injected hang, or a slow flush, is a timeout retry
CLOCK_KEYS = ("timeout_retries", "error_retries", "exhausted", "demotions",
              "promotions")


def test_chaos_schedule_matches_reference(reference_chaos, tmp_path):
    """The reference's acceptance schedule (200 steps, seed 3, a crash
    and WAL-replay warm restart at step 100) through the port on the
    CPU: every answer equals the BFS oracle at its stamped version, none
    is lost or delivered twice (the harness raises otherwise), and the
    schedule-driven counts equal the reference's. The retry counters
    depend on wall-clock timeouts and are held to what the schedule
    forces, not to the reference's values."""
    from repro_torch.checkpoint.fault import run_chaos_schedule
    got = run_chaos_schedule(dict(device="cpu"), steps=200, seed=3,
                             crash_step=100, workdir=str(tmp_path))
    assert {k: got[k] for k in SCHEDULE_KEYS} == \
        {k: reference_chaos[k] for k in SCHEDULE_KEYS}
    assert got["final_mode"] == "primary" and got["crashes"] == 1
    assert got["answered"] == got["submitted"]
    # the fixed draws 6-9 force one exhausted budget and one demotion
    assert got["exhausted"] >= 1 and got["demotions"] >= 1
    assert got["promotions"] == got["demotions"]
    assert set(CLOCK_KEYS) <= set(got)
