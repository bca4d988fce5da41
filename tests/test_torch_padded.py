"""The port's padded layout (K9 `wcsd_query_gathered`) and single-root
relaxation (K10 `frontier_relax_gathered`) against the JAX package,
exactly.

The padded ``[V, cap]`` arrays equal the reference's with and without a
trimming ``cap`` (trimmed rows still answer ``s == t``); the plain padded
joins equal their ``_jnp`` counterparts, and chunked equals unchunked;
the padded engine equals the reference engine with both ``use_pallas``
settings (Pallas in interpret mode), the port's ragged engine and the BFS
grid; ``ops.wcsd_query`` and ``ops.frontier_relax`` equal the reference
`ops` functions (kernel and jnp paths) on the reference tests' random
shapes, and one K10 round equals a constrained-BFS round.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import assert_same_array, port_graph, port_index
from repro.core import query as j_query
from repro.core.baselines import constrained_distance_grid
from repro.core.generators import erdos_renyi, random_queries, scale_free
from repro.core.query import DeviceQueryEngine as JEngine
from repro.core.wc_index import PackedWCIndex as JPackedIndex
from repro.core.wc_index import build_wc_index
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels import wcsd_query as j_wq
from repro_torch.core import query as t_query
from repro_torch.core.query import DeviceQueryEngine as TEngine
from repro_torch.core.ref import wcsd_bfs, wcsd_bfs_all
from repro_torch.kernels import _cuda
from repro_torch.kernels import frontier as t_fr
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import wcsd_query as t_wq

DEV_INF = 1 << 29


@pytest.fixture(scope="module")
def world():
    g = scale_free(120, 3, num_levels=4, seed=5)
    idx = build_wc_index(g, ordering="degree")
    jidx = JPackedIndex(order=idx.order, rank=idx.rank, levels=idx.levels,
                        labels=idx.packed())
    return g, idx, jidx, port_index(idx), constrained_distance_grid(g)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


def _longest(jidx) -> int:
    off = jidx.labels.offsets
    return int((off[1:] - off[:-1]).max())


@pytest.mark.parametrize("cap", [None, "trim", "wide"])
def test_padded_arrays_match_reference(world, cap):
    g, _, jidx, tidx, _ = world
    longest = _longest(jidx)
    c = {None: None, "trim": max(2, longest // 3), "wide": longest + 9}[cap]
    got = tidx.padded_device_arrays(c)
    exp = jidx.padded_device_arrays(c)
    for name, a, b in zip(("hub", "dist", "wlev", "count"), got, exp):
        assert_same_array(a, b, name)
    if cap == "trim":
        assert (exp[3] == c).any() and got[0].shape[1] == c
        # the trimmed rows keep their self entry: s == t answers 0
        eng = TEngine(tidx, layout="padded", cap=c, device="cpu")
        v = np.arange(g.num_nodes, dtype=np.int32)
        for w in range(g.num_levels + 1):
            assert (eng.query(v, v, np.full_like(v, w)) == 0).all()


def _queries(g, n, seed):
    s, t, wl = random_queries(g, n, seed=seed)
    rng = np.random.default_rng(seed)
    wl = rng.integers(0, g.num_levels + 2, n).astype(np.int32)
    return s.astype(np.int32), t.astype(np.int32), wl


@pytest.mark.parametrize("lane_pad", [False, True])
def test_plain_padded_joins_match_jnp(world, lane_pad):
    g, _, jidx, tidx, _ = world
    store = t_query._build_padded_store(tidx, None, lane_pad)
    jstore = j_query._build_padded_store(jidx, None, lane_pad)
    for a, b in zip(store, jstore):
        assert_same_array(a, b)
    s, t, wl = _queries(g, 150, seed=3)
    W = g.num_levels
    ts, js = _t(*store), _j(*store)
    got = t_query.query_batch_torch(*ts, *_t(s, t, wl))
    assert_same_array(got.numpy(), np.asarray(
        j_query.query_batch_jnp(*js, *_j(s, t, wl))))
    got = t_query.query_batch_sorted_torch(*ts, *_t(s, t, wl))
    assert_same_array(got.numpy(), np.asarray(
        j_query.query_batch_sorted_jnp(*js, *_j(s, t, wl))))
    got = t_query.profile_batch_torch(*ts, *_t(s, t), num_levels=W)
    assert_same_array(got.numpy(), np.asarray(
        j_query.profile_batch_jnp(*js, *_j(s, t), num_levels=W)))


def test_plain_padded_joins_chunked_equal_unchunked(world):
    g, _, _, tidx, _ = world
    store = _t(*tidx.padded_device_arrays(None))
    L = store[0].shape[1]
    s, t, wl = _t(*_queries(g, 97, seed=8))
    small = 3 * 4 * L * L                    # three queries per chunk
    assert t_query.padded_chunk_rows(L, small) == 3
    assert t_query.padded_chunk_rows(L) >= 97
    W = g.num_levels
    for fn, args, kw in (
            (t_query.query_batch_torch, (s, t, wl), {}),
            (t_query.query_batch_sorted_torch, (s, t, wl), {}),
            (t_query.profile_batch_torch, (s, t), {"num_levels": W})):
        a = fn(*store, *args, **kw)
        b = fn(*store, *args, chunk_bytes=small, **kw)
        c = fn(*store, *args, chunk_bytes=1, **kw)     # one query a chunk
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_padded_engine_matches_reference_ragged_and_grid(world, use_pallas):
    g, _, jidx, tidx, D = world
    W = g.num_levels
    eng = TEngine(tidx, layout="padded", use_pallas=use_pallas, device="cpu")
    ref = JEngine(jidx, layout="padded", use_pallas=use_pallas)
    assert eng.dispatch == ref.dispatch == "dense"
    assert eng.hub.shape == tuple(ref.hub.shape)
    s, t, wl = _queries(g, 90, seed=4)
    wl = np.minimum(wl, W)
    got = eng.query(s, t, wl)
    assert_same_array(got, np.asarray(ref.query(s, t, wl)))
    assert_same_array(got, TEngine(tidx, device="cpu").query(s, t, wl))
    assert_same_array(got, D[s, t, wl].astype(np.int32))
    prof = eng.query_profile(s, t)
    assert_same_array(prof, np.asarray(ref.query_profile(s, t)))
    assert_same_array(prof, D[s, t, :].astype(np.int32))
    h = eng.query_async(s, t, wl)
    assert h.ready() and h.deadline is None
    assert_same_array(h.wait(), got)
    empty = np.zeros(0, np.int32)
    assert eng.query(empty, empty, empty).shape == (0,)
    assert eng.query_profile(empty, empty).shape == (0, W + 1)


def test_padded_engine_with_cap_matches_reference(world):
    g, _, jidx, tidx, _ = world
    c = max(2, _longest(jidx) // 2)
    s, t, wl = _queries(g, 70, seed=6)
    for up in (True, False):
        eng = TEngine(tidx, layout="padded", cap=c, use_pallas=up,
                      device="cpu")
        ref = JEngine(jidx, layout="padded", cap=c, use_pallas=up)
        assert_same_array(eng.query(s, t, wl), np.asarray(ref.query(s, t, wl)))
        assert_same_array(eng.query_profile(s, t),
                          np.asarray(ref.query_profile(s, t)))


@pytest.mark.parametrize("B,L", [(8, 128), (16, 128), (64, 256), (3, 128),
                                 (100, 384), (1, 7), (5, 130)])
def test_gathered_plain_matches_reference(B, L):
    """K9's plain version against the Pallas kernel (interpret mode, where
    its shape rules allow) and the jnp oracle, capped at DEV_INF."""
    rng = np.random.default_rng(B * 1000 + L)
    hs = rng.integers(-1, 50, size=(B, L)).astype(np.int32)
    ht = rng.integers(-2, 50, size=(B, L)).astype(np.int32)
    ds = rng.integers(0, 100, size=(B, L)).astype(np.int32)
    dt = rng.integers(0, 100, size=(B, L)).astype(np.int32)
    ds[:, ::5] = DEV_INF                         # masked cells
    got = t_wq.wcsd_query_gathered_plain(*_t(hs, ds, ht, dt)).numpy()
    exp = np.minimum(np.asarray(j_ref.wcsd_query_gathered_ref(
        *_j(hs, ds, ht, dt))), DEV_INF)
    assert_same_array(got, exp.astype(np.int32))
    if B % 8 == 0 and L % 128 == 0:
        assert_same_array(got, np.asarray(j_wq.wcsd_query_gathered(
            *_j(hs, ds, ht, dt))))


@pytest.mark.parametrize("B,seed", [(1, 0), (7, 1), (8, 2), (40, 3)])
def test_ops_wcsd_query_matches_reference(B, seed):
    """The reference fuzz case: a random store with unsorted hub rows,
    levels down to -1, counts short of L, through the public op."""
    rng = np.random.default_rng(seed)
    V, L = 40, 96
    hub = rng.integers(-1, 30, size=(V, L)).astype(np.int32)
    dist = rng.integers(0, 64, size=(V, L)).astype(np.int32)
    wlev = rng.integers(-1, 6, size=(V, L)).astype(np.int32)
    count = rng.integers(0, L + 1, size=V).astype(np.int32)
    s = rng.integers(0, V, size=B).astype(np.int32)
    t = rng.integers(0, V, size=B).astype(np.int32)
    w = rng.integers(0, 6, size=B).astype(np.int32)
    _cuda.reset_launch_counts()
    got = t_ops.wcsd_query(*_t(hub, dist, wlev, count, s, t, w)).numpy()
    assert sum(_cuda.LAUNCHES.values()) == 0     # CPU: the plain version
    for use_kernel in (True, False):
        exp = np.asarray(j_ops.wcsd_query(*_j(hub, dist, wlev, count, s, t,
                                              w), use_kernel=use_kernel))
        assert_same_array(got, exp, f"use_kernel={use_kernel}")


@pytest.mark.parametrize("V,D", [(64, 4), (256, 16), (100, 7), (512, 32)])
def test_ops_frontier_relax_matches_reference(V, D):
    rng = np.random.default_rng(V + D)
    nbr = rng.integers(-1, V, size=(V, D)).astype(np.int32)
    lvl = np.where(nbr >= 0, rng.integers(0, 6, size=(V, D)), -1).astype(
        np.int32)
    Fw = rng.integers(-1, 7, size=V).astype(np.int32)
    R = rng.integers(-1, 7, size=V).astype(np.int32)
    got = t_ops.frontier_relax(*_t(nbr, lvl, Fw, R))
    for use_kernel in (True, False):
        exp = j_ops.frontier_relax(*_j(nbr, lvl, Fw, R),
                                   use_kernel=use_kernel)
        for a, b in zip(got, exp):
            assert_same_array(a.numpy(), np.asarray(b))


def test_frontier_round_matches_bfs_round_and_bfs_closure():
    """One K10 round from a root equals one constrained-BFS round (the
    reference test's check), and the rounds run to exhaustion give, at
    every level w, R[v] >= w exactly where the BFS reaches v."""
    jg = scale_free(200, 4, num_levels=4, seed=29)
    g = port_graph(jg)
    nbr_pad, lvl_pad = g.padded_adjacency()
    root = 5
    Fw = np.full(g.num_nodes, -1, np.int32)
    Fw[root] = g.num_levels
    nbr, lvl, F, R = _t(nbr_pad, lvl_pad, Fw, Fw.copy())
    newF, newR = t_ops.frontier_relax(nbr, lvl, F, R)
    exp = j_ops.frontier_relax(*_j(nbr_pad, lvl_pad, Fw, Fw))
    assert_same_array(newF.numpy(), np.asarray(exp[0]))
    assert_same_array(newR.numpy(), np.asarray(exp[1]))
    nbrs, lvls = g.nbr[g.indptr[root]:g.indptr[root + 1]], \
        g.nbr_level[g.indptr[root]:g.indptr[root + 1]]
    for v in nbrs:
        assert newF[v] == max(l_ for u, l_ in zip(nbrs, lvls) if u == v)
    rounds = 0
    while bool((F >= 0).any()):
        F, R = t_ops.frontier_relax(nbr, lvl, F, R)
        rounds += 1
    assert rounds > 2
    for w in range(g.num_levels + 1):
        reach = wcsd_bfs_all(g, root, w) < (1 << 30)
        assert np.array_equal(R.numpy() >= w, reach), w


def test_bfs_all_matches_bfs():
    g = port_graph(erdos_renyi(30, 2.5, num_levels=3, seed=4))
    for s in (0, 7):
        for w in range(g.num_levels + 2):
            d = wcsd_bfs_all(g, s, w)
            assert [int(x) for x in d] == [wcsd_bfs(g, s, v, w)
                                           for v in range(g.num_nodes)]


def test_frontier_plain_matches_reference_ref():
    rng = np.random.default_rng(11)
    fw = rng.integers(-1, 6, size=(33, 5)).astype(np.int32)
    lvl = rng.integers(-1, 6, size=(33, 5)).astype(np.int32)
    R = rng.integers(-1, 6, size=33).astype(np.int32)
    got = t_fr.frontier_relax_gathered_plain(*_t(fw, lvl, R))
    exp = j_ref.frontier_relax_gathered_ref(*_j(fw, lvl, R))
    for a, b in zip(got, exp):
        assert_same_array(a.numpy(), np.asarray(b))
