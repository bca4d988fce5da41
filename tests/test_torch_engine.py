"""The port's `DeviceQueryEngine` (csr layout, ragged dispatch, on the
CPU) against the reference `DeviceQueryEngine(layout="csr",
dispatch="ragged")` and the BFS grid (`constrained_distance_grid`,
indexed ``[s, t, wl]``): scalar queries and profiles, exact."""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_array, port_index
from repro.core.baselines import constrained_distance_grid
from repro.core.generators import erdos_renyi, scale_free
from repro.core.query import DeviceQueryEngine as JEngine
from repro.core.wc_index import build_wc_index
from repro_torch.core.graph import INF_DIST
from repro_torch.core.query import DeviceQueryEngine as TEngine


@pytest.fixture(scope="module")
def er():
    g = erdos_renyi(36, 3.0, num_levels=3, seed=13)
    return g, build_wc_index(g), constrained_distance_grid(g)


def _grid(V, W):
    s, t, w = np.meshgrid(np.arange(V), np.arange(V), np.arange(W + 1),
                          indexing="ij")
    return (s.ravel().astype(np.int32), t.ravel().astype(np.int32),
            w.ravel().astype(np.int32))


@pytest.mark.parametrize("lane", [128, 48, 16])
def test_full_grid_matches_reference_engine_and_bfs(er, lane):
    """Every (s, t, w) of the graph, every level incl. num_levels: the
    port == the reference engine's jnp path == the BFS grid; profiles
    too. lane 16 forces multi-tile rows and multi-bucket stores."""
    g, idx, D = er
    V, W = g.num_nodes, g.num_levels
    s, t, wl = _grid(V, W)
    eng = TEngine(port_index(idx, lane=lane), lane=lane, device="cpu")
    got = eng.query(s, t, wl)
    assert_same_array(got, D[s, t, wl])
    ref = JEngine(idx, layout="csr", lane=lane, use_pallas=False)
    assert_same_array(got, np.asarray(ref.query(s, t, wl)))
    s2, t2 = s[::W + 1], t[::W + 1]
    assert_same_array(eng.query_profile(s2, t2), D[s2, t2, :])


@pytest.mark.parametrize("lane", [128, 48])
def test_matches_reference_pallas_engine(er, lane):
    """A few hundred queries against the reference engine running the
    Pallas kernels in interpret mode."""
    g, idx, D = er
    rng = np.random.default_rng(lane)
    n = 150
    s = rng.integers(0, g.num_nodes, n).astype(np.int32)
    t = rng.integers(0, g.num_nodes, n).astype(np.int32)
    wl = rng.integers(0, g.num_levels + 1, n).astype(np.int32)
    ref = JEngine(idx, layout="csr", lane=lane, use_pallas=True,
                  interpret=True)
    eng = TEngine(port_index(idx, lane=lane), lane=lane, device="cpu")
    assert_same_array(eng.query(s, t, wl), np.asarray(ref.query(s, t, wl)))
    assert_same_array(eng.query_profile(s[:60], t[:60]),
                      np.asarray(ref.query_profile(s[:60], t[:60])))


def test_skewed_store_matches_reference():
    """Adversarial skewed label lengths over several buckets (lane 8)."""
    from benchmarks.bench_wcsd import make_skewed_store
    rng = np.random.default_rng(4)
    pidx, heavy = make_skewed_store(V=48, W=3, lane=8, buckets=4, rng=rng)
    B = 120
    s = rng.integers(0, 48, B).astype(np.int32)
    t = rng.integers(0, 48, B).astype(np.int32)
    s[:4], t[:4] = np.resize(heavy, 4), np.resize(heavy[::-1], 4)
    wl = rng.integers(0, 4, B).astype(np.int32)
    ref = JEngine(pidx, layout="csr", lane=8, use_pallas=False)
    eng = TEngine(port_index(pidx, lane=8), lane=8, device="cpu")
    assert_same_array(eng.query(s, t, wl), np.asarray(ref.query(s, t, wl)))
    assert_same_array(eng.query_profile(s, t),
                      np.asarray(ref.query_profile(s, t)))


def test_empty_batch_and_self_queries(er):
    g, idx, _ = er
    eng = TEngine(port_index(idx), device="cpu")
    empty = np.array([], dtype=np.int32)
    assert eng.query(empty, empty, empty).shape == (0,)
    assert eng.query_profile(empty, empty).shape == (0, g.num_levels + 1)
    v = np.arange(g.num_nodes, dtype=np.int32)
    for w in range(g.num_levels + 1):   # self entry: 0 at every level
        assert (eng.query(v, v, np.full(len(v), w, np.int32)) == 0).all()


def test_single_bucket_store_serves():
    g = erdos_renyi(20, 2.0, num_levels=2, seed=3)
    idx = build_wc_index(g)
    tidx = port_index(idx)
    assert tidx.labels.num_buckets == 1
    D = constrained_distance_grid(g)
    s, t, wl = _grid(20, 2)
    assert_same_array(TEngine(tidx, device="cpu").query(s, t, wl),
                      D[s, t, wl])


def test_pads_use_minimal_tile_vertex():
    """The reference pads a batch to a power of two with the vertex of
    fewest tiles at an infeasible level; the port stages exactly the
    batch, so no pad lane and no pad work item reaches a kernel, and the
    answers are the reference's."""
    from benchmarks.bench_wcsd import make_skewed_store
    from repro_torch.core.query import emit_ragged_worklist, \
        ragged_worklist_len
    pidx, heavy = make_skewed_store(V=32, W=3, lane=8, buckets=3,
                                    rng=np.random.default_rng(0))
    ref = JEngine(pidx, layout="csr", lane=8)
    eng = TEngine(port_index(pidx, lane=8), lane=8, device="cpu")
    h = np.resize(heavy, 3).astype(np.int32)
    for w in (np.zeros(3, np.int32), None):
        a, b = eng._stage_ragged(h, h, w), ref._stage_ragged(h, h, w)
        assert a.shape[1] == 3 and b.shape[1] == 4
        assert_same_array(a, b[:, :3])
        assert b[0, 3] == ref._pad_vertex
    cnt = eng._tile_cnt_np
    L = ragged_worklist_len(cnt, h, h)
    assert L == int((cnt[h].astype(np.int64) ** 2).sum())
    q, _, _, _ = emit_ragged_worklist(*(torch.from_numpy(x) for x in (
        eng.arena.tile_base, cnt, h, h)), worklist_len=L)
    assert int(q.max()) == 2                # no item goes to the trash row
    wl = np.array([0, 1, 3], np.int32)
    assert_same_array(eng.query(h, h[::-1].copy(), wl),
                      np.asarray(ref.query(h, h[::-1].copy(), wl)))
    assert_same_array(eng.query_profile(h, h[::-1].copy()),
                      np.asarray(ref.query_profile(h, h[::-1].copy())))


def test_async_handles_and_quality_thresholds():
    g = scale_free(60, m=2, num_levels=3, seed=1)
    idx = build_wc_index(g)
    eng = TEngine(port_index(idx), device="cpu")
    D = constrained_distance_grid(g)
    s = np.arange(0, 60, 3, dtype=np.int32)
    t = s[::-1].copy()
    h = eng.query_async(s, t, np.ones(len(s), np.int32))
    assert h.ready()
    assert_same_array(h.wait(), D[s, t, 1])
    assert h.wait() is h.wait()            # the handle caches its answer
    got = eng.query_from_quality(s, t, np.full(len(s), g.levels[1]),
                                 g.levels)
    assert_same_array(got, D[s, t, 1])
    assert (D[s, t, g.num_levels][s != t] == INF_DIST).all()
