"""The port's `WCSDServer` (device backend, csr + ragged, on the CPU)
against the reference server on the same seeded request sequence: submit
/ submit_profile / result / profile_result / poll, duplicate keys in one
batch (both orientations), the LRU memo with `undirected` on and off,
and continuous batching with `max_wait_us`. Every answer must equal the
reference server's and the BFS grid's."""
import numpy as np
import pytest

from _torch_parity import port_index
from repro.core.baselines import constrained_distance_grid
from repro.core.generators import erdos_renyi
from repro.core.serve import WCSDServer as JServer
from repro.core.wc_index import build_wc_index
from repro_torch.core.serve import UnknownRequestError
from repro_torch.core.serve import WCSDServer as TServer


@pytest.fixture(scope="module")
def world():
    g = erdos_renyi(40, 3.0, num_levels=3, seed=21)
    idx = build_wc_index(g, ordering="degree")
    return g, idx, port_index(idx), constrained_distance_grid(g)


def _drive(srv, steps, V, W, seed, poll):
    """Run a seeded request sequence; returns {rid: answer} for scalar and
    profile requests and the (s, t, w) of every scalar request."""
    rng = np.random.default_rng(seed)
    answers, pending, asked, recent = {}, [], {}, []
    for _ in range(steps):
        op = rng.random()
        if op < 0.5:
            if recent and rng.random() < 0.3:     # a duplicate key, either
                s, t, w = recent[int(rng.integers(len(recent)))]
                if rng.random() < 0.5:            # orientation
                    s, t = t, s
            else:
                s, t = int(rng.integers(V)), int(rng.integers(V))
                w = int(rng.integers(W + 1))
            rid = srv.submit(s, t, w)
            asked[rid] = ("q", s, t, w)
            recent.append((s, t, w))
            pending.append(rid)
        elif op < 0.65:
            s, t = int(rng.integers(V)), int(rng.integers(V))
            rid = srv.submit_profile(s, t)
            asked[rid] = ("p", s, t, None)
            pending.append(rid)
        elif op < 0.85 and pending:
            rid = pending.pop(int(rng.integers(len(pending))))
            answers[rid] = (srv.result(rid) if asked[rid][0] == "q"
                            else srv.profile_result(rid))
        elif poll and op < 0.95:
            srv.poll()
    srv.flush()
    for rid in pending:
        answers[rid] = (srv.result(rid) if asked[rid][0] == "q"
                        else srv.profile_result(rid))
    return answers, asked


def _check_against_grid(answers, asked, D):
    for rid, (kind, s, t, w) in asked.items():
        if kind == "q":
            assert answers[rid] == D[s, t, w], rid
        else:
            np.testing.assert_array_equal(answers[rid], D[s, t, :])


STAT_KEYS = ("requests", "profile_requests", "batches", "memo_hits",
             "max_batch")


@pytest.mark.parametrize("undirected", [True, False])
@pytest.mark.parametrize("max_batch,memo", [(16, 65536), (7, 5)])
def test_epoch_sequence_matches_reference(world, undirected, max_batch,
                                          memo):
    """Epoch flushes (auto-flush at max_batch, result() forces a flush):
    the answers AND the batching / memo / dedup counters match the
    reference server step for step; a tiny memo exercises LRU eviction."""
    g, idx, tidx, D = world
    kw = dict(max_batch=max_batch, memo_capacity=memo,
              undirected=undirected)
    ref = JServer(idx, layout="csr", use_pallas=False, **kw)
    srv = TServer(tidx, device="cpu", **kw)
    a_ref, asked = _drive(ref, 300, g.num_nodes, g.num_levels, 5, False)
    a_got, asked2 = _drive(srv, 300, g.num_nodes, g.num_levels, 5, False)
    assert asked == asked2
    for rid in asked:
        np.testing.assert_array_equal(a_got[rid], a_ref[rid])
    _check_against_grid(a_got, asked, D)
    for k in STAT_KEYS:
        assert getattr(srv.stats, k) == getattr(ref.stats, k), k
    assert len(srv.memo) == len(ref.memo)
    assert list(srv.memo) == list(ref.memo)
    assert not srv.results and not srv.profile_results   # read-once


@pytest.mark.parametrize("seed", [77, 78])
def test_continuous_batching_matches_reference(world, seed):
    """max_wait_us=0 / min_batch=4 with poll() ticks: flushes fire below
    the hard cap; every answer equals the reference server's and the
    grid's, and the latency summary covers every request."""
    g, idx, tidx, D = world
    kw = dict(max_batch=32, max_wait_us=0.0, min_batch=4)
    ref = JServer(idx, layout="csr", use_pallas=False, **kw)
    srv = TServer(tidx, device="cpu", **kw)
    a_ref, asked = _drive(ref, 250, g.num_nodes, g.num_levels, seed, True)
    a_got, _ = _drive(srv, 250, g.num_nodes, g.num_levels, seed, True)
    for rid in asked:
        np.testing.assert_array_equal(a_got[rid], a_ref[rid])
    _check_against_grid(a_got, asked, D)
    st = srv.stats
    assert st.opportunistic_flushes + st.deadline_flushes > 0
    assert st.max_batch < kw["max_batch"]
    lat = srv.latency_summary()
    assert lat["count"] == st.requests + st.profile_requests
    assert 0.0 <= lat["p50_us"] <= lat["p99_us"]


def test_duplicate_keys_in_one_batch_use_one_slot(world):
    g, idx, tidx, D = world
    srv = TServer(tidx, max_batch=64, device="cpu")
    rids = [srv.submit(3, 9, 1), srv.submit(9, 3, 1), srv.submit(3, 9, 1)]
    prids = [srv.submit_profile(4, 7), srv.submit_profile(7, 4)]
    assert len(srv.pending) == 1 and len(srv.pending_profiles) == 1
    assert srv.stats.memo_hits == 3
    srv.flush_async()                       # in flight: ride the slot
    rids.append(srv.submit(9, 3, 1))
    assert not srv.pending
    assert [srv.result(r) for r in rids] == [D[3, 9, 1]] * 4
    for r in prids:
        np.testing.assert_array_equal(srv.profile_result(r), D[4, 7, :])
    # a cached profile answers a scalar request of its pair
    before = srv.stats.memo_hits
    rid = srv.submit(7, 4, 2)
    assert not srv.pending and srv.stats.memo_hits == before + 1
    assert srv.result(rid) == D[7, 4, 2]
    with pytest.raises(UnknownRequestError):
        srv.result(rid)                     # read-once


def test_bulk_apis_match_reference(world):
    g, idx, tidx, D = world
    rng = np.random.default_rng(2)
    s = rng.integers(0, 40, 90).astype(np.int32)
    t = rng.integers(0, 40, 90).astype(np.int32)
    wl = rng.integers(0, 4, 90).astype(np.int32)
    ref = JServer(idx, max_batch=32, layout="csr", use_pallas=False)
    srv = TServer(tidx, max_batch=32, device="cpu")
    np.testing.assert_array_equal(srv.query_many(s, t, wl),
                                  ref.query_many(s, t, wl))
    np.testing.assert_array_equal(srv.query_profile_many(s, t),
                                  ref.query_profile_many(s, t))
    np.testing.assert_array_equal(srv.query_profile(3, 5), D[3, 5, :])
    assert srv.query_profile_many([], []).shape == (0, g.num_levels + 1)


def test_unported_features_raise(world, tmp_path):
    """The sharded backend serves over a mesh of CPU shards; the dynamic
    index (``graph=``) and the update
    WAL (``wal_path=``) are ported and build; the compressed arena and
    bucket-pair dispatch are ported, but not together (the reference
    raises `ValueError` for that pair too); the flush watchdog and the
    padded layout are ported and build."""
    g, idx, tidx, _ = world
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    sh = TServer(tidx, backend="sharded",
                 mesh=make_serving_mesh([torch.device("cpu")] * 8))
    assert sh.engine.ndev == 8 and sh.mode == "primary"
    np.testing.assert_array_equal(sh.query_many([0, 1], [1, 0], [0, 0]),
                                  TServer(tidx, device="cpu").query_many(
                                      [0, 1], [1, 0], [0, 0]))
    from _torch_parity import port_graph
    dyn = TServer(tidx, device="cpu", graph=port_graph(g),
                  wal_path=str(tmp_path / "x.wal"))
    assert dyn.graph_version == 0 and dyn.wal.records() == []
    assert TServer(tidx, device="cpu", compressed=True).engine.compressed
    assert TServer(tidx, device="cpu",
                   dispatch="bucket_pair").engine.dispatch == "bucket_pair"
    with pytest.raises(ValueError, match="compressed"):
        TServer(tidx, device="cpu", compressed=True, dispatch="bucket_pair")
    with pytest.raises(ValueError, match="compressed"):
        JServer(idx, layout="csr", compressed=True, dispatch="bucket_pair")
    srv = TServer(tidx, device="cpu", flush_timeout_ms=5.0)
    assert srv.retry_policy.flush_timeout_ms == 5.0 and srv.mode == "primary"
    assert TServer(tidx, device="cpu", layout="padded").engine.dispatch \
        == "dense"
