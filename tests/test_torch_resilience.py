"""The port's serving resilience against the JAX package: the typed
failures, `RetryPolicy`, `build_fallback_ladder`, the flush watchdog and
the fallback ladder of `WCSDServer`, `FaultSchedule` / `FaultyEngine`, and
`flip_array_cell` against the arena's integrity check.

The first nine tests are the port's counterparts of the non-WAL tests of
`tests/test_resilience.py`; the rest hold the port to the reference: the
same ladder for every engine config, the same backoff draws and fault
draws for the same seed, and -- under the same fault schedule -- the same
answers, mode stamps and retry counters from a port server as from a
reference server.
"""
import dataclasses
import itertools
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from _torch_parity import port_index
from repro.checkpoint.fault import FaultSchedule as JSchedule
from repro.checkpoint.fault import FaultyEngine as JFaulty
from repro.core.generators import erdos_renyi, random_queries
from repro.core.resilience import RetryPolicy as JPolicy
from repro.core.resilience import build_fallback_ladder as j_ladder
from repro.core.serve import WCSDServer as JServer
from repro.core.wc_index import build_wc_index
from repro_torch.checkpoint.fault import (FaultSchedule, FaultyEngine,
                                          InjectedEngineError,
                                          _HangingResult, flip_array_cell)
from repro_torch.core.query import DeviceQueryEngine, PendingResult
from repro_torch.core.resilience import (FlushRetryExhausted,
                                         IndexIntegrityError, RetryPolicy,
                                         UnknownRequestError, WALError,
                                         WALReplayError,
                                         build_fallback_ladder)
from repro_torch.core.serve import WCSDServer
from repro_torch.kernels import _cuda
from repro_torch.kernels import ops as kops

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import ladder_walk  # noqa: E402  (the smoke's fault walk)


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(40, 3.0, num_levels=4, seed=2)


@pytest.fixture(scope="module")
def jindex(graph):
    return build_wc_index(graph, ordering="degree")


@pytest.fixture(scope="module")
def index(jindex):
    return port_index(jindex)


def _fast_server(index, **kw):
    base = dict(layout="csr", dispatch="ragged", max_batch=1024,
                backoff_base_ms=0.01, retry_seed=0, device="cpu")
    base.update(kw)
    return WCSDServer(index, **base)


# ---------------------------------------------------------------- taxonomy
def test_unknown_rid_raises_typed_error(index):
    srv = _fast_server(index)
    with pytest.raises(UnknownRequestError, match="unknown or already"):
        srv.result(7)
    with pytest.raises(UnknownRequestError):
        srv.profile_result(7)
    assert issubclass(UnknownRequestError, KeyError)
    err = UnknownRequestError(42)
    assert err.rid == 42 and "42" in str(err)
    assert issubclass(WALReplayError, WALError)
    assert issubclass(FlushRetryExhausted, RuntimeError)


def test_latency_summary_empty_is_zeros(index):
    srv = _fast_server(index)
    assert srv.latency_summary() == {"count": 0, "n": 0,
                                     "p50_us": 0.0, "p99_us": 0.0}


# ------------------------------------------------------------------ ladder
def test_fallback_ladder_full_chain():
    cfg = dict(backend="sharded", use_pallas=True, interpret=True,
               layout="csr", dispatch="ragged", compressed=True,
               mesh="M", device_budget_bytes=1, multi_pod=False)
    names = [n for n, _ in build_fallback_ladder(cfg)]
    assert names == ["primary", "uncompressed", "replicated",
                     "single_device", "bucket_pair", "oracle"]
    ladder = dict(build_fallback_ladder(cfg))
    assert ladder["uncompressed"]["compressed"] is False
    assert ladder["replicated"]["device_budget_bytes"] is None
    assert ladder["single_device"]["backend"] == "device"
    assert ladder["bucket_pair"]["dispatch"] == "bucket_pair"
    assert ladder["oracle"]["layout"] == "padded"
    assert ladder["oracle"]["use_pallas"] is False


def test_fallback_ladder_skips_noop_rungs():
    csr = dict(backend="device", use_pallas=False, interpret=None,
               layout="csr", dispatch="ragged", compressed=False,
               mesh=None, device_budget_bytes=None, multi_pod=False)
    assert [n for n, _ in build_fallback_ladder(csr)] == \
        ["primary", "bucket_pair", "oracle"]
    oracle = dict(csr, layout="padded")
    assert [n for n, _ in build_fallback_ladder(oracle)] == ["primary"]


def test_retry_policy_backoff_is_exponential_and_jittered():
    p = RetryPolicy(backoff_base_ms=2.0, backoff_factor=2.0, jitter=0.0)
    rng = np.random.default_rng(0)
    assert p.backoff_s(1, rng) == pytest.approx(0.002)
    assert p.backoff_s(3, rng) == pytest.approx(0.008)
    pj = RetryPolicy(backoff_base_ms=2.0, jitter=0.5)
    draws = {pj.backoff_s(1, rng) for _ in range(16)}
    assert len(draws) > 1
    assert all(0.001 <= d <= 0.003 for d in draws)


# ---------------------------------------------------------------- watchdog
def test_watchdog_times_out_hung_flush(graph, jindex, index):
    """A handle that never reports ready is abandoned at the deadline and
    the SAME batch re-dispatched — the caller just gets the answer."""
    srv = _fast_server(index, flush_timeout_ms=30.0, max_retries=3)
    real = srv.engine
    calls = {"n": 0}

    class Wedge:
        def __getattr__(self, name):
            return getattr(real, name)

        def query_async(self, s, t, w):
            calls["n"] += 1
            h = real.query_async(s, t, w)
            return _HangingResult(h) if calls["n"] == 1 else h

    srv.engine = Wedge()
    s, t, wl = random_queries(graph, 8, seed=4)
    got = srv.query_many(s, t, wl)
    assert np.array_equal(got, jindex.query_batch(s, t, wl))
    assert srv.stats.timeout_retries == 1 and calls["n"] == 2
    assert srv.mode == "primary"


def test_exhaustion_demotes_then_health_promotes(graph, jindex, index):
    """Retry-budget exhaustion steps one rung down the ladder (the batch
    is answered by the demoted engine, still correct); probe_interval
    healthy flushes step back up."""
    sched = FaultSchedule(fixed={0: "engine_raise", 1: "engine_raise"})
    srv = _fast_server(index, max_retries=1, probe_interval=2,
                       engine_wrapper=lambda e: FaultyEngine(e, sched))
    s, t, wl = random_queries(graph, 6, seed=9)
    got = srv.query_many(s, t, wl)
    assert np.array_equal(got, jindex.query_batch(s, t, wl))
    assert srv.stats.error_retries == 1 and srv.stats.exhausted == 1
    assert srv.stats.demotions == 1 and srv.mode == "bucket_pair"
    rid = srv.submit(int(s[0]) ^ 1, int(t[0]) ^ 1, int(wl[0]))
    val, mode = srv.result_with_mode(rid)
    assert mode == "bucket_pair"
    for i in range(4):
        srv.submit(2 * i, 2 * i + 1, 1)
        srv.flush()
    assert srv.stats.promotions >= 1 and srv.mode == "primary"


def test_exhausted_bottom_rung_requeues_and_preserves_piggybacks(index):
    """FlushRetryExhausted at the bottom of the ladder (an engine= server
    has none): the batch goes back to the FRONT of the pending queue with
    its piggyback rids intact — nothing lost, nothing double-delivered."""
    eng = DeviceQueryEngine(index, layout="csr", device="cpu")
    calls = {"n": 0}

    class Flaky:
        layout = "csr"

        def __getattr__(self, name):
            return getattr(eng, name)

        def query(self, s, t, w):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise InjectedEngineError("dead collective")
            return eng.query(s, t, w)

        query_async = None                      # force the blocking path

    srv = WCSDServer(engine=Flaky(), max_batch=1024, max_retries=1,
                     backoff_base_ms=0.01)
    assert srv.mode == "injected"
    r1 = srv.submit(3, 9, 1)
    r2 = srv.submit(9, 3, 1)                    # piggybacks on r1's slot
    assert srv.stats.memo_hits == 1 and len(srv.pending) == 1
    with pytest.raises(FlushRetryExhausted):
        srv.flush()
    assert len(srv.pending) == 1
    assert srv._scalar.pending_rids == {r1, r2}
    a, b = srv.result(r1), srv.result(r2)       # result() retries the flush
    assert a is not None and a == b
    for rid in (r1, r2):
        with pytest.raises(UnknownRequestError):
            srv.result(rid)


def test_poll_mid_retry_is_a_noop(graph, index):
    """A poll() issued re-entrantly while the watchdog re-dispatches a
    timed-out batch must not harvest the abandoned handle or dispatch the
    queued next batch over the retry."""
    srv = _fast_server(index, flush_timeout_ms=30.0, max_retries=3)
    real = srv.engine
    calls = {"n": 0}
    seen = {}

    class Meddler:
        def __getattr__(self, name):
            return getattr(real, name)

        def query_async(self, s, t, w):
            calls["n"] += 1
            if calls["n"] == 1:
                return _HangingResult(real.query_async(s, t, w))
            if calls["n"] == 2:
                seen["batches_before"] = srv.stats.batches
                seen["pending_before"] = len(srv.pending)
                srv.poll()
                seen["batches_after"] = srv.stats.batches
                seen["pending_after"] = len(srv.pending)
            return real.query_async(s, t, w)

    srv.engine = Meddler()
    rids_a = [srv.submit(i, i + 11, 1) for i in range(3)]
    srv.flush_async()
    rids_b = [srv.submit(i + 20, i + 5, 0) for i in range(2)]
    srv.flush()
    assert seen["batches_after"] == seen["batches_before"]
    assert seen["pending_after"] == seen["pending_before"] == 2
    assert srv.stats.timeout_retries == 1
    got = [srv.result(r) for r in rids_a + rids_b]
    assert all(v is not None for v in got)
    for r in rids_a + rids_b:
        with pytest.raises(UnknownRequestError):
            srv.result(r)


# --------------------------------------------------------- kernel failures
def _failing_build(monkeypatch, tmp_path):
    """Route every kernel call of a CPU server to its CUDA launcher, whose
    build then fails: an empty build directory and a compiler that exits
    non-zero."""
    monkeypatch.setattr(kops, "_on_card", lambda x, what: True)
    monkeypatch.setattr(_cuda, "check_cuda_args", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "_libs", {})
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "nvcc_path", lambda: shutil.which("false"))


def test_failed_kernel_build_raises_kernel_error(monkeypatch, tmp_path):
    _failing_build(monkeypatch, tmp_path)
    with pytest.raises(_cuda.KernelError, match="nvcc wcsd_query.cu failed"):
        _cuda.library("wcsd_query")
    with pytest.raises(_cuda.KernelError, match="launch failed"):
        _cuda.check_launch(1, "wcsd_query_gathered")
    assert issubclass(_cuda.KernelError, RuntimeError)


@pytest.mark.parametrize("timeout_ms", [None, 500.0])
@pytest.mark.parametrize("mode", ["ragged", "compressed", "bucket_pair",
                                  "padded"])
def test_kernel_build_failure_is_not_demoted(graph, jindex, index,
                                             monkeypatch, tmp_path, mode,
                                             timeout_ms):
    """A kernel that does not build raises out of the flush: no retry, no
    demotion to a rung that would hide it behind the plain oracle. The
    batch stays queued and is answered once the kernel works."""
    kw = {"ragged": {}, "compressed": dict(compressed=True),
          "bucket_pair": dict(dispatch="bucket_pair"),
          "padded": dict(layout="padded")}[mode]
    srv = _fast_server(index, flush_timeout_ms=timeout_ms, max_retries=2,
                       **kw)
    s, t, wl = random_queries(graph, 8, seed=21)
    rids = [srv.submit(int(a), int(b), int(c)) for a, b, c in zip(s, t, wl)]
    _failing_build(monkeypatch, tmp_path)
    with pytest.raises(_cuda.KernelError):
        srv.flush()
    st = srv.stats
    assert srv.mode == "primary" and st.demotions == 0
    assert st.error_retries == st.exhausted == 0
    assert srv._scalar.pending_rids == set(rids)
    monkeypatch.undo()
    got = [srv.result(r) for r in rids]
    np.testing.assert_array_equal(got, jindex.query_batch(s, t, wl))
    assert srv.mode == "primary" and st.demotions == 0


@pytest.mark.parametrize("timeout_ms", [None, 500.0])
def test_cuda_error_at_wait_is_not_retried(graph, index, timeout_ms):
    """A CUDA error surfacing when a batch lands leaves the context unusable
    for every rung: it propagates with the batch re-queued, undemoted."""
    def broken(engine):
        class Broken:
            def __getattr__(self, name):
                return getattr(engine, name)

            def query_async(self, s, t, wl):
                def fail():
                    raise torch.AcceleratorError("CUDA error: an illegal "
                                                 "memory access")
                return PendingResult(fail)
        return Broken()

    srv = _fast_server(index, flush_timeout_ms=timeout_ms, max_retries=2,
                       engine_wrapper=broken)
    rids = [srv.submit(i, i + 7, 1) for i in range(4)]
    with pytest.raises(torch.AcceleratorError):
        srv.flush()
    st = srv.stats
    assert srv.mode == "primary" and st.demotions == 0
    assert st.error_retries == st.exhausted == 0
    assert srv._scalar.pending_rids == set(rids)


# ------------------------------------------------------- against the JAX
def _configs():
    keys = ("backend", "use_pallas", "layout", "dispatch", "compressed",
            "device_budget_bytes")
    for vals in itertools.product(("device", "sharded"), (True, False),
                                  ("csr", "padded"), ("ragged",
                                                      "bucket_pair"),
                                  (True, False), (None, 1 << 30)):
        cfg = dict(zip(keys, vals), interpret=None, mesh=None,
                   multi_pod=False)
        yield cfg


def test_ladder_equals_reference_over_config_grid():
    n = 0
    for cfg in _configs():
        assert build_fallback_ladder(cfg) == j_ladder(cfg), cfg
        n += 1
    assert n == 64


@pytest.mark.parametrize("jitter,seed", [(0.5, 0), (0.0, 1), (0.25, 7)])
def test_retry_policy_draws_equal_reference(jitter, seed):
    kw = dict(backoff_base_ms=1.5, backoff_factor=3.0, jitter=jitter)
    p, jp = RetryPolicy(**kw), JPolicy(**kw)
    assert dataclasses.asdict(RetryPolicy()) == dataclasses.asdict(JPolicy())
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    a = [p.backoff_s(k % 5, ra) for k in range(40)]
    b = [jp.backoff_s(k % 5, rb) for k in range(40)]
    assert a == b


def test_fault_schedule_draws_equal_reference():
    kw = dict(seed=3, rates={"engine_raise": 0.2, "flush_hang": 0.1},
              fixed={2: "flush_hang", 5: "engine_raise"})
    a, b = FaultSchedule(**kw), JSchedule(**kw)
    assert [a.draw() for _ in range(200)] == [b.draw() for _ in range(200)]
    assert a.injected == b.injected and a.draws == b.draws == 200
    rateless_a, rateless_b = FaultSchedule(seed=1), JSchedule(seed=1)
    assert [rateless_a.draw() for _ in range(5)] == \
        [rateless_b.draw() for _ in range(5)] == [None] * 5


def _walk(srv, queries, profiles, flushes, per):
    """``flushes`` flushes of ``per`` scalar + ``per // 4`` profile
    requests; returns the answers and the rung each was stamped with."""
    s, t, wl = queries
    ps, pt = profiles
    out, modes, prof, pmodes = [], [], [], []
    for f in range(flushes):
        sl = slice(f * per, (f + 1) * per)
        psl = slice(f * (per // 4), (f + 1) * (per // 4))
        rids = [srv.submit(int(a), int(b), int(c))
                for a, b, c in zip(s[sl], t[sl], wl[sl])]
        prids = [srv.submit_profile(int(a), int(b))
                 for a, b in zip(ps[psl], pt[psl])]
        srv.flush()
        for r in rids:
            v, m = srv.result_with_mode(r)
            out.append(v)
            modes.append(m)
        for r in prids:
            v, m = srv.profile_result_with_mode(r)
            prof.append(v)
            pmodes.append(m)
    return (np.array(out), modes, np.stack(prof), pmodes)


STATS = ("timeout_retries", "error_retries", "exhausted", "demotions",
         "promotions", "batches", "requests", "profile_requests")


@pytest.mark.parametrize("compressed", [False, True])
def test_same_fault_schedule_as_reference_server(graph, jindex, index,
                                                 compressed):
    """The same `FaultSchedule` walks a reference server and a port server
    (CSR, ragged; with and without the compressed arena) down every rung
    and back up: equal answers, mode stamps, retry counters and fault
    logs, and every answer equals the BFS oracle."""
    rungs = ["primary", "uncompressed", "bucket_pair", "oracle"] \
        if compressed else ["primary", "bucket_pair", "oracle"]
    # down, a hang, back up (two healthy flushes a promotion), then primary
    demotions = len(rungs) - 1
    flushes, per = 4 + 3 * demotions, 24
    q = random_queries(graph, flushes * per, seed=11)
    p = random_queries(graph, flushes * per // 4, seed=12)[:2]
    common = dict(layout="csr", dispatch="ragged", compressed=compressed,
                  max_batch=4096, flush_timeout_ms=500.0, max_retries=1,
                  probe_interval=2, backoff_base_ms=0.01, retry_seed=3,
                  memo_capacity=0)
    walk = ladder_walk(demotions)
    ts, js = FaultSchedule(fixed=walk), JSchedule(fixed=walk)
    tsrv = WCSDServer(index, device="cpu",
                      engine_wrapper=lambda e: FaultyEngine(e, ts), **common)
    jsrv = JServer(jindex, engine_wrapper=lambda e: JFaulty(e, js), **common)
    got = _walk(tsrv, q, p, flushes, per)
    exp = _walk(jsrv, q, p, flushes, per)
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[2], exp[2])
    assert got[1] == exp[1] and got[3] == exp[3]
    for k in STATS:
        assert getattr(tsrv.stats, k) == getattr(jsrv.stats, k), k
    assert ts.injected == js.injected and ts.draws == js.draws
    assert tsrv.mode == jsrv.mode == "primary"
    assert set(got[1]) == set(rungs)
    assert tsrv.stats.timeout_retries == 1
    assert tsrv.stats.error_retries == tsrv.stats.exhausted == demotions
    assert tsrv.stats.demotions == tsrv.stats.promotions == demotions
    np.testing.assert_array_equal(got[0], jindex.query_batch(*q))


def test_flip_array_cell_trips_arena_integrity(index):
    ar = index.packed().arena()
    ar.verify_integrity()                       # stamp the baseline
    undo = flip_array_cell(ar.dist, flat_index=5, mask=0x10)
    with pytest.raises(IndexIntegrityError, match="dist"):
        ar.verify_integrity()
    undo()
    ar.verify_integrity()
    undo = flip_array_cell(ar.hub, flat_index=-1)
    with pytest.raises(IndexIntegrityError, match="hub"):
        ar.verify_integrity()
    undo()
    assert ar.verify_integrity() == ar.checksums()
