"""The four kernels of the port's main path (K1 `wcsd_query_ragged`, K2
`wcsd_profile_ragged`, K3 `wc_prune_emit_batched`, K4
`wc_relax_batched`): their plain PyTorch versions, and the `ops` wrappers
on CPU tensors, against the reference Pallas kernels in interpret mode and
against the reference package's jnp oracles (`repro.kernels.ref`). Every
value is int32, so every comparison is exact.

Cases: real arenas (lane 128 and 48), adversarial skewed stores (lane
48), worklist pads and the trash row, s == t, level num_levels (only self
entries feasible), inactive frontiers and inert pad roots. Also the
device-emitted worklist, array for array.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import assert_same_array, port_index
from repro.core.generators import scale_free
from repro.core.query import emit_ragged_worklist as j_emit
from repro.core.query import ragged_worklist_len as j_wl_len
from repro.core.wc_index import build_wc_index
from repro.kernels import frontier as j_frontier
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels import wcsd_query as j_wq
from repro_torch.core.query import TRASH_LEVEL
from repro_torch.core.query import emit_ragged_worklist as t_emit
from repro_torch.core.query import ragged_worklist_len as t_wl_len
from repro_torch.kernels import frontier as t_frontier
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import wcsd_query as t_wq

W = 3  # quality levels of the fixture graph


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def built():
    g = scale_free(90, m=3, num_levels=W, seed=5)
    return g, build_wc_index(g, ordering="degree")


def _skewed_store(lane, seed):
    from benchmarks.bench_wcsd import make_skewed_store
    pidx, heavy = make_skewed_store(V=40, W=W, lane=lane, buckets=3,
                                    rng=np.random.default_rng(seed))
    return pidx, heavy


def _arena(idx, lane):
    return port_index(idx, lane=lane).packed(lane=lane).arena(lane=lane)


def _queries(V, n, rng, heavy=None):
    """A batch mixing random pairs, s == t, level num_levels, and (when
    given) heavy x heavy pairs."""
    s = rng.integers(0, V, n).astype(np.int32)
    t = rng.integers(0, V, n).astype(np.int32)
    wl = rng.integers(0, W + 1, n).astype(np.int32)
    t[:4] = s[:4]                       # s == t, every level incl. W
    wl[:4] = [0, 1, W, W]
    wl[4:8] = W                         # only self entries feasible
    if heavy is not None:
        s[8:11] = np.resize(heavy, 3)
        t[8:11] = np.resize(heavy[::-1], 3)
    return s, t, wl


def _worklist(ar, s, t, pad_to=None):
    """The reference's worklist (with pads: the length is rounded up to a
    power of two, pads point at the trash row)."""
    WL = j_wl_len(ar.tile_cnt, s, t)
    if pad_to:
        WL = max(WL, pad_to)
    q, st, tt, first = (np.asarray(a) for a in j_emit(
        jnp.asarray(ar.tile_base), jnp.asarray(ar.tile_cnt),
        jnp.asarray(s), jnp.asarray(t), worklist_len=WL))
    return q, st, tt, first


def _cases(built):
    g, idx = built
    rng = np.random.default_rng(0)
    out = []
    for lane in (128, 48):
        s, t, wl = _queries(g.num_nodes, 24, rng)
        out.append((f"real-lane{lane}", _arena(idx, lane), s, t, wl))
    for seed in (0, 1):
        pidx, heavy = _skewed_store(48, seed)
        s, t, wl = _queries(pidx.num_nodes, 20, rng, heavy)
        out.append((f"skewed-{seed}", _arena(pidx, 48), s, t, wl))
    return out


CASE_IDS = ["real-lane128", "real-lane48", "skewed-0", "skewed-1"]


@pytest.fixture(scope="module")
def cases(built):
    return dict((c[0], c[1:]) for c in _cases(built))


def _arena_args(ar):
    return [ar.hub, ar.dist, ar.wlev, ar.tile_lo, ar.tile_hi]


@pytest.mark.parametrize("case", CASE_IDS)
def test_query_ragged_plain_matches_pallas_and_ref(cases, case):
    """K1 raw best sums: port plain == Pallas (interpret) == jnp oracle,
    with worklist pads routed to the trash row at level 2^20."""
    ar, s, t, wl = cases[case]
    q, st, tt, first = _worklist(ar, s, t, pad_to=512)
    wq = np.concatenate([wl, [TRASH_LEVEL]]).astype(np.int32)
    pallas = _np(j_wq.wcsd_query_ragged(
        *(jnp.asarray(a) for a in _arena_args(ar)), jnp.asarray(q),
        jnp.asarray(st), jnp.asarray(tt), jnp.asarray(first),
        jnp.asarray(wq), interpret=True))
    ref = _np(j_ref.wcsd_query_ragged_ref(
        jnp.asarray(ar.hub), jnp.asarray(ar.dist), jnp.asarray(ar.wlev),
        jnp.asarray(q), jnp.asarray(st), jnp.asarray(tt), jnp.asarray(wq)))
    plain = t_wq.wcsd_query_ragged_plain(
        _t(ar.hub), _t(ar.dist), _t(ar.wlev), _t(q), _t(st), _t(tt), _t(wq))
    assert_same_array(pallas, ref)
    assert_same_array(plain.numpy(), pallas)
    assert int(plain[-1]) == t_wq.DEV_INF   # the trash row stays infeasible


@pytest.mark.parametrize("case", CASE_IDS)
def test_profile_ragged_plain_matches_pallas_and_ref(cases, case):
    """K2 raw bucket minima: port plain == Pallas (interpret) == oracle."""
    ar, s, t, _ = cases[case]
    q, st, tt, first = _worklist(ar, s, t, pad_to=512)
    rows = len(s) + 1
    pallas = _np(j_wq.wcsd_profile_ragged(
        *(jnp.asarray(a) for a in _arena_args(ar)), jnp.asarray(q),
        jnp.asarray(st), jnp.asarray(tt), jnp.asarray(first),
        num_rows=rows, num_levels=W, interpret=True))
    ref = _np(j_ref.wcsd_profile_ragged_ref(
        jnp.asarray(ar.hub), jnp.asarray(ar.dist), jnp.asarray(ar.wlev),
        jnp.asarray(q), jnp.asarray(st), jnp.asarray(tt), rows, W))
    plain = t_wq.wcsd_profile_ragged_plain(
        _t(ar.hub), _t(ar.dist), _t(ar.wlev), _t(q), _t(st), _t(tt),
        rows, W)
    assert_same_array(pallas, ref)
    assert_same_array(plain.numpy(), pallas)


@pytest.mark.parametrize("case", ["real-lane128", "skewed-1"])
def test_ops_ragged_wrappers_match_reference_ops(cases, case):
    """The wrappers' post-processing: >= DEV_INF -> INF_DIST, and the
    profile suffix min (flip / cummin / flip) == the reference's reverse
    cummin."""
    ar, s, t, wl = cases[case]
    q, st, tt, first = _worklist(ar, s, t)
    wq = np.concatenate([wl, [TRASH_LEVEL]]).astype(np.int32)
    jargs = [jnp.asarray(a) for a in _arena_args(ar) + [q, st, tt, first]]
    targs = [_t(a) for a in _arena_args(ar) + [q, st, tt, first]]
    assert_same_array(
        t_ops.wcsd_query_ragged(*targs, _t(wq)).numpy(),
        _np(j_ops.wcsd_query_ragged(*jargs, jnp.asarray(wq),
                                    interpret=True, use_kernel=True)))
    rows = len(s) + 1
    assert_same_array(
        t_ops.wcsd_profile_ragged(*targs, num_rows=rows,
                                  num_levels=W).numpy(),
        _np(j_ops.wcsd_profile_ragged(*jargs, num_rows=rows, num_levels=W,
                                      interpret=True, use_kernel=True)))


@pytest.mark.parametrize("case", CASE_IDS)
def test_emit_ragged_worklist_matches_reference(cases, case):
    ar, s, t, _ = cases[case]
    WL = j_wl_len(ar.tile_cnt, s, t)
    # the port launches the exact tile-pair total; the reference rounds
    # it up to a power of two
    exact = t_wl_len(ar.tile_cnt, s, t)
    assert exact == int(ar.tile_cnt[s].astype(np.int64)
                        @ ar.tile_cnt[t].astype(np.int64))
    assert 1 << (exact - 1).bit_length() == WL
    for L in (exact, WL, WL + 37):          # exact, power of two, pads
        ref = [np.asarray(a) for a in j_emit(
            jnp.asarray(ar.tile_base), jnp.asarray(ar.tile_cnt),
            jnp.asarray(s), jnp.asarray(t), worklist_len=L)]
        got = t_emit(_t(ar.tile_base), _t(ar.tile_cnt), _t(s), _t(t),
                     worklist_len=L)
        for name, a, b in zip(("qidx", "stile", "ttile", "first"), ref, got):
            assert_same_array(b.numpy(), a, name)


# ------------------------------------------------------ construction side
def _partial_index(V, cap, W1, rng):
    """A padded partial index with rows filled row-prefix first (pads hub
    -1, dist INF_DIST, wlev -1 at the tail), as the builder keeps it."""
    hub = np.full((V, cap), -1, np.int32)
    dist = np.full((V, cap), 1 << 30, np.int32)
    wlev = np.full((V, cap), -1, np.int32)
    for v in range(V):
        n = int(rng.integers(0, cap + 1))
        hub[v, :n] = np.sort(rng.choice(V, n, replace=False))
        dist[v, :n] = rng.integers(1, 9, n)
        wlev[v, :n] = rng.integers(0, W1, n)
    return hub, dist, wlev


def _prune_inputs(seed, inert):
    rng = np.random.default_rng(seed)
    B, V, W1, cap = 8, 40, W + 1, 6
    F = np.where(rng.random((B, V)) < 0.3, rng.integers(0, W1, (B, V)),
                 -1).astype(np.int32)
    F[inert:] = -1                          # inert pad roots: inactive rows
    F[0] = -1                               # a fully inactive frontier
    T = np.where(rng.random((B, V, W1)) < 0.5,
                 rng.integers(0, 6, (B, V, W1)), 1 << 30).astype(np.int32)
    hub, dist, wlev = _partial_index(V, cap, W1, rng)
    return F, T, hub, dist, wlev, int(rng.integers(1, 5))


@pytest.mark.parametrize("seed,inert", [(0, 8), (1, 5), (2, 3)])
def test_prune_emit_plain_matches_pallas_and_ref(seed, inert):
    F, T, hub, dist, wlev, d = _prune_inputs(seed, inert)
    args = [jnp.asarray(a) for a in (F, T, hub, dist, wlev)]
    pallas = _np(j_ops.wc_prune_emit(*args, jnp.int32(d), interpret=True,
                                     use_kernel=True))
    ref = _np(j_ref.wc_prune_emit_batched_ref(*args, d))
    plain = t_frontier.wc_prune_emit_batched_plain(
        *(_t(a) for a in (F, T, hub, dist, wlev)), d)
    assert_same_array(pallas, ref)
    assert_same_array(plain.numpy(), pallas)
    assert (plain[0] == -1).all()
    wrapped = t_ops.wc_prune_emit(*(_t(a) for a in (F, T, hub, dist, wlev)),
                                  d)
    assert_same_array(wrapped.numpy(), pallas)
    # round 0: the whole active frontier emits, unpruned
    tF = _t(F)
    assert t_ops.wc_prune_emit(tF, None, None, None, None, 0,
                               do_prune=False) is tF


def _relax_inputs(seed, nb):
    rng = np.random.default_rng(seed)
    g = scale_free(48, m=2, num_levels=W, seed=seed)
    nbr, lvl = g.padded_adjacency()
    B, V = 8, g.num_nodes
    rank = rng.permutation(V).astype(np.int32)
    root_ranks = np.concatenate([rng.integers(0, V, nb),
                                 np.full(B - nb, V + 1)]).astype(np.int32)
    emit = np.where(rng.random((B, V)) < 0.3, rng.integers(0, W + 1, (B, V)),
                    -1).astype(np.int32)
    emit[nb:] = -1                          # inert pad roots emit nothing
    R = np.where(rng.random((B, V)) < 0.4, rng.integers(0, W + 1, (B, V)),
                 -1).astype(np.int32)
    return emit, nbr, lvl, rank, root_ranks, R


@pytest.mark.parametrize("seed,nb", [(0, 8), (1, 5), (2, 1)])
def test_relax_batched_plain_matches_pallas_and_ref(seed, nb):
    emit, nbr, lvl, rank, rr, R = _relax_inputs(seed, nb)
    ja = [jnp.asarray(a) for a in (emit, nbr, lvl, rank, rr, R)]
    pallas = [_np(x) for x in j_ops.wc_relax_batched(
        *ja, interpret=True, use_kernel=True)]
    ref = [_np(x) for x in j_ref.wc_relax_batched_ref(
        ja[0], ja[1], ja[2], ja[3][None, :], ja[4], ja[5])]
    ta = [_t(a) for a in (emit, nbr, lvl, rank, rr, R)]
    plain = t_frontier.wc_relax_batched_plain(*ta)
    wrapped = t_ops.wc_relax_batched(*ta)
    for p, r, x, y in zip(pallas, ref, plain, wrapped):
        assert_same_array(p, r)
        assert_same_array(x.numpy(), p)
        assert_same_array(y.numpy(), p)
    # inert roots (rank V + 1) never label anything
    assert (plain[0][nb:] == -1).all()


def test_direct_pallas_frontier_kernels_agree_at_block_multiple():
    """The unpadded Pallas entry points (V a multiple of the block) agree
    with the port's plain versions too."""
    F, T, hub, dist, wlev, d = _prune_inputs(7, 6)
    V = F.shape[1]
    pad = 64 - V
    Fp = np.pad(F, ((0, 0), (0, pad)), constant_values=-1)
    Tp = np.pad(T, ((0, 0), (0, pad), (0, 0)), constant_values=1 << 30)
    hp = np.pad(hub, ((0, pad), (0, 0)), constant_values=-1)
    dp = np.pad(dist, ((0, pad), (0, 0)), constant_values=1 << 30)
    wp = np.pad(wlev, ((0, pad), (0, 0)), constant_values=-1)
    pallas = _np(j_frontier.wc_prune_emit_batched(
        *(jnp.asarray(a) for a in (Fp, Tp, hp, dp, wp)),
        jnp.asarray([d], jnp.int32), block_v=64, interpret=True))
    plain = t_frontier.wc_prune_emit_batched_plain(
        *(_t(a) for a in (Fp, Tp, hp, dp, wp)), d)
    assert_same_array(plain.numpy(), pallas)
