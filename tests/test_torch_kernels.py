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

K4's card kernel pulls each row once for all roots behind a bitmask of
active roots and hands rows past 8 neighbours to a whole warp; its plain
version is held against the reference on inputs with those branches
(40 roots = two mask words, a star hub's row of 63 neighbours, an all-
inactive frontier). K11's card kernel runs on the tensor cores in
3xTF32: an emulation of that arithmetic (round-to-nearest-away to TF32's
10-bit mantissa, by bit operations) on one CIN layer at the model's
widths is the written reason its fp32 tolerance does not move.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import assert_same_array, port_index
from repro.core.generators import scale_free
from repro.core.graph import Graph
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
from repro_torch.kernels import cin_fuse as t_cin
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


def _shuffle_rows(rng, *arrays):
    """The same random permutation of every row's slots in each array:
    pads land in the middle of rows, real entries after them."""
    V, D = arrays[0].shape
    perm = np.argsort(rng.random((V, D)), axis=1)
    return [np.take_along_axis(a, perm, axis=1) for a in arrays]


@pytest.mark.parametrize("case", ["prefix", "mid-row", "pad-node-V",
                                  "empty-rows"])
def test_row_ends_match_numpy(case):
    """`frontier.row_ends`: one past each row's last slot with id >= 0
    and level >= 0, against a numpy loop (0 for a row without one)."""
    rng = np.random.default_rng(len(case))
    V, D = 37, 11
    n = rng.integers(0, D + 1, V)
    ids = np.where(np.arange(D)[None] < n[:, None],
                   rng.integers(0, V, (V, D)), -1).astype(np.int32)
    lvl = np.where(ids >= 0, rng.integers(0, W + 1, (V, D)), -1).astype(
        np.int32)
    if case == "mid-row":
        ids, lvl = _shuffle_rows(rng, ids, lvl)
    if case == "pad-node-V":            # pads carry id V and level -1
        ids = np.where(ids < 0, V, ids).astype(np.int32)
    if case == "empty-rows":
        ids[::3] = -1
        lvl[1::3] = -1
    exp = np.zeros(V, np.int32)
    for v in range(V):
        real = np.flatnonzero((ids[v] >= 0) & (lvl[v] >= 0))
        exp[v] = real[-1] + 1 if len(real) else 0
    assert_same_array(t_frontier.row_ends(_t(ids), _t(lvl)).numpy(), exp)
    assert t_frontier.row_ends(_t(ids[:, :0]), _t(lvl[:, :0])).shape == (V,)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prune_emit_plain_on_level_major_T_with_mid_row_pads(seed):
    """K3's plain version on the builder's layout: T a [B, V, W+1] view
    of a level-major [B, W+1, V] tensor, label rows with pads in the
    middle (a hub -1 at slot 0 and real entries after it), entries
    past the row-prefix. Equals the Pallas kernel (interpret mode) and
    the jnp oracle, and the ops wrapper given the row ends."""
    F, T, hub, dist, wlev, d = _prune_inputs(seed, 8 - seed)
    rng = np.random.default_rng(seed + 10)
    hub, dist, wlev = _shuffle_rows(rng, hub, dist, wlev)
    hub[:, 0], dist[:, 0], wlev[:, 0] = -1, 1 << 30, -1
    assert ((hub[:, 1:] >= 0) & (hub[:, :-1] < 0)).any()
    Tlm = _t(np.ascontiguousarray(T.transpose(0, 2, 1))).permute(0, 2, 1)
    assert Tlm.stride() == (T.shape[1] * T.shape[2], 1, T.shape[1])
    args = [jnp.asarray(a) for a in (F, T, hub, dist, wlev)]
    pallas = _np(j_ops.wc_prune_emit(*args, jnp.int32(d), interpret=True,
                                     use_kernel=True))
    assert_same_array(_np(j_ref.wc_prune_emit_batched_ref(*args, d)), pallas)
    th = [_t(a) for a in (hub, dist, wlev)]
    plain = t_frontier.wc_prune_emit_batched_plain(_t(F), Tlm, *th, d)
    assert_same_array(plain.numpy(), pallas)
    wrapped = t_ops.wc_prune_emit(_t(F), Tlm, *th, d,
                                  row_end=t_frontier.row_ends(th[0], th[2]))
    assert_same_array(wrapped.numpy(), pallas)
    assert t_frontier.level_major(Tlm) is Tlm
    assert torch.equal(t_frontier.level_major(_t(T)), _t(T))


@pytest.mark.parametrize("seed,pad_node", [(0, "V"), (1, "V"), (2, -1)])
def test_relax_plain_with_mid_row_pads_and_pad_node(seed, pad_node):
    """K4's plain version on an adjacency whose pads sit mid-row and carry
    id V (`padded_adjacency(pad_node=V)`; read as V - 1 and masked by
    their level -1, as the reference clips them) equals the Pallas kernel
    in interpret mode."""
    emit, _, _, rank, rr, R = _relax_inputs(seed, 8 - seed)
    g = scale_free(48, m=2, num_levels=W, seed=seed)
    V = g.num_nodes
    nbr, lvl = g.padded_adjacency(pad_node=V if pad_node == "V" else -1)
    nbr, lvl = _shuffle_rows(np.random.default_rng(seed), nbr, lvl)
    assert ((lvl[:, 1:] >= 0) & (lvl[:, :-1] < 0)).any()
    ja = [jnp.asarray(a) for a in (emit, nbr, lvl, rank, rr, R)]
    pallas = [_np(x) for x in j_ops.wc_relax_batched(
        *ja, interpret=True, use_kernel=True)]
    ta = [_t(a) for a in (emit, nbr, lvl, rank, rr, R)]
    for p, x, y in zip(pallas, t_frontier.wc_relax_batched_plain(*ta),
                       t_ops.wc_relax_batched(
                           *ta, row_end=t_frontier.row_ends(ta[1], ta[2]))):
        assert_same_array(x.numpy(), p)
        assert_same_array(y.numpy(), p)


@pytest.mark.parametrize("kernel", ["prune", "relax"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_row_end_cuts_rows_as_pads(kernel, seed):
    """A ``row_end`` shorter than a row makes every slot at or past it a
    pad in the plain K3 / K4, through the ops wrappers too: the answer
    equals the Pallas kernel (interpret mode) on the same rows with those
    slots overwritten by pads, and differs from the uncut answer. Row ends
    at random, every other row's 0."""
    if kernel == "prune":
        F, T, hub, dist, wlev, d = _prune_inputs(seed, 8)
        rows, pads = (hub, dist, wlev), (-1, 1 << 30, -1)
        fns = (t_frontier.wc_prune_emit_batched_plain, t_ops.wc_prune_emit)

        def port(fn, r, **k):
            return fn(*map(_t, (F, T, *r)), d, **k).numpy()

        def pallas(r):
            return _np(j_ops.wc_prune_emit(*map(jnp.asarray, (F, T, *r)),
                                           jnp.int32(d), interpret=True,
                                           use_kernel=True))
    else:
        emit, nbr, lvl, rank, rr, R = _relax_inputs(seed, 8)
        rows, pads = (nbr, lvl), (-1, -1)
        fns = (t_frontier.wc_relax_batched_plain, t_ops.wc_relax_batched)

        def port(fn, r, **k):
            return np.stack([x.numpy() for x in fn(
                *map(_t, (emit, *r, rank, rr, R)), **k)])

        def pallas(r):
            return np.stack([_np(x) for x in j_ops.wc_relax_batched(
                *map(jnp.asarray, (emit, *r, rank, rr, R)), interpret=True,
                use_kernel=True)])
    V, D = rows[0].shape
    rend = np.random.default_rng(seed + 20).integers(0, D + 1, V).astype(
        np.int32)
    rend[::2] = 0                           # every other row cut whole
    cut = np.arange(D)[None] >= rend[:, None]
    exp = pallas([np.where(cut, p, a).astype(np.int32)
                  for a, p in zip(rows, pads)])
    for fn in fns:
        assert_same_array(port(fn, rows, row_end=_t(rend)), exp)
    assert not np.array_equal(port(fns[0], rows), exp)


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


def _star_hub_inputs(frontier: str):
    """B = 40 roots (two mask words) over a Barabasi-Albert graph plus a
    star hub (vertex 0, 63 neighbours) that every real root may label;
    three inert pad roots at rank V + 1."""
    rng = np.random.default_rng({"inactive": 0, "sparse": 1,
                                 "dense": 2}[frontier])
    V, B = 64, 40
    e = np.array([(a, b) for a in range(1, V) for b in
                  rng.choice(a, min(a, 2), replace=False)], np.int32)
    u = np.concatenate([e[:, 0], np.zeros(V - 1, np.int32)])
    v = np.concatenate([e[:, 1], np.arange(1, V, dtype=np.int32)])
    q = rng.integers(0, W, len(u)).astype(np.float64)
    nbr, lvl = Graph.from_edges(V, u, v, q).padded_adjacency()
    assert (nbr[0] >= 0).sum() == V - 1 > 32
    rank = rng.permutation(V).astype(np.int32)
    top = int(np.argmax(rank))
    rank[[0, top]] = rank[[top, 0]]          # the hub outranks every root
    rr = np.concatenate([rng.integers(0, V - 1, B - 3),
                         [V + 1] * 3]).astype(np.int32)
    p = {"inactive": 0.0, "sparse": 0.05, "dense": 1.0}[frontier]
    emit = np.where(rng.random((B, V)) < p, rng.integers(0, W + 1, (B, V)),
                    -1).astype(np.int32)
    R = rng.integers(-1, W + 1, (B, V)).astype(np.int32)
    return emit, nbr, lvl, rank, rr, R


@pytest.mark.parametrize("frontier", ["inactive", "sparse", "dense"])
def test_relax_batched_plain_matches_pallas_at_two_root_words(frontier):
    emit, nbr, lvl, rank, rr, R = _star_hub_inputs(frontier)
    ja = [jnp.asarray(a) for a in (emit, nbr, lvl, rank, rr, R)]
    pallas = [_np(x) for x in j_ops.wc_relax_batched(
        *ja, interpret=True, use_kernel=True)]
    plain = t_frontier.wc_relax_batched_plain(*(_t(a) for a in (
        emit, nbr, lvl, rank, rr, R)))
    for p, x in zip(pallas, plain):
        assert_same_array(x.numpy(), p)
    if frontier == "inactive":              # nothing to pull: newF all -1
        assert (plain[0] == -1).all()
        assert_same_array(plain[1].numpy(), np.maximum(R, -1))
    assert (plain[0][-3:] == -1).all()      # inert roots label nothing


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: fp32 rounded to TF32's 10-bit mantissa, ties away
    from zero (add half of the dropped 13 bits' range to the magnitude,
    then clear them)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rounding_emulation():
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10
    x = torch.cat([one * (1 + ulp / 2), one * (1 + ulp / 2 - 2 ** -20),
                   one * (1 + ulp * 3 / 4)])
    assert _tf32_rna(x).tolist() == [1 + ulp, -1 - ulp, 1.0, -1.0,
                                     1 + ulp, -1 - ulp]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32))
    h = _tf32_rna(y)
    assert ((h.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((h - y).abs() <= y.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("H", [39, 200])
def test_cin_3xtf32_emulation_keeps_fp32_tolerance(H, seed):
    """One CIN layer at the model's widths (M = 39, D = 10, K = 200), B =
    4, unit-normal x, w * 0.05, as the card kernel computes it:
    z = x1 * x0 in fp32, both operands split into TF32 hi + lo, the
    products lo*hi + hi*lo + hi*hi (each exact in fp32) summed in fp32.
    Against float64 it is within 1e-4 of the layer's max (the tolerance
    K11 is held to), as the plain fp32 version is; single-pass TF32
    (hi*hi alone) is not."""
    B, M, D, K = 4, 39, 10, 200
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((B, H, D)).astype(np.float32)
    x0 = rng.standard_normal((B, M, D)).astype(np.float32)
    w = (rng.standard_normal((K, H, M)) * 0.05).astype(np.float32)
    t1, t0, tw = (torch.from_numpy(a) for a in (x1, x0, w))
    z = (t1.transpose(1, 2)[:, :, :, None]
         * t0.transpose(1, 2)[:, :, None, :]).reshape(B * D, H * M)
    wt = tw.reshape(K, H * M).t().contiguous()
    zh, wh = _tf32_rna(z), _tf32_rna(wt)
    zl, wl = _tf32_rna(z - zh), _tf32_rna(wt - wh)

    def layer(c):
        return c.reshape(B, D, K).transpose(1, 2).double()

    ref = t_cin.cin_layer_plain(t1.double(), t0.double(), tw.double())
    scale = ref.abs().max()
    err = {name: float((layer(c) - ref).abs().max() / scale)
           for name, c in (("3xtf32", zl @ wh + zh @ wl + zh @ wh),
                           ("tf32", zh @ wh), ("fp32", z @ wt))}
    assert err["3xtf32"] <= 1e-4 / 20, err
    assert err["fp32"] <= 1e-4 / 20, err
    assert err["tf32"] > 1e-4, err


def _split3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The hi and lo TF32 parts of an fp32 tensor, as the kernels split
    their operands (lo = rna(a - hi))."""
    hi = _tf32_rna(a)
    return hi, _tf32_rna(a - hi)


def _narrow_emulation(x1, x0, w, passes: int = 3):
    """K11's narrow kernel (csrc/cin_narrow.cu) as it sums, in fp32: the
    factorized form P[n, (m, k)] = sum_h x1[n, h] w[k, h, m] with h in
    stages of 40 and (m, k) in chunks of 25 // ceil(K / 8) values of m,
    each (stage, chunk)'s 3xTF32 products (lo*hi + hi*lo + hi*hi;
    ``passes=1``: hi*hi alone) summed from zero, then out[n, k] +=
    x0[n, m] * P[n, (m, k)] over the chunk's m in order. Returns [B, K,
    D] float32."""
    B, H, D = x1.shape
    M, K = x0.shape[1], w.shape[0]
    mpc = 25 // (-(-K // 8))
    a = x1.transpose(1, 2).reshape(B * D, H)
    x0n = x0.transpose(1, 2).reshape(B * D, M)
    out = torch.zeros((B * D, K), dtype=torch.float32)
    for h0 in range(0, H, 40):
        ah, al = _split3(a[:, h0:h0 + 40])
        for m0 in range(0, M, mpc):
            wc = w[:, h0:h0 + 40, m0:m0 + mpc].permute(1, 2, 0)  # [h, m, k]
            nm = wc.shape[1]
            bh, bl = _split3(wc.reshape(wc.shape[0], nm * K))
            d = ah @ bh if passes == 1 else al @ bh + ah @ bl + ah @ bh
            d = d.reshape(B * D, nm, K)
            for j in range(nm):
                out = out + x0n[:, m0 + j, None] * d[:, j]
    return out.reshape(B, D, K).transpose(1, 2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("M,K", [(200, 39), (39, 39), (148, 64), (7, 8)])
def test_cin_narrow_emulation_keeps_fp32_tolerance(M, K, seed):
    """The narrow K11 kernel's arithmetic (`_narrow_emulation`) at the
    backward's shapes (H' = 200, D = 10; dx0 of a 200-wide layer: M' =
    200, K' = 39; the first layer's dx1 and dx0: M' = K' = 39) and at the
    edges of its K range, B = 4, unit-normal x, w * 0.05: within 1e-4 /
    20 of the output's max against float64, as the plain fp32 version is;
    single-pass TF32 is not within 1e-4."""
    B, H, D = 4, 200, 10
    rng = np.random.default_rng(seed)
    x1, x0 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((B, H, D), (B, M, D)))
    w = torch.from_numpy((rng.standard_normal((K, H, M)) * 0.05).astype(
        np.float32))
    ref = t_cin.cin_layer_plain(x1.double(), x0.double(), w.double())
    scale = ref.abs().max()
    err = {name: float((c.double() - ref).abs().max() / scale)
           for name, c in (("3xtf32", _narrow_emulation(x1, x0, w)),
                           ("tf32", _narrow_emulation(x1, x0, w, 1)),
                           ("fp32", t_cin.cin_layer_plain(x1, x0, w)))}
    assert err["3xtf32"] <= 1e-4 / 20, err
    assert err["fp32"] <= 1e-4 / 20, err
    assert err["tf32"] > 1e-4, err


def _k12_emulation(g, x1, x0, splits: int, passes: int = 3):
    """K12 (csrc/cin_grad.cu) as it sums, in fp32: C[r, k] = sum_n Z[n, r]
    G[n, k] over n in stages of `cin_fuse.CIN_GRAD_STAGE_N`, each stage's
    3xTF32 products summed from zero and added to the slice's fp32
    accumulator, the contraction cut into ``splits`` slices of whole
    stages, the slices added in index order. Returns [K, H, M]."""
    B, K, D = g.shape
    H, M = x1.shape[1], x0.shape[1]
    N, sn = B * D, t_cin.CIN_GRAD_STAGE_N
    z = (x1.transpose(1, 2)[:, :, :, None]
         * x0.transpose(1, 2)[:, :, None, :]).reshape(N, H * M)
    gn = g.transpose(1, 2).reshape(N, K)
    stages = max(1, -(-N // sn))
    per = -(-stages // splits)
    assert -(-stages // per) == splits
    out = None
    for s in range(splits):
        acc = torch.zeros((H * M, K), dtype=torch.float32)
        for c in range(s * per, min(stages, (s + 1) * per)):
            zh, zl = _split3(z[c * sn:(c + 1) * sn].t())
            gh, gl = _split3(gn[c * sn:(c + 1) * sn])
            acc = acc + (zh @ gh if passes == 1
                         else zl @ gh + zh @ gl + zh @ gh)
        out = acc if out is None else out + acc
    return out.t().reshape(K, H, M)


@pytest.mark.parametrize("H", [39, 200])
def test_k12_3xtf32_emulation_keeps_fp32_tolerance(H):
    """K12's arithmetic (`_k12_emulation`) at the model's widths (M = 39,
    D = 10, K = 200), B = 96 (40 stages of 24 n, in the slices
    `cin_grad_splits` chooses for 132 SMs, more than one), unit-normal
    inputs: within 1e-4 / 20 of the output's max against float64, as
    the plain fp32 version is; single-pass TF32 is not within 1e-4."""
    B, M, D, K = 96, 39, 10, 200
    splits = t_cin.cin_grad_splits(B, H, M, D, K, 132)
    assert splits > 1
    rng = np.random.default_rng(H)
    g, x1, x0 = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((B, K, D), (B, H, D), (B, M, D)))
    ref = t_cin.cin_weight_grad_plain(g.double(), x1.double(), x0.double())
    scale = ref.abs().max()
    err = {name: float((c.double() - ref).abs().max() / scale)
           for name, c in (("3xtf32", _k12_emulation(g, x1, x0, splits)),
                           ("tf32", _k12_emulation(g, x1, x0, splits, 1)),
                           ("fp32", t_cin.cin_weight_grad_plain(g, x1, x0)))}
    assert err["3xtf32"] <= 1e-4 / 20, err
    assert err["fp32"] <= 1e-4 / 20, err
    assert err["tf32"] > 1e-4, err
