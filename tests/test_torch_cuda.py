"""Card-only tests of the port: each CUDA kernel against its plain
PyTorch version on CUDA tensors, and the engine, the builder and the
xDeepFM forward on the card against the same calls on the CPU. Marked
`gpu`; they skip where `torch.cuda.is_available()` is false. Run them on
the card with

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import (ROW_CASES, compressed_rows, gathered_rows,
                           label_rows, ragged_items, tile_spans)
from repro_torch.core.generators import erdos_renyi, random_queries, \
    scale_free
from repro_torch.core.query import DeviceQueryEngine, TRASH_LEVEL, \
    emit_ragged_worklist, ragged_worklist_len
from repro_torch.core.serve import WCSDServer
from repro_torch.core.wc_index_batched import build_wc_index_batched_packed
from repro_torch.kernels import _cuda
from repro_torch.kernels import frontier as kfr
from repro_torch.kernels import wcsd_query as kwq

pytestmark = pytest.mark.gpu

PACKED = ("hub_rank", "dist", "wlev", "offsets", "bucket_widths",
          "bucket_of", "slot_of")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def built(card):
    g = scale_free(400, m=4, num_levels=4, seed=0)
    idx, _ = build_wc_index_batched_packed(g, device="cpu")
    return g, idx


@pytest.mark.parametrize("lane", [128, 48])
def test_ragged_kernels_equal_plain(card, built, lane):
    g, idx = built
    eng = DeviceQueryEngine(idx, lane=lane, device=card)
    s, t, wl = random_queries(g, 1000, seed=lane)
    stq = eng._stage_ragged(s, t, wl)
    L = ragged_worklist_len(eng._tile_cnt_np, stq[0], stq[1])
    st = torch.from_numpy(stq).to(card)
    hub, dist, wlev, lo, hi, base, cnt = eng._arena
    q, si, ti, _ = emit_ragged_worklist(base, cnt, st[0], st[1],
                                        worklist_len=L)
    wq = torch.cat([st[2], torch.tensor([TRASH_LEVEL], dtype=torch.int32,
                                        device=card)])
    a = kwq.wcsd_query_ragged_cuda(hub, dist, wlev, lo, hi, q, si, ti, wq)
    b = kwq.wcsd_query_ragged_plain(hub, dist, wlev, q, si, ti, wq)
    assert torch.equal(a, b)
    rows = st.shape[1] + 1
    a = kwq.wcsd_profile_ragged_cuda(hub, dist, wlev, lo, hi, q, si, ti,
                                     rows, g.num_levels)
    b = kwq.wcsd_profile_ragged_plain(hub, dist, wlev, q, si, ti, rows,
                                      g.num_levels)
    assert torch.equal(a, b)


def test_frontier_kernels_equal_plain(card):
    rng = np.random.default_rng(0)
    g = erdos_renyi(300, 4.0, num_levels=4, seed=1)
    B, V, W1, cap = 16, g.num_nodes, 5, 12
    F = np.where(rng.random((B, V)) < 0.2, rng.integers(0, W1, (B, V)), -1)
    T = np.where(rng.random((B, V, W1)) < 0.5,
                 rng.integers(0, 9, (B, V, W1)), 1 << 30)
    n = rng.integers(0, cap + 1, V)
    col = np.arange(cap)[None, :]
    hub = np.where(col < n[:, None], np.sort(rng.integers(0, V, (V, cap)),
                                             1), -1)
    dist = np.where(col < n[:, None], rng.integers(1, 9, (V, cap)), 1 << 30)
    wlev = np.where(col < n[:, None], rng.integers(0, W1, (V, cap)), -1)
    c = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(card)
         for x in (F, T, hub, dist, wlev)]
    assert torch.equal(kfr.wc_prune_emit_batched_cuda(*c, 3),
                       kfr.wc_prune_emit_batched_plain(*c, 3))
    nbr, lvl = (torch.from_numpy(x).to(card) for x in g.padded_adjacency())
    rank = torch.from_numpy(rng.permutation(V).astype(np.int32)).to(card)
    rr = torch.from_numpy(np.concatenate([rng.integers(0, V, B - 2),
                                          [V + 1, V + 1]]).astype(
                                              np.int32)).to(card)
    R = torch.from_numpy(rng.integers(-1, W1, (B, V)).astype(
        np.int32)).to(card)
    for x, y in zip(kfr.wc_relax_batched_cuda(c[0], nbr, lvl, rank, rr, R),
                    kfr.wc_relax_batched_plain(c[0], nbr, lvl, rank, rr, R)):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def hub_adjacency(card):
    """The padded adjacency of a `scale_free` graph (many rows past 32
    neighbours) plus a star hub: vertex 0 joined to every other vertex, a
    row of V - 1 = 1,499 neighbours (past 1,024)."""
    from repro_torch.core.generators import barabasi_albert_edges
    from repro_torch.core.graph import Graph
    V = 1500
    e = barabasi_albert_edges(V, 4, seed=3)
    star = np.arange(1, V, dtype=np.int32)
    u = np.concatenate([e[:, 0], np.zeros(V - 1, np.int32)])
    v = np.concatenate([e[:, 1], star])
    q = np.random.default_rng(3).integers(0, 4, len(u)).astype(np.float64)
    nbr, lvl = Graph.from_edges(V, u, v, q).padded_adjacency()
    deg = (nbr >= 0).sum(1)
    assert deg[0] == V - 1 and (deg > 32).sum() > 10
    return torch.from_numpy(nbr).to(card), torch.from_numpy(lvl).to(card)


@pytest.mark.parametrize("density", [0.001, 0.2, 1.0])
@pytest.mark.parametrize("B", [16, 32, 40])
def test_relax_pull_kernel_equals_plain(card, hub_adjacency, B, density):
    """K4 (mask pass + vertex-major pull) against its plain version, bit
    for bit: one partial root word (16), one full word (32), two words
    (40); sparse to full frontiers; rows past 32 and past 1,024
    neighbours, the hub eligible for every real root; three inert pad
    roots at rank V + 1."""
    nbr, lvl = hub_adjacency
    V = nbr.shape[0]
    rng = np.random.default_rng(B * 1000 + int(density * 1000))
    emit = np.where(rng.random((B, V)) < density,
                    rng.integers(0, 4, (B, V)), -1)
    rank = rng.permutation(V)
    rank[[0, int(np.argmax(rank))]] = rank[[int(np.argmax(rank)), 0]]
    assert rank[0] == V - 1                 # the hub outranks every root
    rr = np.concatenate([rng.integers(0, V - 1, B - 3), [V + 1] * 3])
    R = rng.integers(-1, 4, (B, V))
    x = [torch.from_numpy(a.astype(np.int32)).to(card)
         for a in (emit, rank, rr, R)]
    args = (x[0], nbr, lvl, x[1], x[2], x[3])
    _cuda.reset_launch_counts()
    got = kfr.wc_relax_batched_cuda(*args)
    assert _cuda.LAUNCHES["wc_relax_batched"] == 1
    exp = kfr.wc_relax_batched_plain(*args)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert (got[0][B - 3:] == -1).all()     # inert roots label nothing


# ------------------------------------------ C1: pads anywhere in a row
def test_c1_relax_reads_past_a_mid_row_pad_run(card):
    """K4, the smallest C1 input: D = 9 and rows [n0, -1 x 7, n8] with n8
    active for every root; the pull must read slot 8 (the row end), not
    stop at the pads."""
    V, B = 16, 4
    ar = np.arange(V)
    nbr = np.full((V, 9), -1, np.int32)
    lvl = np.full((V, 9), -1, np.int32)
    nbr[:, 0], lvl[:, 0] = (ar - 1) % V, 1
    nbr[:, 8], lvl[:, 8] = (ar + 1) % V, 3
    emit = np.full((B, V), -1, np.int32)
    emit[:, 5] = 2                      # vertex 4 reaches it at slot 8
    x = [torch.from_numpy(a).to(card) for a in (
        emit, nbr, lvl, ar.astype(np.int32), np.full(B, -1, np.int32),
        np.full((B, V), -1, np.int32))]
    got = kfr.wc_relax_batched_cuda(*x)
    exp = kfr.wc_relax_batched_plain(*x)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert (got[0][:, 4] == 2).all()


@pytest.mark.parametrize("given_row_end", [False, True])
def test_c1_prune_reads_past_a_leading_pad(card, given_row_end):
    """K3, the smallest C1 input: cap = 40, an active row whose slot 0 is
    a pad and whose slot 32 holds a feasible entry giving distance 0 <=
    d: the root must be pruned (emit -1), as the plain version says."""
    B, V, W1, cap, d = 2, 8, 3, 40, 1
    hub = np.full((V, cap), -1, np.int32)
    dist = np.full((V, cap), 1 << 30, np.int32)
    wlev = np.full((V, cap), -1, np.int32)
    hub[3, 32], dist[3, 32], wlev[3, 32] = 6, 0, 2
    F = np.full((B, V), -1, np.int32)
    F[:, 3] = 1
    T = np.full((B, V, W1), 1 << 30, np.int32)
    T[:, 6, :] = 0
    x = [torch.from_numpy(a).to(card) for a in (F, T, hub, dist, wlev)]
    rend = kfr.row_ends(x[2], x[4]) if given_row_end else None
    got = kfr.wc_prune_emit_batched_cuda(*x, d, row_end=rend)
    assert torch.equal(got, kfr.wc_prune_emit_batched_plain(*x, d))
    assert (got[:, 3] == -1).all()


def _pads(nbr, lvl, layout, rng):
    """The adjacency with its pads moved mid-row ("mid-row"), or carrying
    id V ("pad-node-V", mid-row too), or as built ("prefix")."""
    if layout == "prefix":
        return nbr, lvl
    V, D = nbr.shape
    perm = torch.from_numpy(np.argsort(rng.random((V, D)), axis=1)).to(
        nbr.device)
    nbr, lvl = nbr.gather(1, perm), lvl.gather(1, perm)
    if layout == "pad-node-V":
        nbr = torch.where(nbr < 0, V, nbr)
    return nbr, lvl


@pytest.mark.parametrize("layout", ["mid-row", "pad-node-V"])
@pytest.mark.parametrize("density", [0.001, 0.2, 1.0])
def test_relax_pull_kernel_takes_pads_anywhere(card, hub_adjacency, layout,
                                               density):
    """K4 bit for bit against its plain version when every row's pads are
    spread through it, or carry id V (clipped to V - 1 and masked by level
    -1), on rows past 1,024 neighbours; with the row ends given and
    computed."""
    nbr, lvl = hub_adjacency
    V, B = nbr.shape[0], 40
    rng = np.random.default_rng(int(density * 1000) + len(layout))
    nbr, lvl = _pads(nbr, lvl, layout, rng)
    emit = np.where(rng.random((B, V)) < density,
                    rng.integers(0, 4, (B, V)), -1)
    x = [torch.from_numpy(a.astype(np.int32)).to(card) for a in (
        emit, rng.permutation(V), rng.integers(0, V, B),
        rng.integers(-1, 4, (B, V)))]
    args = (x[0], nbr, lvl, x[1], x[2], x[3])
    exp = kfr.wc_relax_batched_plain(*args)
    for rend in (None, kfr.row_ends(nbr, lvl)):
        for a, b in zip(kfr.wc_relax_batched_cuda(*args, row_end=rend), exp):
            assert torch.equal(a, b)


def _prune_case(card, B, density, layout, seed):
    """K3 inputs at V = 1,500: rows of 0-60 hub-sorted entries and ten
    rows of 1,100-1,200 (cap 1,200); distances and T cells small enough
    that roots both prune and emit at d = 6; T level-major."""
    rng = np.random.default_rng(seed)
    V, W1, cap, d = 1500, 4, 1200, 6
    n = rng.integers(0, 61, V)
    n[rng.choice(V, 10, replace=False)] = rng.integers(1100, cap + 1, 10)
    hub = np.full((V, cap), -1, np.int32)
    for v in range(V):
        hub[v, :n[v]] = np.sort(rng.choice(V, n[v], replace=False))
    real = hub >= 0
    dist = np.where(real, rng.integers(0, 6, (V, cap)), 1 << 30)
    wlev = np.where(real, rng.integers(0, W1, (V, cap)), -1)
    if layout == "mid-row":
        perm = np.argsort(rng.random((V, cap)), axis=1)
        hub, dist, wlev = (np.take_along_axis(a, perm, axis=1)
                           for a in (hub, dist, wlev))
    F = np.where(rng.random((B, V)) < density, rng.integers(0, W1, (B, V)),
                 -1)
    T = np.where(rng.random((B, W1, V)) < 0.3, rng.integers(0, 8, (B, W1, V)),
                 1 << 30)
    x = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(card)
         for a in (F, T, hub, dist, wlev)]
    x[1] = x[1].permute(0, 2, 1)            # the builder's layout
    return x, d


@pytest.mark.parametrize("layout", ["prefix", "mid-row"])
@pytest.mark.parametrize("density", [0.002, 0.3, 1.0])
@pytest.mark.parametrize("B", [16, 32, 40])
def test_prune_pull_kernel_equals_plain(card, B, density, layout):
    """K3 (mask pass + vertex-major pull) against its plain version, bit
    for bit: partial, full and two root words; sparse to dense frontiers;
    rows past 1,024 entries; pads at the tail or anywhere; row ends
    computed by the wrapper, and given (for prefix rows, the counts the
    builder keeps); T level-major and, copied by the wrapper, not."""
    x, d = _prune_case(card, B, density, layout, B + int(density * 100))
    exp = kfr.wc_prune_emit_batched_plain(*x, d)
    assert ((exp >= 0) & (x[0] >= 0)).any() or density < 0.01
    assert ((exp < 0) & (x[0] >= 0)).any()
    _cuda.reset_launch_counts()
    assert torch.equal(kfr.wc_prune_emit_batched_cuda(*x, d), exp)
    assert _cuda.LAUNCHES["wc_prune_emit_batched"] == 1
    rend = (x[2] >= 0).sum(1).int() if layout == "prefix" else \
        kfr.row_ends(x[2], x[4])
    assert torch.equal(kfr.wc_prune_emit_batched_cuda(*x, d, row_end=rend),
                       exp)
    y = list(x)
    y[1] = x[1].contiguous()                # [B, V, W+1] in memory
    assert torch.equal(kfr.wc_prune_emit_batched_cuda(*y, d), exp)


@pytest.mark.parametrize("kernel", ["prune", "relax"])
def test_short_row_end_cuts_rows_on_card_as_plain(card, hub_adjacency,
                                                  kernel):
    """A ``row_end`` shorter than its row: K3 / K4 on the card drop every
    slot at or past it exactly as their plain versions mask them (one
    contract on both devices); rows past 1,024 slots, row ends at random
    and every other row's 0; the cut changes the answer."""
    rng = np.random.default_rng(5)
    if kernel == "prune":
        x, d = _prune_case(card, 32, 0.3, "mid-row", 7)
        rows = x[2]
        fns = (kfr.wc_prune_emit_batched_cuda,
               kfr.wc_prune_emit_batched_plain)

        def run(fn, **k):
            return (fn(*x, d, **k),)
    else:
        rows, lvl = hub_adjacency
        V, B = rows.shape[0], 40
        x = [torch.from_numpy(a.astype(np.int32)).to(card) for a in (
            np.where(rng.random((B, V)) < 0.2, rng.integers(0, 4, (B, V)),
                     -1), rng.permutation(V), rng.integers(0, V, B),
            rng.integers(-1, 4, (B, V)))]
        args = (x[0], rows, lvl, x[1], x[2], x[3])
        fns = (kfr.wc_relax_batched_cuda, kfr.wc_relax_batched_plain)

        def run(fn, **k):
            return fn(*args, **k)
    V, D = rows.shape
    rend = torch.from_numpy(rng.integers(0, D + 1, V).astype(np.int32)).to(
        card)
    rend[::2] = 0
    got, exp = (run(fn, row_end=rend) for fn in fns)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(exp, run(fns[1])))


def _seg_rows(rng, n, W, case, H=400):
    """[n, W] (hub, dist, wlev) tiles: hub-sorted rows with pads at the
    tail ("sorted"), shuffled rows ("unsorted"), pads spread mid-row
    ("mid-row-pads"), or sorted rows whose pads carry a feasible distance
    ("live-pads", which the merge join must not take)."""
    hub = np.full((n, W), -1, np.int32)
    dist = np.full((n, W), 1 << 30, np.int32)
    wlev = np.full((n, W), -1, np.int32)
    for r in range(n):
        k = int(rng.integers(0, W + 1))
        hub[r, :k] = np.sort(rng.integers(0, H, k))   # repeated hubs too
        dist[r, :k] = rng.integers(0, 1000, k)
        wlev[r, :k] = rng.integers(0, 4, k)
    if case in ("unsorted", "mid-row-pads"):
        perm = np.argsort(rng.random((n, W)), axis=1)
        if case == "unsorted":          # real cells stay first, unordered
            perm = np.argsort(np.where(hub >= 0, rng.random((n, W)), 2),
                              axis=1)
        hub, dist, wlev = (np.take_along_axis(a, perm, axis=1)
                           for a in (hub, dist, wlev))
    if case == "live-pads":
        dist = np.where(hub < 0, 7, dist)
        wlev = np.where(hub < 0, 3, wlev)
    return hub, dist, wlev


@pytest.mark.parametrize("case", ["sorted", "unsorted", "mid-row-pads",
                                  "live-pads"])
@pytest.mark.parametrize("Ws,Wt", [(48, 130), (2048, 1024), (3000, 100)])
def test_segmented_merge_join_takes_any_rows(card, case, Ws, Wt):
    """K7 against its plain version on rows the merge join takes (sorted)
    and on rows it must join all-pairs inside the kernel (unsorted, pads
    mid-row, pads with a feasible distance), with Ws != Wt, a side wider
    than the shared-memory stage (3,000), per sub-batch and grouped."""
    from repro_torch.kernels import wcsd_segmented as kseg
    rng = np.random.default_rng(Ws + Wt + len(case))
    B = 300
    ts = [torch.from_numpy(a).to(card) for a in _seg_rows(rng, 50, Ws, case)]
    tt = [torch.from_numpy(a).to(card) for a in _seg_rows(rng, 50, Wt, case)]
    q = [torch.from_numpy(a.astype(np.int32)).to(card) for a in (
        rng.integers(0, 50, B), rng.integers(0, 50, B),
        rng.integers(-1, 5, B))]
    exp = kseg.wcsd_query_segmented_plain(*ts, *tt, *q)
    assert (exp < (1 << 29)).any()
    got = kseg.wcsd_query_segmented_cuda(*ts, *tt, *q)
    assert torch.equal(got, exp)
    groups = [(ts, tt, 100), (ts, ts, 120), (tt, tt, 80)]
    flush = kseg.GroupedFlush(groups, torch.stack(q).cpu().numpy(), card)
    _cuda.reset_launch_counts()
    grouped = kseg.wcsd_query_segmented_grouped_cuda(flush)
    assert _cuda.LAUNCHES["wcsd_query_segmented"] == 1
    assert torch.equal(grouped,
                       kseg.wcsd_query_segmented_grouped_plain(flush))
    assert torch.equal(grouped[:100], exp[:100])


@pytest.mark.parametrize("num_levels", [0, 4, 31])
@pytest.mark.parametrize("case", ["sorted", "unsorted", "mid-row-pads",
                                  "live-pads"])
@pytest.mark.parametrize("Ws,Wt", [(48, 130), (2048, 1024), (3000, 100)])
def test_segmented_profile_merge_join_takes_any_rows(card, case, Ws, Wt,
                                                     num_levels):
    """K8 against its plain version on rows the merge join takes (sorted)
    and on rows it must join all-pairs inside the kernel (unsorted, pads
    mid-row, pads with a live wlev), with Ws != Wt and a side wider than
    the shared-memory stage (3,000), at num_levels + 1 of 1, 5 and 32
    bins (a tenth of the real cells one level past the last), per
    sub-batch and grouped (one launch over a [2, B] staged array)."""
    from repro_torch.kernels import wcsd_segmented as kseg
    rng = np.random.default_rng(Ws + Wt + len(case) + num_levels)
    B = 300

    def rows(W):
        hub, dist, wlev = _seg_rows(rng, 50, W, case)
        past = (hub >= 0) & (rng.random(hub.shape) < 0.1)
        wlev = np.where(past, num_levels + 1, wlev).astype(np.int32)
        return [torch.from_numpy(a).to(card) for a in (hub, dist, wlev)]

    ts, tt = rows(Ws), rows(Wt)
    q = [torch.from_numpy(a.astype(np.int32)).to(card) for a in (
        rng.integers(0, 50, B), rng.integers(0, 50, B))]
    exp = kseg.wcsd_profile_segmented_plain(*ts, *tt, *q, num_levels)
    assert (exp < (1 << 29)).any()
    _cuda.reset_launch_counts()
    got = kseg.wcsd_profile_segmented_cuda(*ts, *tt, *q, num_levels)
    assert _cuda.LAUNCHES["wcsd_profile_segmented"] == 1
    assert torch.equal(got, exp)
    groups = [(ts, tt, 100), (ts, ts, 120), (tt, tt, 80)]
    flush = kseg.GroupedFlush(groups, torch.stack(q).cpu().numpy(), card)
    _cuda.reset_launch_counts()
    grouped = kseg.wcsd_profile_segmented_grouped_cuda(flush, num_levels)
    assert _cuda.LAUNCHES["wcsd_profile_segmented"] == 1
    assert torch.equal(grouped, kseg.wcsd_profile_segmented_grouped_plain(
        flush, num_levels))
    assert torch.equal(grouped[:100], exp[:100])


def test_grouped_profile_flush_equals_per_sub_batch_launches(card, built):
    """A bucket-pair profile flush through the engine: one K8 launch,
    equal to the per-sub-batch launches of `wcsd_profile_segmented_cuda`
    on the same staging, and to the CPU engine."""
    from repro_torch.core.query import plan_query_batch, stage_sub_batch
    from repro_torch.kernels import wcsd_segmented as kseg
    g, idx = built
    s, t, _ = random_queries(g, 3000, seed=12)
    W = g.num_levels
    eng = DeviceQueryEngine(idx, lane=16, dispatch="bucket_pair",
                            device=card)
    plan = plan_query_batch(eng._bucket_of, s, t)
    assert len(plan) > 4
    parts = [kseg.wcsd_profile_segmented_cuda(
        *eng._tiles[p.bucket_s], *eng._tiles[p.bucket_t],
        *torch.from_numpy(stage_sub_batch(eng._slot_of, p.positions, s,
                                          t)).to(card), W) for p in plan]
    bucket = torch.cat(parts)
    prof = torch.flip(torch.cummin(torch.flip(bucket, (1,)), dim=1).values,
                      (1,))
    pos = np.concatenate([p.positions for p in plan])
    exp = np.empty((len(s), W + 1), np.int32)
    exp[pos] = torch.where(prof >= 1 << 29, 1 << 30, prof).cpu().numpy()
    _cuda.reset_launch_counts()
    got = eng.query_profile(s, t)
    assert _cuda.LAUNCHES["wcsd_profile_segmented"] == 1
    np.testing.assert_array_equal(got, exp)
    ref = DeviceQueryEngine(idx, lane=16, dispatch="bucket_pair",
                            device="cpu")
    np.testing.assert_array_equal(got, ref.query_profile(s, t))


def test_grouped_flush_equals_per_sub_batch_launches(card, built):
    """A bucket-pair flush through the engine: one K7 launch, equal to the
    per-sub-batch launches of `wcsd_query_segmented_cuda` on the same
    staging, and to the CPU engine; staging refuses sub-batches that do
    not cover the queries."""
    from repro_torch.core.query import plan_query_batch, stage_sub_batch
    from repro_torch.kernels import wcsd_segmented as kseg
    g, idx = built
    s, t, wl = random_queries(g, 3000, seed=11)
    eng = DeviceQueryEngine(idx, lane=16, dispatch="bucket_pair",
                            device=card)
    plan = plan_query_batch(eng._bucket_of, s, t)
    assert len(plan) > 4
    parts = [kseg.wcsd_query_segmented_cuda(
        *eng._tiles[p.bucket_s], *eng._tiles[p.bucket_t],
        *torch.from_numpy(stage_sub_batch(eng._slot_of, p.positions, s, t,
                                          wl)).to(card)) for p in plan]
    pos = np.concatenate([p.positions for p in plan])
    exp = np.empty(len(s), np.int32)
    exp[pos] = torch.where(torch.cat(parts) >= 1 << 29, 1 << 30,
                           torch.cat(parts)).cpu().numpy()
    _cuda.reset_launch_counts()
    got = eng.query(s, t, wl)
    assert _cuda.LAUNCHES["wcsd_query_segmented"] == 1
    np.testing.assert_array_equal(got, exp)
    ref = DeviceQueryEngine(idx, lane=16, dispatch="bucket_pair",
                            device="cpu")
    np.testing.assert_array_equal(got, ref.query(s, t, wl))
    groups = [(eng._tiles[p.bucket_s], eng._tiles[p.bucket_t],
               len(p.positions)) for p in plan]
    stq = stage_sub_batch(eng._slot_of, pos, s, t, wl)
    with pytest.raises(ValueError, match="cover"):   # a sub-batch short
        kseg.GroupedFlush(groups[1:], stq, card)


def test_build_on_card_equals_cpu_and_serves(card, built):
    g, idx_cpu = built
    _cuda.reset_launch_counts()
    idx, _ = build_wc_index_batched_packed(g, device=card)
    assert _cuda.LAUNCHES["wc_prune_emit_batched"] > 0
    assert _cuda.LAUNCHES["wc_relax_batched"] > 0
    for name in PACKED:
        np.testing.assert_array_equal(getattr(idx.labels, name),
                                      getattr(idx_cpu.labels, name))
    s, t, wl = random_queries(g, 3000, seed=5)
    srv = WCSDServer(idx, max_batch=1024, device=card)
    before = _cuda.LAUNCHES["wcsd_query_ragged"]
    got = srv.query_many(s, t, wl)
    assert _cuda.LAUNCHES["wcsd_query_ragged"] - before == srv.stats.batches
    ref = WCSDServer(idx_cpu, max_batch=1024, device="cpu")
    np.testing.assert_array_equal(got, ref.query_many(s, t, wl))
    np.testing.assert_array_equal(srv.query_profile_many(s[:500], t[:500]),
                                  ref.query_profile_many(s[:500], t[:500]))


def _worklist(eng, s, t, wl=None):
    stq = eng._stage_ragged(s, t, wl)
    L = ragged_worklist_len(eng._tile_cnt_np, stq[0], stq[1])
    st = torch.from_numpy(stq).to(eng.device)
    base, cnt = eng._arena[5], eng._arena[6]
    q, si, ti, _ = emit_ragged_worklist(base, cnt, st[0], st[1],
                                        worklist_len=L)
    return st, q, si, ti


@pytest.mark.parametrize("lane,dtype", [(128, "bfloat16"), (48, "bfloat16"),
                                        (128, "float16")])
def test_compressed_kernels_equal_plain(card, built, lane, dtype):
    """K5/K6 against their plain versions on the card, both float
    formats, at multi-tile lanes."""
    g, idx = built
    eng = DeviceQueryEngine(idx, lane=lane, device=card)
    comp = idx.labels.compressed_arena(lane=lane, dtype=dtype)
    assert comp.num_overflow_tiles == 0
    fdt = torch.bfloat16 if dtype == "bfloat16" else torch.float16
    hd = torch.from_numpy(comp.hub_delta).to(card)
    dist = torch.from_numpy(comp.dist.view(np.int16)).to(card).view(fdt)
    wlev = torch.from_numpy(comp.wlev).to(card)
    lo, hi = eng._arena[3], eng._arena[4]
    s, t, wl = random_queries(g, 1000, seed=lane + 1)
    st, q, si, ti = _worklist(eng, s, t, wl)
    wq = torch.cat([st[2], torch.tensor([TRASH_LEVEL], dtype=torch.int32,
                                        device=card)])
    a = kwq.wcsd_query_ragged_compressed_cuda(hd, dist, wlev, lo, hi, q, si,
                                              ti, wq)
    b = kwq.wcsd_query_ragged_compressed_plain(hd, dist, wlev, lo, q, si,
                                               ti, wq)
    assert torch.equal(a, b)
    # exact distances here: the compressed join equals K1's
    assert torch.equal(a, kwq.wcsd_query_ragged_cuda(*eng._arena[:5], q, si,
                                                     ti, wq))
    rows = st.shape[1] + 1
    a = kwq.wcsd_profile_ragged_compressed_cuda(hd, dist, wlev, lo, hi, q,
                                                si, ti, rows, g.num_levels)
    b = kwq.wcsd_profile_ragged_compressed_plain(hd, dist, wlev, lo, q, si,
                                                 ti, rows, g.num_levels)
    assert torch.equal(a, b)


def test_compressed_decode_on_card_rounds_as_the_plain_version(card):
    """Large and fractional-free distances across the bf16/fp16 range,
    +inf pads, hub deltas up to int16 max: K5 equals its plain version
    cell for cell (one single-cell tile per work item)."""
    rng = np.random.default_rng(0)
    lane, T = 1, 4096
    d = np.concatenate([np.arange(2048), rng.integers(2048, 1 << 29,
                                                      T - 2049),
                        [np.inf]]).astype(np.float64)
    for fdt in (torch.bfloat16, torch.float16):
        dist = torch.from_numpy(d).to(fdt).reshape(T, lane).to(card)
        hd = torch.from_numpy(rng.integers(-1, 32768, (T, lane)).astype(
            np.int16)).to(card)
        wlev = torch.from_numpy(rng.integers(-1, 4, (T, lane)).astype(
            np.int8)).to(card)
        lo = torch.from_numpy(rng.integers(0, 1000, T).astype(
            np.int32)).to(card)
        hi = torch.full((T,), 1 << 20, dtype=torch.int32, device=card)
        k = torch.arange(T, dtype=torch.int32, device=card)
        wq = torch.zeros(T, dtype=torch.int32, device=card)
        a = kwq.wcsd_query_ragged_compressed_cuda(hd, dist, wlev, lo, hi, k,
                                                  k, k, wq)
        b = kwq.wcsd_query_ragged_compressed_plain(hd, dist, wlev, lo, k, k,
                                                   k, wq)
        assert torch.equal(a, b)


FLOATS = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _compressed_on_card(card, hub, dist, wlev, lo, dtype, offset=0):
    """The tiles in the compressed format on the card, each array
    starting ``offset`` elements into its buffer (1: 2-, 2- and 1-byte
    aligned, so the kernel stages a cell at a time)."""
    def put(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=card)
        y = buf[offset:].view(x.shape)
        y.copy_(x)
        return y if dt is None else y.view(dt)
    hd, bits, wl = compressed_rows(hub, dist, wlev, lo, dtype)
    return put(hd), put(bits.view(np.int16), FLOATS[dtype]), put(wl)


def _compressed_kernels_equal_plain(card, comp, lo, hi, q, st, tt, wq, Q,
                                    num_levels):
    """K5 and K6 (one launch each) equal their plain versions."""
    _cuda.reset_launch_counts()
    got = kwq.wcsd_query_ragged_compressed_cuda(*comp, lo, hi, q, st, tt, wq)
    gotp = kwq.wcsd_profile_ragged_compressed_cuda(*comp, lo, hi, q, st, tt,
                                                   Q + 1, num_levels)
    assert _cuda.LAUNCHES["wcsd_query_ragged_compressed"] == 1
    assert _cuda.LAUNCHES["wcsd_profile_ragged_compressed"] == 1
    exp = kwq.wcsd_query_ragged_compressed_plain(*comp, lo, q, st, tt, wq)
    expp = kwq.wcsd_profile_ragged_compressed_plain(*comp, lo, q, st, tt,
                                                    Q + 1, num_levels)
    assert torch.equal(got, exp)
    assert torch.equal(gotp, expp)
    return exp, expp


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("lane", [128, 48, 1])
@pytest.mark.parametrize("case", ROW_CASES)
def test_compressed_merge_kernels_take_any_tiles(card, case, lane, dtype):
    """K5 and K6 (K1's and K2's kernels, decoding the compressed tiles as
    they stage them) against their plain versions on K1's tiles of every
    row case in the compressed format, lanes 128, 48 (96-byte hub rows,
    48-byte level rows) and 1 (2- and 1-byte tiles), both float formats;
    the worklist in shuffled order with its pads on the trash row at
    TRASH_LEVEL, query levels from 0 to one above every cell, profiles at
    5 bins."""
    rng = np.random.default_rng(lane * 100 + ROW_CASES.index(case) + 11)
    T, Q, top = 120, 200, 4
    hub, dist, wlev = label_rows(rng, T, lane, case, top_level=top)
    lo, hi = tile_spans(hub, wlev)
    q, st, tt, _ = ragged_items(rng, Q, T, length=4 * Q + 40)
    wq = np.concatenate([rng.integers(0, top + 2, Q),
                         [TRASH_LEVEL]]).astype(np.int32)
    perm = rng.permutation(len(q))
    comp = _compressed_on_card(card, hub, dist, wlev, lo, dtype)
    spans = [torch.from_numpy(a).to(card) for a in (lo, hi)]
    items = [torch.from_numpy(a[perm]).to(card) for a in (q, st, tt)]
    exp, expp = _compressed_kernels_equal_plain(
        card, comp, *spans, *items, torch.from_numpy(wq).to(card), Q, top)
    assert case == "pads-only" or (expp[:Q] < kwq.DEV_INF).any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", ["store", "live-pad", "descending"])
def test_compressed_merge_kernels_take_unaligned_arrays(card, case, dtype):
    """K5 and K6 at lane 48 with every compressed array one element into
    its buffer (no 4-cell loads: the stager's cell-at-a-time path)."""
    rng = np.random.default_rng(ROW_CASES.index(case) + 23)
    T, Q, lane, top = 120, 200, 48, 4
    hub, dist, wlev = label_rows(rng, T, lane, case, top_level=top)
    lo, hi = tile_spans(hub, wlev)
    q, st, tt, _ = ragged_items(rng, Q, T, length=4 * Q + 40)
    wq = np.concatenate([rng.integers(0, top + 2, Q),
                         [TRASH_LEVEL]]).astype(np.int32)
    comp = _compressed_on_card(card, hub, dist, wlev, lo, dtype, offset=1)
    assert comp[0].data_ptr() % 8 and comp[2].data_ptr() % 4
    spans = [torch.from_numpy(a).to(card) for a in (lo, hi)]
    items = [torch.from_numpy(a).to(card) for a in (q, st, tt)]
    exp, _ = _compressed_kernels_equal_plain(
        card, comp, *spans, *items, torch.from_numpy(wq).to(card), Q, top)
    assert (exp[:Q] < kwq.DEV_INF).any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("lane", [128, 48, 1])
def test_compressed_kernels_on_shuffled_store_tiles(card, built, lane,
                                                    dtype):
    """K5 and K6 against their plain versions on a real store's compressed
    tiles, and on the same tiles with every tile's cells shuffled (which
    the merge check refuses, so the all-pairs branch answers), lanes 128,
    48 and 1, both float formats."""
    g, idx = built
    eng = DeviceQueryEngine(idx, lane=lane, device=card)
    comp = idx.labels.compressed_arena(lane=lane, dtype=dtype)
    assert comp.num_overflow_tiles == 0
    arrays = [torch.from_numpy(comp.hub_delta).to(card),
              torch.from_numpy(comp.dist.view(np.int16)).to(card)
              .view(FLOATS[dtype]),
              torch.from_numpy(comp.wlev).to(card)]
    lo, hi = eng._arena[3], eng._arena[4]
    s, t, wl = random_queries(g, 1000, seed=lane + 3)
    st, q, si, ti = _worklist(eng, s, t, wl)
    wq = torch.cat([st[2], torch.tensor([TRASH_LEVEL], dtype=torch.int32,
                                        device=card)])
    Q = st.shape[1]
    gen = torch.Generator(device=card).manual_seed(lane)
    perm = torch.rand(arrays[0].shape, generator=gen,
                      device=card).argsort(dim=1)
    shuffled = [a.gather(1, perm) for a in arrays]
    if lane > 1:
        ok = (arrays[0][:, 1:] >= arrays[0][:, :-1]) | (arrays[0][:, 1:] < 0)
        assert ok.all()              # the store's tiles are hub-sorted
        assert not torch.equal(shuffled[0], arrays[0])
    for tiles in (arrays, shuffled):
        exp, expp = _compressed_kernels_equal_plain(
            card, tiles, lo, hi, q, si, ti, wq, Q, g.num_levels)
        assert (exp[:Q] < kwq.DEV_INF).any()


def _skewed_index(V=300, W=4, lane=128, seed=0):
    """A synthetic hub-sorted store with a few rows past 2,048 entries, so
    the bucket widths reach past the segmented kernels' t-chunk."""
    from repro_torch.core.wc_index import PackedLabels, PackedWCIndex
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, lane + 1, V)
    lens[:4] = [300, 900, 2500, 5000]
    hub = np.concatenate([np.sort(rng.choice(20000, k, replace=False))
                          for k in lens]).astype(np.int32)
    offsets = np.zeros(V + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    dist = rng.integers(0, 1000, len(hub)).astype(np.int32)
    wlev = rng.integers(0, W + 1, len(hub)).astype(np.int32)
    store = PackedLabels.from_flat(hub, dist, wlev, offsets, lane=lane)
    ar = np.arange(V, dtype=np.int32)
    return PackedWCIndex(order=ar, rank=ar.copy(),
                         levels=np.arange(W, dtype=np.float64), labels=store)


@pytest.mark.parametrize("store", ["built-128", "built-16", "skewed"])
def test_segmented_kernels_equal_plain(card, built, store):
    """K7/K8 against their plain versions on every populated bucket pair
    of a flush; the skewed store has rows wider than the t-chunk."""
    from repro_torch.core.query import plan_query_batch, stage_sub_batch
    from repro_torch.kernels import wcsd_segmented as kseg
    if store == "skewed":
        idx, lane, W = _skewed_index(), 128, 4
        rng = np.random.default_rng(1)
        s = rng.integers(0, idx.num_nodes, 2000).astype(np.int32)
        t = rng.integers(0, idx.num_nodes, 2000).astype(np.int32)
        wl = rng.integers(0, W + 1, 2000).astype(np.int32)
        s[:16], t[:16] = np.repeat(np.arange(4), 4), np.tile(np.arange(4), 4)
    else:
        g, idx = built
        lane, W = int(store.split("-")[1]), g.num_levels
        s, t, wl = random_queries(g, 2000, seed=lane + 2)
    eng = DeviceQueryEngine(idx, lane=lane, dispatch="bucket_pair",
                            device=card)
    plan = plan_query_batch(eng._bucket_of, s, t)
    if store != "built-128":
        assert len(plan) > 1
    for sub in plan:
        stq = torch.from_numpy(stage_sub_batch(eng._slot_of, sub.positions,
                                               s, t, wl)).to(card)
        tiles = eng._tiles[sub.bucket_s] + eng._tiles[sub.bucket_t]
        a = kseg.wcsd_query_segmented_cuda(*tiles, stq[0], stq[1], stq[2])
        b = kseg.wcsd_query_segmented_plain(*tiles, stq[0], stq[1], stq[2])
        assert torch.equal(a, b)
        a = kseg.wcsd_profile_segmented_cuda(*tiles, stq[0], stq[1], W)
        b = kseg.wcsd_profile_segmented_plain(*tiles, stq[0], stq[1], W)
        assert torch.equal(a, b)
    if store == "skewed":
        assert int(eng.packed.bucket_widths.max()) > 2048
        ref = DeviceQueryEngine(idx, lane=lane, device="cpu")
        np.testing.assert_array_equal(eng.query(s, t, wl),
                                      ref.query(s, t, wl))
        np.testing.assert_array_equal(eng.query_profile(s, t),
                                      ref.query_profile(s, t))


def test_compressed_and_bucket_pair_servers_on_card(card, built):
    """Both new serving modes on the card: one K5/K6 launch per dispatch,
    one K7 launch per scalar flush and one K8 launch per profile flush,
    answers equal to the ragged server's on the CPU."""
    g, idx = built
    s, t, wl = random_queries(g, 3000, seed=9)
    ref = WCSDServer(idx, max_batch=1024, device="cpu")
    exp, exp_p = ref.query_many(s, t, wl), ref.query_profile_many(s, t)
    _cuda.reset_launch_counts()
    srv = WCSDServer(idx, max_batch=1024, compressed=True, device=card)
    assert srv.engine.compressed is True
    np.testing.assert_array_equal(srv.query_many(s, t, wl), exp)
    np.testing.assert_array_equal(srv.query_profile_many(s, t), exp_p)
    assert _cuda.LAUNCHES["wcsd_query_ragged_compressed"] == 3
    assert _cuda.LAUNCHES["wcsd_profile_ragged_compressed"] == 3
    assert _cuda.LAUNCHES["wcsd_query_ragged"] == 0
    bp = DeviceQueryEngine(idx, dispatch="bucket_pair", device=card)
    _cuda.reset_launch_counts()
    np.testing.assert_array_equal(bp.query(s, t, wl), exp)
    np.testing.assert_array_equal(bp.query_profile(s, t), exp_p)
    assert _cuda.LAUNCHES["wcsd_query_segmented"] == 1   # one per flush
    assert _cuda.LAUNCHES["wcsd_profile_segmented"] == 1


@pytest.mark.parametrize("B,L", [(1, 7), (5, 130), (64, 256), (33, 2500),
                                 (0, 128)])
def test_gathered_kernel_equals_plain(card, B, L):
    """K9 against its plain version: any B (0 launches nothing) and any L,
    past one shared-memory chunk; unsorted hubs, -2 t-side pads."""
    rng = np.random.default_rng(B + L)
    hs = rng.integers(-1, 60, (B, L)).astype(np.int32)
    ht = rng.integers(-2, 60, (B, L)).astype(np.int32)
    ds = np.where(rng.random((B, L)) < 0.2, 1 << 29,
                  rng.integers(0, 100, (B, L))).astype(np.int32)
    dt = rng.integers(0, 1 << 29, (B, L)).astype(np.int32)
    x = [torch.from_numpy(a).to(card) for a in (hs, ds, ht, dt)]
    _cuda.reset_launch_counts()
    a = kwq.wcsd_query_gathered_cuda(*x)
    assert _cuda.LAUNCHES["wcsd_query_gathered"] == (1 if B else 0)
    assert torch.equal(a, kwq.wcsd_query_gathered_plain(*x))


@pytest.mark.parametrize("L", [130, 1792, 2500])
@pytest.mark.parametrize("case", ROW_CASES)
def test_gathered_merge_join_takes_any_rows(card, case, L):
    """K9 against its plain version on store-shaped rows (the merge join)
    and on rows it must join all-pairs inside the kernel (a feasible pad
    on both sides, a pad mid-row, a descending pair), rows of no real cell;
    L = 130 (rows not 16-byte aligned), 1,792 (the V = 2^17 store) and
    2,500 (past the shared-memory stage: read in place)."""
    rng = np.random.default_rng(L + ROW_CASES.index(case))
    x = [torch.from_numpy(a).to(card)
         for a in gathered_rows(rng, 96, L, case)]
    _cuda.reset_launch_counts()
    got = kwq.wcsd_query_gathered_cuda(*x)
    assert _cuda.LAUNCHES["wcsd_query_gathered"] == 1
    assert torch.equal(got, kwq.wcsd_query_gathered_plain(*x))


@pytest.mark.parametrize("num_levels", [0, 4, 31])
@pytest.mark.parametrize("lane", [128, 48, 1024])
@pytest.mark.parametrize("case", ROW_CASES)
def test_profile_merge_kernel_takes_any_tiles(card, case, lane, num_levels):
    """K2 (a warp per work item) against its plain version on tiles of
    every row case, num_levels + 1 of 1, 5 and 32 bins (a tenth of the
    real cells one level past the last), lanes 128, 48 and 1,024 (one warp
    a block), the worklist in shuffled order with trash-row pads."""
    rng = np.random.default_rng(lane * 100 + num_levels
                                + ROW_CASES.index(case))
    T, Q = 120, 200
    hub, dist, wlev = label_rows(rng, T, lane, case, top_level=num_levels)
    past = (hub >= 0) & (rng.random(hub.shape) < 0.1)
    wlev = np.where(past, num_levels + 1, wlev).astype(np.int32)
    lo, hi = tile_spans(hub, wlev)
    q, st, tt, _ = ragged_items(rng, Q, T, length=4 * Q + 40)
    perm = rng.permutation(len(q))
    arena = [torch.from_numpy(a).to(card) for a in (hub, dist, wlev, lo, hi)]
    items = [torch.from_numpy(a[perm]).to(card) for a in (q, st, tt)]
    _cuda.reset_launch_counts()
    got = kwq.wcsd_profile_ragged_cuda(*arena, *items, Q + 1, num_levels)
    assert _cuda.LAUNCHES["wcsd_profile_ragged"] == 1
    exp = kwq.wcsd_profile_ragged_plain(*arena[:3], *items, Q + 1,
                                        num_levels)
    assert torch.equal(got, exp)
    assert case == "pads-only" or (exp[:Q] < kwq.DEV_INF).any()


@pytest.mark.parametrize("lane", [128, 48, 1024])
@pytest.mark.parametrize("case", ROW_CASES)
def test_query_merge_kernel_takes_any_tiles(card, case, lane):
    """K1 (a warp per work item) against its plain version on tiles of
    every row case at lanes 128, 48 and 1,024 (two warps a block), the
    worklist in shuffled order with its pads on the trash row at
    TRASH_LEVEL, query levels from 0 to one above every cell: a live pad
    sends its item to the all-pairs branch only at levels it reaches."""
    rng = np.random.default_rng(lane * 100 + ROW_CASES.index(case) + 7)
    T, Q, top = 120, 200, 4
    hub, dist, wlev = label_rows(rng, T, lane, case, top_level=top)
    lo, hi = tile_spans(hub, wlev)
    q, st, tt, _ = ragged_items(rng, Q, T, length=4 * Q + 40)
    wq = np.concatenate([rng.integers(0, top + 2, Q),
                         [TRASH_LEVEL]]).astype(np.int32)
    perm = rng.permutation(len(q))
    arena = [torch.from_numpy(a).to(card) for a in (hub, dist, wlev, lo, hi)]
    items = [torch.from_numpy(a[perm]).to(card) for a in (q, st, tt)]
    w = torch.from_numpy(wq).to(card)
    _cuda.reset_launch_counts()
    got = kwq.wcsd_query_ragged_cuda(*arena, *items, w)
    assert _cuda.LAUNCHES["wcsd_query_ragged"] == 1
    exp = kwq.wcsd_query_ragged_plain(*arena[:3], *items, w)
    assert torch.equal(got, exp)
    assert case == "pads-only" or (exp[:Q] < kwq.DEV_INF).any()


@pytest.mark.parametrize("V,D", [(1, 1), (100, 7), (513, 33), (300, 1100)])
def test_frontier_relax_kernel_equals_plain(card, V, D):
    rng = np.random.default_rng(V + D)
    fw = rng.integers(-1, 7, (V, D)).astype(np.int32)
    lvl = np.where(rng.random((V, D)) < 0.5, -1,
                   rng.integers(0, 6, (V, D))).astype(np.int32)
    R = rng.integers(-1, 7, V).astype(np.int32)
    x = [torch.from_numpy(a).to(card) for a in (fw, lvl, R)]
    _cuda.reset_launch_counts()
    a = kfr.frontier_relax_gathered_cuda(*x)
    assert _cuda.LAUNCHES["frontier_relax_gathered"] == 1
    b = kfr.frontier_relax_gathered_plain(*x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_padded_server_and_ladder_on_card(card, built):
    """The padded layout on the card (one K9 launch per scalar dispatch,
    plain profiles) and the ladder's rungs from the compressed primary
    down to the plain oracle, each equal to the CPU ragged server."""
    from repro_torch.checkpoint.fault import FaultSchedule, FaultyEngine
    g, idx = built
    s, t, wl = random_queries(g, 3000, seed=10)
    ref = WCSDServer(idx, max_batch=1024, device="cpu")
    exp, exp_p = ref.query_many(s, t, wl), ref.query_profile_many(s, t)
    _cuda.reset_launch_counts()
    srv = WCSDServer(idx, max_batch=1024, layout="padded", device=card)
    np.testing.assert_array_equal(srv.query_many(s, t, wl), exp)
    np.testing.assert_array_equal(srv.query_profile_many(s, t), exp_p)
    assert _cuda.LAUNCHES["wcsd_query_gathered"] == 3
    assert sum(_cuda.LAUNCHES.values()) == 3
    sched = FaultSchedule(fixed={k: "engine_raise" for k in range(6)})
    lad = WCSDServer(idx, max_batch=4096, compressed=True, max_retries=1,
                     backoff_base_ms=0.01, flush_timeout_ms=10000.0,
                     engine_wrapper=lambda e: FaultyEngine(e, sched),
                     device=card)
    np.testing.assert_array_equal(lad.query_many(s, t, wl), exp)
    assert lad.mode == "oracle" and lad.stats.demotions == 3
    np.testing.assert_array_equal(lad.query_profile_many(s, t), exp_p)


@pytest.mark.parametrize("B,H,M,D,K", [(8, 16, 8, 4, 8), (20, 13, 7, 6, 11),
                                       (4, 200, 39, 10, 200),
                                       (700, 200, 39, 10, 200)])
def test_cin_kernel_equals_plain(card, B, H, M, D, K):
    """K11 against its plain version on unit-normal inputs, at the
    reference test's shapes (tolerance: `tests/test_kernels.py`'s, for
    fp32 sums of H*M terms in another order) and at B = 700, whose
    B*D = 7,000 rows end in a ragged 64-row tile. K = 8 and 11 go to the
    narrow kernel, K = 200 to the wide one."""
    from repro_torch.kernels import cin_fuse as kcin
    rng = np.random.default_rng(B)
    x = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card)
         for s in ((B, H, D), (B, M, D), (K, H, M))]
    _cuda.reset_launch_counts()
    got = kcin.cin_layer_cuda(*x)
    kind = "cin_layer_narrow" if K <= 64 else "cin_layer"
    assert _cuda.LAUNCHES[kind] == 1 and sum(_cuda.LAUNCHES.values()) == 1
    exp = kcin.cin_layer_plain(*x)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=1e-4, atol=1e-5 * H * M ** 0.5)


@pytest.mark.parametrize("B", [4, 96, 512, 65536, 262144, 1_000_000])
def test_cin_scratch_plan_without_card_equals_card(card, B):
    """The scratch a meta-tensor count allocates for K11 and K12
    (`cin_scratch`, `cin_grad_scratch` planned for an H100) equals what
    the CUDA wrappers allocate on this card, at the xDeepFM cells'
    batches and widths (M = 39, D = 10; H and K of 39 and 200)."""
    from repro_torch.kernels import cin_fuse as kcin
    if torch.cuda.get_device_properties(card).multi_processor_count \
            != kcin.H100_SMS:
        pytest.skip("the plan without a card is an H100's")
    meta = torch.device("meta")
    for H in (39, 200):
        for K in (39, 200):
            args = (B, H, 39, 10, K)
            assert kcin.cin_scratch(meta, *args, False) == \
                kcin.cin_scratch(card, *args, False), args
            assert kcin.cin_grad_scratch(meta, *args) == \
                kcin.cin_grad_scratch(card, *args), args


def test_cin_kernel_bf16_equals_plain(card):
    """bf16 inputs: K11 and the plain version both widen to fp32 before
    any product, so they differ only in summation order (the fp32
    tolerance); against the fp32 inputs, `test_cin_kernel_bf16`'s."""
    from repro_torch.kernels import cin_fuse as kcin
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card)
         for s in ((8, 16, 8), (8, 8, 8), (16, 16, 8))]
    xb = [a.to(torch.bfloat16) for a in x]
    got = kcin.cin_layer_cuda(*xb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(),
                               kcin.cin_layer_plain(*xb).cpu().numpy(),
                               rtol=1e-4, atol=1e-5 * 16 * 8 ** 0.5)
    np.testing.assert_allclose(got.cpu().numpy(),
                               kcin.cin_layer_plain(*x).cpu().numpy(),
                               rtol=5e-2, atol=0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,M,D,K", [(512, 200, 39, 10, 200),
                                       (512, 39, 39, 10, 200),
                                       (300, 30, 7, 10, 50)])
def test_cin_tensor_core_kernel_at_serve_shapes(card, B, H, M, D, K, dtype):
    """The 3xTF32 K11 at the model's serve_p99 layer shapes (split over
    the r axis: the tile grid is under the SM count) and at a ragged R =
    210 (M = 7, not a multiple of 8 or 4), both dtypes, within the fp32
    tolerance of `test_cin_kernel_equals_plain`; two launches on the same
    inputs are bit-identical (the split partials are summed in order).
    K = 50 in float32 goes to the narrow kernel, in bfloat16 to the wide
    one."""
    from repro_torch.kernels import cin_fuse as kcin
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(B + H + M)
    x = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        card).to(getattr(torch, dtype))
         for s in ((B, H, D), (B, M, D), (K, H, M))]
    _cuda.reset_launch_counts()
    got = kcin.cin_layer_cuda(*x)
    again = kcin.cin_layer_cuda(*x)
    kind = "cin_layer_narrow" if kcin.cin_narrow(K, x[0].dtype) \
        else "cin_layer"
    assert _cuda.LAUNCHES[kind] == 2 and sum(_cuda.LAUNCHES.values()) == 2
    exp = kcin.cin_layer_plain(*x)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=1e-4, atol=1e-5 * H * M ** 0.5)


@pytest.mark.parametrize("B", [1, 37, 512, 2048])
@pytest.mark.parametrize("M", [7, 39, 148, 149, 200])
@pytest.mark.parametrize("K", [1, 8, 39, 40, 64])
def test_cin_narrow_kernel_equals_plain(card, K, M, B):
    """K11's narrow kernel (float32, K <= 64: the CIN backward's dx0 and
    the first layer's dx1) against its plain version at H = 200 (the
    backward's H' = K of the 200-wide layers), D = 10: every K of one to
    eight 8-column groups, M up to the 200-wide layers' (past the wide
    kernel's CIN_MAX_M = 148: one call), B from one row to a ragged last
    block; within 1e-4 of max |ref| (3xTF32, as the wide kernel), two
    launches bit-identical, one narrow launch a call and no other."""
    from repro_torch.kernels import cin_fuse as kcin
    torch.backends.cuda.matmul.allow_tf32 = False
    H, D = 200, 10
    rng = np.random.default_rng(K * 1000 + M + B)
    x1, x0, w = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(card) for s in ((B, H, D), (B, M, D), (K, H, M)))
    w = w * 0.05
    _cuda.reset_launch_counts()
    got = kcin.cin_layer_cuda(x1, x0, w)
    again = kcin.cin_layer_cuda(x1, x0, w)
    assert _cuda.LAUNCHES["cin_layer_narrow"] == 2
    assert sum(_cuda.LAUNCHES.values()) == 2
    exp = kcin.cin_layer_plain(x1, x0, w)
    torch.cuda.synchronize()
    assert got.shape == (B, K, D) and torch.equal(got, again)
    assert _rel(got, exp) <= 1e-4


def test_xdeepfm_forward_on_card(card):
    """One forward of the full CIN and MLP widths (cut vocabulary) on the
    card: 3 K11 launches and nothing else; `cin_feat` per layer within
    1e-4 of its max and the logits within 1e-5 of theirs, against the
    same weights on the CPU."""
    from repro_torch.data.recsys import CTRStream
    from repro_torch.models.xdeepfm import XDeepFM, XDeepFMConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = XDeepFMConfig("xdeepfm-narrow-vocab", big_vocab=64, small_vocab=16)
    m_card = XDeepFM(cfg, device=card, seed=0)
    m_cpu = XDeepFM(cfg, device="cpu", seed=0)
    m_cpu.load_state_dict({k: v.cpu() for k, v in
                           m_card.state_dict().items()})
    ids = CTRStream(cfg.field_vocabs, cfg.field_offsets, 64,
                    seed=0).next_batch()["ids"]
    _cuda.reset_launch_counts()
    with torch.inference_mode():
        lg, cf = m_card(ids, return_cin=True)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["cin_layer"] == 3
        assert sum(_cuda.LAUNCHES.values()) == 3
        lc, cc = m_cpu(ids, return_cin=True)
    a = 0
    for k in cfg.cin_layers:
        e = cc[:, a:a + k]
        assert (cf[:, a:a + k].cpu() - e).abs().max() <= 1e-4 * e.abs().max()
        a += k
    assert (lg.cpu() - lc).abs().max() <= 1e-5 * lc.abs().max()


def _dynamic_pair(g, device, updates):
    """A dynamic server over ``g`` on ``device`` after ``updates`` (lists
    of (inserts, deletes)); no auto compaction."""
    idx, _ = build_wc_index_batched_packed(g, device="cpu")
    srv = WCSDServer(idx, graph=g, max_batch=1024, compact_threshold=None,
                     device=device)
    for ins, dels in updates:
        srv.apply_updates(ins, dels)
    return srv


def _updates(g):
    mid = float(g.levels[g.num_levels // 2])
    e = int(np.flatnonzero(g.edges_src < g.edges_dst)[7])
    return [([(3, g.num_nodes - 5, mid)], [(int(g.edges_src[e]),
                                            int(g.edges_dst[e]))]),
            ([(11, g.num_nodes // 2, mid)], [(0, int(g.nbr[0]))])]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("lane", [128, 48])
def test_ragged_kernels_on_delta_extended_arena(card, shuffle, lane):
    """K1 and K2 against their plain versions on a dynamic index's arena
    (the base tiles, then the delta region of corrected rows), on a
    worklist that reaches delta tiles; with ``shuffle`` every delta
    tile's cells are shuffled too (the merge check refuses them)."""
    g = scale_free(400, m=4, num_levels=4, seed=0)
    srv = _dynamic_pair(g, card, _updates(g))
    eng = DeviceQueryEngine(srv.index, lane=lane, device=card)
    T0 = srv.index.base.labels.arena(lane=lane).num_tiles
    assert eng.arena.num_tiles > T0            # a delta region exists
    s, t, wl = random_queries(g, 2000, seed=lane)
    st, q, si, ti = _worklist(eng, s, t, wl)
    assert ((si >= T0) | (ti >= T0)).any()
    hub, dist, wlev, lo, hi = eng._arena[:5]
    if shuffle:
        gen = torch.Generator(device=card).manual_seed(lane)
        perm = torch.rand(hub[T0:].shape, generator=gen,
                          device=card).argsort(dim=1)
        hub, dist, wlev = (torch.cat([a[:T0], a[T0:].gather(1, perm)])
                           for a in (hub, dist, wlev))
    wq = torch.cat([st[2], torch.tensor([TRASH_LEVEL], dtype=torch.int32,
                                        device=card)])
    a = kwq.wcsd_query_ragged_cuda(hub, dist, wlev, lo, hi, q, si, ti, wq)
    b = kwq.wcsd_query_ragged_plain(hub, dist, wlev, q, si, ti, wq)
    assert torch.equal(a, b)
    rows = st.shape[1] + 1
    a = kwq.wcsd_profile_ragged_cuda(hub, dist, wlev, lo, hi, q, si, ti,
                                     rows, g.num_levels)
    b = kwq.wcsd_profile_ragged_plain(hub, dist, wlev, q, si, ti, rows,
                                      g.num_levels)
    assert torch.equal(a, b)


def test_dynamic_server_on_card_equals_cpu(card):
    """The dynamic server on the card equals the same server on the CPU
    through two updates (one K1 / K2 launch a flush over the
    delta-extended arena) and a `compact()` (K3 / K4 on the card, a base
    byte-identical to the CPU's compaction)."""
    g = scale_free(400, m=4, num_levels=4, seed=0)
    ups = _updates(g)
    gpu = _dynamic_pair(g, card, [])
    cpu = _dynamic_pair(g, "cpu", [])
    s, t, wl = random_queries(g, 3000, seed=4)
    for ins, dels in ups:
        assert gpu.apply_updates(ins, dels) == cpu.apply_updates(ins, dels)
        _cuda.reset_launch_counts()
        b0 = gpu.stats.batches
        got = gpu.query_many(s, t, wl)
        b1 = gpu.stats.batches
        gp = gpu.query_profile_many(s[:500], t[:500])
        assert _cuda.LAUNCHES["wcsd_query_ragged"] == b1 - b0 > 1
        assert _cuda.LAUNCHES["wcsd_profile_ragged"] == \
            gpu.stats.batches - b1 == 1
        np.testing.assert_array_equal(got, cpu.query_many(s, t, wl))
        np.testing.assert_array_equal(
            gp, cpu.query_profile_many(s[:500], t[:500]))
    _cuda.reset_launch_counts()
    gpu.compact()
    assert _cuda.LAUNCHES["wc_prune_emit_batched"] > 0
    cpu.compact()
    for name in PACKED:
        np.testing.assert_array_equal(getattr(gpu.index.base.labels, name),
                                      getattr(cpu.index.base.labels, name))
    np.testing.assert_array_equal(gpu.query_many(s, t, wl),
                                  cpu.query_many(s, t, wl))


# ------------------------------------------------- the sharded engine
SHARD_LEGS = [  # layout, dispatch, compressed, device_budget_bytes, 2x4
    ("csr", "ragged", False, None, False), ("csr", "ragged", False, 1, False),
    ("csr", "ragged", False, None, True), ("csr", "ragged", False, 1, True),
    ("csr", "ragged", True, None, False), ("csr", "ragged", True, 1, False),
    ("csr", "bucket_pair", False, None, False),
    ("csr", "bucket_pair", False, 1, False),
    ("padded", "ragged", False, None, False),
    ("padded", "ragged", False, 1, False)]


@pytest.mark.parametrize("leg", SHARD_LEGS,
                         ids=lambda x: "-".join(map(str, x)))
def test_sharded_engine_on_card_equals_device_engine(card, built, leg):
    """An 8-shard mesh on the card answers as `DeviceQueryEngine` on the
    card in every placement, and every call launches its kernel once per
    shard (the padded layout's profiles are the plain join: none)."""
    from repro_torch.core.query import ShardedQueryEngine
    from repro_torch.launch.mesh import make_serving_mesh
    layout, dispatch, compressed, budget, multi_pod = leg
    g, idx = built
    s, t, wl = random_queries(g, 3000, seed=5)
    ps, pt, _ = random_queries(g, 500, seed=6)
    dev = DeviceQueryEngine(idx, layout=layout, dispatch=dispatch,
                            compressed=compressed, device=card)
    exp, prof = dev.query(s, t, wl), dev.query_profile(ps, pt)
    mesh = make_serving_mesh([card] * 8, multi_pod=multi_pod)
    eng = ShardedQueryEngine(idx, mesh=mesh, layout=layout,
                             dispatch=dispatch, compressed=compressed,
                             device_budget_bytes=budget)
    assert eng.compressed == compressed and eng.ndev == 8
    assert eng.mode == ("replicated" if budget is None else "sharded_labels")
    kernels = {("csr", "ragged", False): ("wcsd_query_ragged",
                                          "wcsd_profile_ragged"),
               ("csr", "ragged", True): ("wcsd_query_ragged_compressed",
                                         "wcsd_profile_ragged_compressed"),
               ("csr", "bucket_pair", False): ("wcsd_query_segmented",
                                               "wcsd_profile_segmented"),
               ("padded", "dense", False): ("wcsd_query_gathered", None)}[
        (eng.layout, eng.dispatch, compressed)]
    for (kind, call, want_out), kernel in zip(
            (("query", lambda: eng.query_async(s, t, wl), exp),
             ("profile", lambda: eng.query_profile_async(ps, pt), prof)),
            kernels):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        handle = call()
        launched = {k: n for k, n in _cuda.LAUNCHES.items() if n}
        got = handle.wait()
        assert handle.ready()
        np.testing.assert_array_equal(got, want_out, err_msg=kind)
        assert launched == ({} if kernel is None else {kernel: 8}), \
            (kind, launched)


def test_row_sharded_shard_kernels_equal_plain(card, built):
    """One row-sharded shard's K1 and K2 over its gathered tiles, on the
    engine's own launch arguments (`_shard_launch_args`: the worklist
    relabelled into the gather buffer), equal their plain versions
    exactly."""
    from repro_torch.core.query import ShardedQueryEngine
    from repro_torch.launch.mesh import make_serving_mesh
    g, idx = built
    eng = ShardedQueryEngine(idx, mesh=make_serving_mesh([card] * 8),
                             device_budget_bytes=1)
    s, t, wl = random_queries(g, 2000, seed=9)
    fl = eng._row_sharded_flush(eng._stage_ragged(s, t, wl))
    for k in (0, 7):
        (h, d, w, lo, hi, qidx, sloc, tloc, _), wq = \
            eng._shard_launch_args(fl, k)
        assert torch.equal(
            kwq.wcsd_query_ragged_cuda(h, d, w, lo, hi, qidx, sloc, tloc,
                                       wq),
            kwq.wcsd_query_ragged_plain(h, d, w, qidx, sloc, tloc, wq))
    fl = eng._row_sharded_flush(eng._stage_ragged(s[:500], t[:500]))
    rows, L = fl.stq.shape[1] // 8 + 1, eng.num_levels
    for k in (0, 7):
        (h, d, w, lo, hi, qidx, sloc, tloc, _), wq = \
            eng._shard_launch_args(fl, k)
        assert wq is None
        assert torch.equal(
            kwq.wcsd_profile_ragged_cuda(h, d, w, lo, hi, qidx, sloc, tloc,
                                         rows, L),
            kwq.wcsd_profile_ragged_plain(h, d, w, qidx, sloc, tloc, rows,
                                          L))


def test_sharded_server_on_card_serves_the_dry_run(card):
    """`launch.dryrun.run_serve` (quick) on 8 shards of the card."""
    from repro_torch.launch.dryrun import run_serve
    run_serve(quick=True, device=card)


@pytest.mark.parametrize("leg", SHARD_LEGS,
                         ids=lambda x: "-".join(map(str, x)))
def test_sharded_engine_over_several_cards(card, built, leg):
    """A mesh over every visible card (and 2 shards a card, and a 2 x n/2
    pod mesh where the count is even): each shard's blocks live on its
    own card, its launches run there, and the answers equal
    `DeviceQueryEngine` on card 0. Skips with fewer than two cards."""
    from repro_torch.core.query import ShardedQueryEngine
    from repro_torch.launch.mesh import make_serving_mesh
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    layout, dispatch, compressed, budget, multi_pod = leg
    cards = [torch.device("cuda", i) for i in range(n)]
    g, idx = built
    s, t, wl = random_queries(g, 3000, seed=15)
    ps, pt, _ = random_queries(g, 500, seed=16)
    dev = DeviceQueryEngine(idx, layout=layout, dispatch=dispatch,
                            compressed=compressed, device=cards[0])
    exp, prof = dev.query(s, t, wl), dev.query_profile(ps, pt)
    meshes = [make_serving_mesh(cards * 2)]
    if multi_pod and n % 2 == 0:
        meshes.append(make_serving_mesh(cards, multi_pod=True))
    elif not multi_pod:
        meshes.append(make_serving_mesh())
    for mesh in meshes:
        eng = ShardedQueryEngine(idx, mesh=mesh, layout=layout,
                                 dispatch=dispatch, compressed=compressed,
                                 device_budget_bytes=budget)
        assert len(eng.mesh.physical_devices()) == n
        if eng.mode == "sharded_labels":     # hub blocks, shard by shard
            hub = (eng._tiles[0][0][0] if eng.dispatch == "bucket_pair"
                   else eng._blocks[0])
            assert [b.device for b in hub] == list(mesh.devices)
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        h = eng.query_async(s, t, wl)
        np.testing.assert_array_equal(h.wait(), exp)
        assert h.ready()
        np.testing.assert_array_equal(eng.query_profile(ps, pt), prof)
        assert max(_cuda.LAUNCHES.values()) == mesh.size


def test_sharded_server_over_several_cards(card, built):
    """`WCSDServer(backend="sharded")` over every visible card equals the
    device server, replicated and row-sharded, with the single-device
    rungs on the server's device. Skips with fewer than two cards."""
    from repro_torch.launch.mesh import make_serving_mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    g, idx = built
    s, t, wl = random_queries(g, 5000, seed=17)
    ps, pt, _ = random_queries(g, 800, seed=18)
    ref = WCSDServer(idx, max_batch=1024, device=card)
    exp, prof = ref.query_many(s, t, wl), ref.query_profile_many(ps, pt)
    for budget in (None, 1):
        srv = WCSDServer(idx, max_batch=1024, backend="sharded",
                         mesh=make_serving_mesh(), device_budget_bytes=budget)
        assert srv.device == torch.device("cuda", 0)
        np.testing.assert_array_equal(srv.query_many(s, t, wl), exp)
        np.testing.assert_array_equal(srv.query_profile_many(ps, pt), prof)


# --------------------------------------------------------- training (K12)
def _cin_grad_inputs(card, B, H, M, D, K, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        card) for s in ((B, K, D), (B, H, D), (B, M, D))]


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


@pytest.mark.parametrize("B,H,M,D,K", [(512, 39, 39, 10, 200),
                                       (512, 200, 39, 10, 200),
                                       (2048, 200, 39, 10, 200),
                                       (37, 200, 39, 10, 200),
                                       (700, 39, 39, 10, 200),
                                       (5, 13, 7, 3, 11), (1, 1, 1, 1, 1),
                                       (65536, 39, 39, 10, 200),
                                       (64, 3, 150, 10, 300),
                                       (33, 150, 1, 10, 8)])
def test_cin_weight_grad_kernel_equals_plain(card, B, H, M, D, K):
    """K12 (3xTF32 on wgmma) against its plain version on the card, at
    the shapes of the model's three layers (2,048 rows: the contraction
    in `cin_grad_plan`'s slices), the first layer at train_batch (B =
    65,536: 11 slices), odd B and odd widths (M > 128 and K > 200: an x0
    range that wraps inside a 128-row tile, two column blocks; M = 1: 128
    x1 channels a tile), within 1e-4 of max |ref| (fp32 sums of B*D terms
    in another order); one launch a call, two launches bit-identical."""
    from repro_torch.kernels import cin_fuse as kcin
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _cin_grad_inputs(card, B, H, M, D, K, B + H)
    _cuda.reset_launch_counts()
    got = kcin.cin_weight_grad_cuda(*x)
    again = kcin.cin_weight_grad_cuda(*x)
    assert _cuda.LAUNCHES["cin_weight_grad"] == 2
    exp = kcin.cin_weight_grad_plain(*x)
    torch.cuda.synchronize()
    assert got.shape == (K, H, M) and torch.equal(got, again)
    assert _rel(got, exp) <= 1e-4


@pytest.mark.parametrize("H", [39, 200])
def test_cin_backward_on_card_equals_plain(card, H, monkeypatch):
    """A CIN layer's three gradients on the card (K11 for dx1 and dx0, dx0
    one call to the narrow kernel at either H, dx1 narrow at H = 39 and
    wide at H = 200; K12 for dw) against the same backward through the
    plain versions on the card, within 1e-4 of max |ref|; the launches
    are as planned."""
    from repro_torch.kernels import ops as kops
    torch.backends.cuda.matmul.allow_tf32 = False
    B, M, D, K = 512, 39, 10, 200
    g, x1, x0 = _cin_grad_inputs(card, B, H, M, D, K, H)
    w = torch.randn((K, H, M), generator=torch.Generator(card).manual_seed(
        1), device=card) * 0.05

    def grads():
        ts = [t.clone().requires_grad_() for t in (x1, x0, w)]
        return torch.autograd.grad(kops.cin_layer(*ts), ts, g)

    _cuda.reset_launch_counts()
    got = grads()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["cin_layer"] == 1 + (H > 64)
    assert _cuda.LAUNCHES["cin_layer_narrow"] == 1 + (H <= 64)
    assert _cuda.LAUNCHES["cin_weight_grad"] == 1
    again = grads()
    monkeypatch.setattr(kops, "_on_card", lambda x, what: False)
    exp = grads()
    for name, a, b, c in zip(("dx1", "dx0", "dw"), got, again, exp):
        assert torch.equal(a, b), name
        assert _rel(a, c) <= 1e-4, name


def test_xdeepfm_train_step_on_card_equals_plain(card, monkeypatch):
    """One train step's loss and every gradient leaf at the full CIN and
    MLP widths (cut vocabulary), B = 256: the card's kernels against the
    plain versions on the card, within 1e-4 of each leaf's max; the
    gradient is bit-identical across two runs. K11 launches 9 times: the
    wide kernel for the 3 forward calls and the 2 dx1 of the 200-wide
    layers, the narrow one for the 3 dx0 and the first layer's dx1."""
    from repro_torch.configs import xdeepfm_arch as arch
    from repro_torch.data.recsys import CTRStream
    from repro_torch.kernels import ops as kops
    from repro_torch.models import xdeepfm as X
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.tree import flatten_with_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = X.XDeepFMConfig("xdeepfm-narrow-vocab", big_vocab=64,
                          small_vocab=16)
    params = X.param_tree(X.XDeepFM(cfg, device=card, seed=0))
    batch = CTRStream(cfg.field_vocabs, cfg.field_offsets, 256,
                      seed=0).next_batch()
    vg = value_and_grad(lambda p, b: X.loss_fn(p, cfg, b))
    _cuda.reset_launch_counts()
    loss, grads = vg(params, batch)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["cin_layer"] == 3 + 2
    assert _cuda.LAUNCHES["cin_layer_narrow"] == 4
    assert _cuda.LAUNCHES["cin_weight_grad"] == 3
    _, again = vg(params, batch)
    monkeypatch.setattr(kops, "_on_card", lambda x, what: False)
    loss_p, plain = vg(params, batch)
    assert abs(float(loss) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    a, b, c = (flatten_with_paths(t) for t in (grads, again, plain))
    for k in c:
        assert torch.equal(a[k], b[k]), k
        if c[k].abs().max() > 0:
            assert _rel(a[k], c[k]) <= 1e-4, k
    assert arch.train_flops(cfg, 256) > 0


# ------------------------------------------------- the GNN family on the card
def _tree_on(tree, device):
    from repro_torch.train.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


@pytest.mark.parametrize("op", ["sum", "max", "min", "gather"])
def test_segment_ops_on_card_bit_identical_and_equal_cpu(card, op):
    """The segment backend on the card (a long segment split in runs
    included): values, the gradient and the gradient of a gradient
    bit-identical across two runs (no float atomics) and within 1e-5 of
    the CPU's."""
    from repro_torch.models import common as C
    rng = np.random.default_rng(0)
    ids = np.concatenate([rng.integers(0, 300, 20_000),
                          np.full(30_000, 299)])     # a sink-like segment
    x = rng.standard_normal((len(ids), 6)).astype(np.float32)
    w = rng.standard_normal((300, 6)).astype(np.float32)

    def run(device):
        plan = C.SegmentPlan(torch.from_numpy(ids).to(device), 300)
        if op == "gather":
            xt = torch.from_numpy(w).to(device).requires_grad_(True)
            y = C.segment_gather(xt, plan)
            f = (torch.from_numpy(x).to(device) * y * y).sum()
        else:
            xt = torch.from_numpy(x).to(device).requires_grad_(True)
            y = {"sum": C.segment_sum, "max": C.segment_max,
                 "min": C.segment_min}[op](xt, plan)
            f = (torch.from_numpy(w).to(device) * y * y).sum()
        (g,) = torch.autograd.grad(f, xt, create_graph=True)
        (h,) = torch.autograd.grad((g * g).sum(), xt)
        return [t.detach() for t in (y, g, h)]

    a, b, c = run(card), run(card), run("cpu")
    for ta, tb, tc in zip(a, b, c):
        assert torch.equal(ta, tb)
        assert _rel(ta.cpu(), tc) <= 1e-5


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "gatedgcn"])
def test_gnn_train_step_on_card_equals_cpu(card, arch):
    """Two AdamW steps at smoke width on a padded molecule cell batch:
    the loss and every updated parameter on the card within 1e-4 of the
    CPU's (TF32 off), bit-identical across two runs on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.models import common as C
    from repro_torch.models import gnn as G
    from repro_torch.train import optim as O
    from repro_torch.train.tree import flatten_with_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GC.shape_config(get_arch(arch).smoke_config(), "molecule")
    batch = GC.cell_batch("molecule", seed=0)
    step = GC.make_train_step_for(cfg, "molecule")
    p0 = C.param_tree(G.GNN(cfg, device="cpu", seed=0))

    def run(device):
        p = _tree_on(p0, device)
        o = O.init_opt_state(GC.TRAIN_OPT, p)
        for _ in range(2):       # the first step's warm-up rate is 0
            p, o, m = step(p, o, batch)
        return float(m["loss"]), flatten_with_paths(p)

    (la, pa), (lb, pb), (lc, pc) = run(card), run(card), run("cpu")
    assert la == lb and abs(la - lc) <= 1e-5 * abs(lc)
    for k in pc:
        assert torch.equal(pa[k], pb[k]), k
        assert _rel(pa[k].cpu(), pc[k]) <= 1e-4, k


def test_nequip_force_step_on_card_equals_cpu(card):
    """Two NequIP steps on the force loss (a second derivative through
    the segment backend) at smoke width on the molecule cell: the card's
    parameters within 1e-4 of the CPU's and bit-identical across runs."""
    from repro_torch.configs import get_arch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.models import common as C
    from repro_torch.models import nequip as NQ
    from repro_torch.train import optim as O
    from repro_torch.train.tree import flatten_with_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GC.shape_config(get_arch("nequip").smoke_config(), "molecule")
    batch = GC.cell_batch("molecule", seed=0)
    step = GC.make_train_step_for(cfg, "molecule")
    p0 = C.param_tree(NQ.NequIP(cfg, device="cpu", seed=0))

    def run(device):
        p = _tree_on(p0, device)
        o = O.init_opt_state(GC.TRAIN_OPT, p)
        for _ in range(2):       # the first step's warm-up rate is 0
            p, o, m = step(p, o, batch)
        return float(m["loss"]), flatten_with_paths(p)

    (la, pa), (lb, pb), (lc, pc) = run(card), run(card), run("cpu")
    assert la == lb and abs(la - lc) <= 1e-5 * abs(lc)
    for k in pc:
        assert torch.equal(pa[k], pb[k]), k
        assert _rel(pa[k].cpu(), pc[k]) <= 1e-4, k


def test_distance_encoding_on_card_equals_cpu(card):
    """The encodings through K1 on the card equal the engine's plain path
    on the CPU, one K1 launch a flush."""
    from repro_torch.data import graphs as DG
    g = scale_free(400, m=4, num_levels=4, seed=0)
    idx, _ = build_wc_index_batched_packed(g, device="cpu")
    nodes, lms = np.arange(400), np.array([0, 7, 99])
    _cuda.reset_launch_counts()
    a = DG.distance_encoding(idx, nodes, lms, [0, 1, 2, 3], device=card)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["wcsd_query_ragged"] == 1
    b = DG.distance_encoding(idx, nodes, lms, [0, 1, 2, 3], device="cpu")
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the LM family
def _lm(arch, compute_dtype="float32", **moe_kw):
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              compute_dtype=compute_dtype)
    if moe_kw and cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    return cfg


def _positions(got, ref, tol=1e-5, jump=3e-2):
    """Per-position errors of logits [..., V]: the median within ``tol``
    of max |ref|, every one within ``jump`` (attention rounds its operands
    to bf16, so a last-bit difference can move a position), greedy
    tokens all equal."""
    got, ref = got.double().cpu(), ref.double().cpu()
    per = (got - ref).abs().amax(-1).flatten() / ref.abs().max()
    assert float(per.median()) <= tol, per
    assert float(per.max()) <= jump, per
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "qwen2.5-14b"])
def test_lm_forward_on_card_equals_cpu(card, arch):
    """The smoke config's float32-compute forward on the card against the
    same weights on the CPU, TF32 off."""
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm(arch)
    model = T.LM(cfg, device="cpu", seed=0)
    batch = TokenStream(cfg.vocab, 32, 2, seed=0).next_batch()
    with torch.no_grad():
        ref, _ = T.forward(C.param_tree(model), cfg, batch["tokens"])
        got, _ = T.forward(C.param_tree(model.to(card)), cfg,
                           batch["tokens"])
    _positions(got, ref)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b"])
def test_lm_decode_on_card_equals_the_no_cache_forward(card, arch):
    """Prefill 24 tokens, 8 greedy decode steps on the card; each step's
    logits against the card's forward over the same tokens (float32
    compute; the MoE at capacity factor 8, where no token is dropped);
    the prefill re-runs bit for bit."""
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm(arch, capacity_factor=8.0)
    model = T.LM(cfg, device=card, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(0)).to(card)
    with torch.no_grad():
        n0, c0 = model.prefill(toks)
        n1, c1 = model.prefill(toks)
        assert torch.equal(n0, n1) and torch.equal(c0["k"], c1["k"]) \
            and torch.equal(c0["v"], c1["v"])
        cache = model.init_cache(2, 32)
        for k in ("k", "v"):
            cache[k][:, :, :24] = c0[k]
        nxt, fed, logits = n0, [], []
        for i in range(8):
            fed.append(nxt)
            nxt, lg, cache = model.decode(cache, nxt, 24 + i)
            logits.append(lg)
        full, _ = model(torch.cat([toks, torch.stack(fed, 1)], 1))
    _positions(torch.stack(logits, 1), full[:, 24:])


def test_lm_served_copy_routes_as_the_float32_masters(card):
    """A bf16 served copy (router and shared output gate float32) gives
    the float32 masters' bf16-compute numbers bit for bit on the card:
    the forward (router rounded to bf16, as the reference's forward
    casts it) and the decode (the float32 router, as the reference's
    decode reads it)."""
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    cfg = _lm("qwen2-moe-a2.7b", "bfloat16")
    masters = C.param_tree(T.LM(cfg, device=card, seed=0))
    served = C.param_tree(T.LM(cfg, device=card, seed=0,
                               dtype=torch.bfloat16))
    assert served["layers"]["router"].dtype == torch.float32
    assert served["layers"]["shared_out_gate"].dtype == torch.float32
    assert served["layers"]["w_up"].dtype == torch.bfloat16
    toks = torch.randint(0, cfg.vocab, (4, 16),
                         generator=torch.Generator().manual_seed(1)).to(card)
    with torch.no_grad():
        fa, _ = T.forward(masters, cfg, toks)
        fb, _ = T.forward(served, cfg, toks)
        assert torch.equal(fa, fb)
        na, ca = T.prefill_step(masters, cfg, toks)
        for k in ("k", "v"):
            ca[k] = torch.nn.functional.pad(ca[k], (0, 0, 0, 0, 0, 4))
        cb = {k: v.clone() for k, v in ca.items()}
        xa, la, _ = T.decode_step(masters, cfg, ca, na, 16)
        xb, lb, _ = T.decode_step(served, cfg, cb, na, 16)
    assert torch.equal(la, lb) and torch.equal(xa, xb)


def test_bf16_matmul_route_on_card_equals_the_upcast(card):
    """Attention's contraction on the card (one `torch.bmm` with a float32
    output from bf16 operands, strided like a cache) against the CPU's
    upcast route: float32 sums of the same exact products."""
    from repro_torch.models.attention import bf16_matmul_f32
    g = torch.Generator().manual_seed(2)
    a = torch.randn(8, 4, 128, generator=g).to(torch.bfloat16)
    k = torch.randn(4096, 8, 128, generator=g).to(torch.bfloat16)
    ref = bf16_matmul_f32(a, k.permute(1, 2, 0))
    with torch.no_grad():
        got = bf16_matmul_f32(a.to(card), k.to(card).permute(1, 2, 0))
    assert got.dtype == torch.float32
    assert _rel(got.cpu(), ref) <= 1e-6


# ------------------------------------------- the mesh-only parallel code
def _mesh(devices, **axes):
    from repro_torch.launch.mesh import make_serving_mesh
    return make_serving_mesh(devices, axes=axes or {"data": 1,
                                                    "model": len(devices)})


def _seeded_cache(cfg, B, S, mesh, seed=0):
    """A sequence-sharded cache filled with unit normals (bf16) from a
    CPU generator, and the same values whole on the CPU."""
    from repro_torch.models import transformer as T
    g = torch.Generator().manual_seed(seed)
    whole = {k: torch.randn((cfg.n_layers, B, S, cfg.n_kv_heads,
                             cfg.d_head), generator=g).to(torch.bfloat16)
             for k in ("k", "v")}
    cache = T.init_cache(cfg, B, S, mesh=mesh)
    n = mesh.size
    for k in ("k", "v"):
        for blk, part in zip(cache[k], torch.chunk(whole[k], n, dim=2)):
            blk.copy_(part)
    return cache, whole


def _decode(params, cfg, cache, toks, positions, mesh=None):
    from repro_torch.models import transformer as T
    out = []
    with torch.no_grad():
        for pos in positions:
            nxt, lg, cache = T.decode_step(params, cfg, cache, toks, pos,
                                           mesh=mesh)
            out.append(lg.cpu())
            toks = nxt
    return torch.stack(out)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b"])
def test_sharded_decode_on_card_equals_cpu_and_unsharded(card, arch):
    """`decode_step` over a cache split into 8 sequence blocks of a (2,
    4) mesh of logical shards of the card, at a block's last position,
    the next block's first, the last and past the end: equal to the same
    steps on 8 CPU shards and within 1e-5 of the card's unsharded decode
    (float32 compute, TF32 off)."""
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm(arch)
    model = T.LM(cfg, device="cpu", seed=0)
    host = C.param_tree(model)
    params = C.param_tree(model.to(card))
    B, S = 2, 64
    positions = (7, 8, S - 1, S + 2)
    toks = torch.tensor([3, 77])
    runs = {}
    for name, devs in (("card", [card] * 8), ("cpu", [torch.device("cpu")]
                                              * 8)):
        mesh = _mesh(devs, data=2, model=4)
        cache, _ = _seeded_cache(cfg, B, S, mesh)
        p = params if name == "card" else host
        runs[name] = _decode(p, cfg, cache, toks.to(devs[0]), positions,
                             mesh)
    _, whole = _seeded_cache(cfg, B, S, _mesh([card] * 8, data=2, model=4))
    whole = {k: v.to(card) for k, v in whole.items()}
    unsharded = _decode(params, cfg, whole, toks.to(card), positions,
                        _mesh([card] * 8, data=2, model=4))
    _positions(runs["card"], runs["cpu"])
    assert _rel(runs["card"], unsharded) <= 1e-5


def test_distributed_lse_decode_on_card_equals_cpu(card):
    from repro_torch.distributed.collectives import distributed_lse_decode
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 2, 64, generator=g)
    k = torch.randn(2, 256, 4, 64, generator=g)
    v = torch.randn(2, 256, 4, 64, generator=g)
    mask = torch.rand(2, 256, generator=g) < 0.8
    ref = distributed_lse_decode(q, k.chunk(8, 1), v.chunk(8, 1),
                                 mask.chunk(8, 1))[0]
    got = distributed_lse_decode(q.to(card), [b.to(card) for b in
                                              k.chunk(8, 1)],
                                 [b.to(card) for b in v.chunk(8, 1)],
                                 [b.to(card) for b in mask.chunk(8, 1)])
    assert all(t.device.type == "cuda" for t in got)
    assert _rel(got[0].cpu(), ref) <= 1e-6


def test_moe_replicated_ep_on_card_equals_cpu(card):
    """`moe_ffn_replicated_ep` over 4 logical shards of the card (whole
    expert leaves, and leaves stored by their `Spec`, experts over
    "model") against the CPU's, float32, TF32 off."""
    from repro_torch.launch.mesh import Spec, shard_leaf
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm("qwen2-moe-a2.7b").moe
    g = torch.Generator().manual_seed(4)
    E, d, F = cfg.padded_experts, 64, cfg.d_ff_expert
    w = {"router": torch.randn(d, E, generator=g),
         "w_gate": torch.randn(E, d, F, generator=g) / 8,
         "w_up": torch.randn(E, d, F, generator=g) / 8,
         "w_down": torch.randn(E, F, d, generator=g) / 6,
         "shared_gate_w": torch.randn(d, 2 * F, generator=g) / 8,
         "shared_up": torch.randn(d, 2 * F, generator=g) / 8,
         "shared_down": torch.randn(2 * F, d, generator=g) / 8,
         "shared_out_gate": torch.randn(d, 1, generator=g)}
    x = torch.randn(64, d, generator=g)
    ref = moe.moe_ffn_replicated_ep(x, w, cfg, _mesh([torch.device("cpu")]
                                                     * 4))
    mesh = _mesh([card] * 4)
    wc = {k: v.to(card) for k, v in w.items()}
    split = dict(wc, **{n: shard_leaf(wc[n], Spec("model"), mesh)
                        for n in moe.EXPERT_LEAVES})
    for ws in (wc, split):
        y, aux = moe.moe_ffn_replicated_ep(x.to(card), ws, cfg, mesh)
        assert _rel(y.cpu(), ref[0]) <= 1e-5
        assert abs(float(aux) - float(ref[1])) <= 1e-6 * abs(float(ref[1]))


def test_gpipe_on_card_equals_sequential(card):
    from repro_torch.distributed.pipeline import gpipe_forward
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(5)
    w = (torch.randn(4, 256, 256, generator=g) / 16).to(card)
    x = torch.randn(8, 32, 256, generator=g).to(card)
    y = gpipe_forward(_mesh([card] * 4, pod=4), w, x)
    ref = x
    for s in range(4):
        ref = torch.tanh(ref @ w[s])
    assert _rel(y, ref) <= 2e-4


def test_lm_mesh_over_several_cards(card):
    """Over 4 cards (card k shard k): the sharded decode (llama3 and
    qwen2-moe smoke configs, every leaf stored by `shard_params`) against 4
    logical shards of card 0, `gpipe_forward` against the stages in turn
    on card 0. Skips with fewer than four cards."""
    from repro_torch.distributed.pipeline import gpipe_forward
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = [torch.device("cuda", i) for i in range(4)]
    for arch in ("llama3-8b", "qwen2-moe-a2.7b"):
        cfg = _lm(arch)
        params = C.param_tree(T.LM(cfg, device=cards[0], seed=0))
        got = {}
        for name, devs in (("cards", cards), ("card0", [cards[0]] * 4)):
            mesh = _mesh(devs)
            cache, _ = _seeded_cache(cfg, 2, 64, mesh)
            assert [b.device for b in cache["k"]] == list(devs)
            got[name] = _decode(T.shard_params(params, cfg, mesh), cfg,
                                cache, torch.tensor([3, 77], device=cards[0]),
                                (7, 8, 63), mesh)
        assert _rel(got["cards"], got["card0"]) <= 1e-6
    g = torch.Generator().manual_seed(6)
    w = (torch.randn(4, 256, 256, generator=g) / 16).to(cards[0])
    x = torch.randn(8, 32, 256, generator=g).to(cards[0])
    y = gpipe_forward(_mesh(cards, pod=4), w, x)
    assert y.device == cards[3]
    ref = x
    for s in range(4):
        ref = torch.tanh(ref @ w[s])
    assert _rel(y.to(cards[0]), ref) <= 2e-4


# ------------------------------------------------ training over a mesh
def _train_run(cfg, params, mesh, steps=2, blocks=None):
    """``steps`` AdamW steps (warm-up 0) from ``params`` (stored by their
    specs over ``mesh``, or whole; with ``blocks``, whole parameters
    over the batch's ``blocks`` row blocks, each its own forward, as the
    data shards run them): the losses and the last parameters,
    joined."""
    from repro_torch.data.lm import TokenStream
    from repro_torch.distributed.collectives import cross_entropy_blocks
    from repro_torch.launch.mesh import Sharded, join_leaf
    from repro_torch.models import transformer as T
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.tree import map_sharded
    ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=0)
    batch = TokenStream(cfg.vocab, 32, 8, seed=0).next_batch()
    def rows(p, b):
        outs = [T.forward(p, cfg, t) for t in np.split(b["tokens"], blocks)]
        return cross_entropy_blocks([o[0] for o in outs],
                                    np.split(b["labels"], blocks))

    step = make_train_step(rows if blocks else
                           (lambda p, b: T.loss_fn(p, cfg, b)), ocfg,
                           mesh=mesh)
    p, o, losses = params, O.init_opt_state(ocfg, params), []
    for _ in range(steps):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    return losses, map_sharded(
        lambda x: join_leaf(x).cpu() if isinstance(x, Sharded) else x.cpu(),
        p)


def test_gather_backward_across_two_logical_shards(card):
    """`gather_leaf` / `gather_leaf_rows` of a leaf split over two
    logical shards of the card, onto each data shard: every block's
    gradient is its slice of the whole leaf's (the reduce-scatter)."""
    from repro_torch.distributed.collectives import (gather_leaf,
                                                     gather_leaf_rows)
    from repro_torch.launch.mesh import Spec, data_shards, shard_leaf
    from repro_torch.train.loop import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = _mesh([card] * 2, data=2, model=1)
    g = torch.Generator().manual_seed(3)
    w = torch.randn(8, 6, generator=g).to(card)
    xs = [torch.randn(4, 8, generator=g).to(card) for _ in range(2)]
    ids = [torch.tensor([0, 7, 3, 3], device=card),
           torch.tensor([5, 1], device=card)]

    def loss(p, _):
        total = 0
        for d, k in enumerate(data_shards(mesh)):
            dev = mesh.devices[k]
            total = total + ((xs[d] @ gather_leaf(p["w"], dev)) ** 2).sum() \
                + (gather_leaf_rows(p["w"], ids[d], dev) ** 3).sum()
        return total

    wl = w.clone().requires_grad_(True)
    ref = sum(((x @ wl) ** 2).sum() + (wl[i] ** 3).sum()
              for x, i in zip(xs, ids))
    ref.backward()
    _, grads = value_and_grad(loss)({"w": shard_leaf(w, Spec("data"),
                                                     mesh)}, None)
    for k, blk in enumerate(grads["w"]):
        assert blk.device.type == "cuda"
        exp = wl.grad[4 * k:4 * k + 4]
        assert _rel(blk, exp) <= 1e-6


@pytest.mark.parametrize("axes", [{"data": 4, "model": 1},
                                  {"data": 1, "model": 4}])
def test_sharded_train_step_on_card_equals_unsharded(card, axes):
    """llama3-8b's smoke config, float32: two steps of
    `make_train_step(mesh=)` on 4 logical shards of the card (every leaf
    and moment stored by its spec) against the unsharded steps on the
    card over the same row blocks (4 x 1: a data shard's rows their own
    forward; 1 x 4: the whole batch), within 1e-6. (Against the whole
    batch at once, 4 x 1 moves by more: other GEMM shapes round
    otherwise, and the smoke config's init amplifies it.)"""
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm("llama3-8b")
    mesh = _mesh([card] * 4, **axes)
    params = T.init_params(cfg, torch.Generator(card).manual_seed(0))
    sharded = T.init_params(cfg, torch.Generator(card).manual_seed(0),
                            mesh=mesh)
    a_loss, a = _train_run(cfg, sharded, mesh)
    b_loss, b = _train_run(cfg, params, None, blocks=axes["data"])
    assert np.allclose(a_loss, b_loss, rtol=1e-6, atol=0), (a_loss, b_loss)
    fb = C.flatten_params(b)
    errs = {p: _rel(leaf, fb[p]) for p, leaf in
            C.flatten_params(a).items()}
    assert max(errs.values()) <= 1e-6, errs


def test_sharded_train_step_over_several_cards(card):
    """Over 4 cards ("data", "model") 4 x 1, each card drawing its own
    blocks (equal to card 0's draw): two steps against the same on 4
    logical shards of card 0, the losses within 1e-6 and the parameters
    within 1e-5 of each leaf's max |ref| (a block's gradient parts
    arrive from the cards in the order the backward's device threads
    finish, so the sums may round otherwise, and Adam's normalised
    update carries that into the parameters). Skips with fewer than
    four cards."""
    from repro_torch.launch.mesh import join_leaf
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    from repro_torch.train.tree import map_sharded
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm("llama3-8b")
    cards = [torch.device("cuda", i) for i in range(4)]
    runs = {}
    for name, devs in (("cards", cards), ("card0", [cards[0]] * 4)):
        mesh = _mesh(devs, data=4, model=1)
        params = T.init_params(cfg, torch.Generator(cards[0]).manual_seed(0),
                               mesh=mesh)
        assert [b.device for b in params["embed"]] == list(devs)
        runs[name] = (C.flatten_params(map_sharded(
            lambda x: join_leaf(x).cpu(), params)),
            _train_run(cfg, params, mesh))
    for path, leaf in runs["cards"][0].items():
        assert torch.equal(leaf, runs["card0"][0][path]), path
    (a_loss, a), (b_loss, b) = runs["cards"][1], runs["card0"][1]
    assert np.allclose(a_loss, b_loss, rtol=1e-6, atol=0)
    ref = C.flatten_params(b)
    for path, leaf in C.flatten_params(a).items():
        assert _rel(leaf, ref[path]) <= 1e-5, path


def test_moe_train_step_over_several_cards(card):
    """qwen2-moe-a2.7b's smoke config (``remat="full"``, float32, TF32
    off) over 4 cards as ("data", "model") 2 x 2 and 1 x 4, so "model" >
    1 and the experts sit on several cards: each MoE layer is one region
    over the cards (every data shard's attention, then the experts on
    their own cards), recomputed in the backward. Three AdamW steps
    against the same on 4 logical shards of card 0, at
    `test_sharded_train_step_over_several_cards`'s bars: the losses
    within 1e-6, the parameters within 1e-5 of each leaf's max |ref|.
    Skips with fewer than four cards."""
    import dataclasses
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_lm("qwen2-moe-a2.7b"), remat="full")
    cards = [torch.device("cuda", i) for i in range(4)]
    for axes in ({"data": 2, "model": 2}, {"data": 1, "model": 4}):
        runs = {}
        for name, devs in (("cards", cards), ("card0", [cards[0]] * 4)):
            mesh = _mesh(devs, **axes)
            params = T.init_params(
                cfg, torch.Generator(cards[0]).manual_seed(0), mesh=mesh)
            assert [b.device for b in params["layers"]["w_gate"]] == \
                list(devs)
            runs[name] = _train_run(cfg, params, mesh, steps=3)
        (a_loss, a), (b_loss, b) = runs["cards"], runs["card0"]
        assert np.allclose(a_loss, b_loss, rtol=1e-6, atol=0), \
            (axes, a_loss, b_loss)
        ref = C.flatten_params(b)
        for path, leaf in C.flatten_params(a).items():
            assert _rel(leaf, ref[path]) <= 1e-5, (axes, path)


def test_mesh_prefill_on_card_equals_cpu(card):
    """`prefill_step` over parameters stored by their specs on 4 logical
    shards of the card (("data", "model") 2 x 2; llama3-8b's smoke
    config, float32, TF32 off) into `init_cache(mesh=)`'s sequence
    blocks, against the one-device prefill on the CPU: next tokens
    equal; the prompt's logits per position as `_positions` holds the
    forward (the median within 1e-5 of max |ref|, every position within
    3e-2, greedy tokens equal: the attention rounds its operands to
    bf16, so a last-bit difference can move a position); the cache at
    [0, T) the same way, its median position within one bf16 step of
    max |ref|, and zero after T."""
    from repro_torch.data.lm import TokenStream
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm("llama3-8b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = TokenStream(cfg.vocab, 32, 4, seed=0).next_batch()["tokens"]
    mesh = _mesh([card] * 4, data=2, model=2)
    sp = T.shard_params(_tree_on(params, card), cfg, mesh)
    with torch.no_grad():
        got_n, got_c, got_l = T.prefill_step(sp, cfg, prompt,
                                             return_logits=True, max_len=64)
        ref_n, ref_c, ref_l = T.prefill_step(params, cfg, prompt,
                                             return_logits=True, max_len=64)
    assert all(b.device.type == "cuda" for b in got_c["k"])
    assert torch.equal(got_n.cpu(), ref_n)
    _positions(got_l, ref_l)
    for k in ("k", "v"):
        whole = torch.cat([b.cpu() for b in got_c[k]], dim=2).double()
        ref = ref_c[k].double()
        assert torch.equal(whole[:, :, 32:], torch.zeros_like(ref[:, :, 32:]))
        per = (whole[:, :, :32] - ref[:, :, :32]).abs().flatten(3).amax(
            -1).flatten() / ref.abs().max()
        assert float(per.median()) <= 2.0 ** -7 and float(per.max()) <= 3e-2, k


def _remesh_run(device, path) -> tuple:
    """`FaultTolerantRunner` over ("data", "model") 2 x 2 logical shards
    of ``device`` (llama3-8b's smoke config, float32): a checkpoint every
    2 steps, two of the four workers lost during step 2, so `remesh_fn`
    rebuilds the step and state over 2 x 1 and the step-2 checkpoint is
    restored onto it (step 2 runs again there); 5 steps. Returns (the runner's losses, the losses
    and state of an uninterrupted run on 2 x 1 from that checkpoint, the
    runner's final state), the states joined on the CPU."""
    import dataclasses
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.checkpoint.fault import FaultTolerantRunner, Heartbeat
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenStream
    from repro_torch.launch.mesh import Sharded, join_leaf
    from repro_torch.models import transformer as T
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.tree import flatten_global
    cfg = dataclasses.replace(get_arch("llama3-8b").smoke_config(),
                              compute_dtype="float32")
    ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=0)
    stream = TokenStream(cfg.vocab, 32, 4, seed=0)
    batches = [stream.next_batch() for _ in range(5)]

    def setup(n):
        m = _mesh([device] * n, data=2, model=n // 2)
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        params = T.shard_params(_tree_on(params, device), cfg, m)
        return (make_train_step(lambda p, b: T.loss_fn(p, cfg, b), ocfg,
                                mesh=m), params, O.init_opt_state(ocfg, params))

    def joined(tree):
        return {k: (join_leaf(v) if isinstance(v, Sharded) else v).cpu()
                for k, v in flatten_global(tree).items()}

    hb = Heartbeat(n_workers=4, timeout_s=1e19)

    def batch_for_step(s):
        if s == 2 and runner.heartbeat is hb:
            hb.last[2] = hb.last[3] = -1e20
        return batches[s]

    cm = CheckpointManager(str(path))
    runner = FaultTolerantRunner(*setup(4), cm, ckpt_every=2, heartbeat=hb,
                                 remesh_fn=lambda n: setup(n))
    log = runner.run(None, max_steps=5, batch_for_step=batch_for_step)
    assert runner.restarts == 1
    assert [r["step"] for r in log] == [0, 1, 2, 2, 3, 4]
    step2, p2, o2 = setup(2)
    state, at = cm.restore({"params": p2, "opt_state": o2}, step=2)
    assert at == 2
    p2, o2, losses = state["params"], state["opt_state"], []
    for s in (2, 3, 4):
        p2, o2, m = step2(p2, o2, batches[s])
        losses.append(float(m["loss"]))
    return ([r["loss"] for r in log], losses,
            joined({"params": p2, "opt_state": o2}),
            joined({"params": runner.params, "opt_state": runner.opt_state}))


def test_remesh_restart_on_card_equals_cpu(card, tmp_path):
    """The `FaultTolerantRunner`'s re-meshing restart on the card (4
    logical shards to 2, `_remesh_run`) resumes with the losses and
    state of an uninterrupted run on 2 shards from the same checkpoint,
    bit for bit, as it does on CPU shards; the card's first loss (the
    same weights, no update yet) within 1e-4 of the CPU's (TF32 off;
    the attention's bf16 operands move it by ~1e-5, and Adam then
    carries last-bit differences into whole steps, so the later losses
    part further)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for name, dev in (("card", card), ("cpu", torch.device("cpu"))):
        log, resumed, state, got = _remesh_run(dev, tmp_path / name)
        assert log[3:] == resumed, (name, log, resumed)
        for k, v in state.items():
            assert torch.equal(got[k], v), (name, k)
        runs[name] = log
    assert abs(runs["card"][0] - runs["cpu"][0]) <= 1e-4 * abs(
        runs["cpu"][0]), runs


# ------------------------------------------ the graph family over a mesh
def _gnn_mesh_case(arch):
    """(cfg, module, loss, batch, batch specs) at the CPU tests' sizes:
    a depth-4 smoke GNN (PNA computing in float64) on a node task (N = 64, E = 256; nodes, labels
    and edges split over "data"), NequIP's smoke config on 4 molecules
    with forces (E = 80, node arrays replicated)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs import gnn_common as GC
    from repro_torch.data.graphs import synthetic_molecules
    from repro_torch.models import gnn as G
    from repro_torch.models import nequip as NQ
    cfg = get_arch(arch).smoke_config()
    rng = np.random.default_rng(0)
    if arch == "nequip":
        m = synthetic_molecules(4, 6, 10, cfg.d_feat, seed=2)
        batch = dict(m, edges_src=np.concatenate([m["edges_src"],
                                                  m["edges_dst"]]),
                     edges_dst=np.concatenate([m["edges_dst"],
                                               m["edges_src"]]))
        return (cfg, NQ, lambda p, b: NQ.loss_fn(p, cfg, b, n_graphs=4),
                batch, GC.batch_specs(cfg, "molecule"))
    # PNA in float64: at depth 4 its float32 gradient is noise (its std
    # aggregate cancels), 4.9% of a leaf apart between the card and CPU
    cfg = dataclasses.replace(cfg, n_layers=4, compute_dtype=(
        "float64" if arch == "pna" else cfg.compute_dtype))
    N, E = 64, 256
    batch = {"feat": rng.standard_normal((N, cfg.d_feat)).astype(np.float32),
             "edges_src": rng.integers(0, N, E).astype(np.int32),
             "edges_dst": rng.integers(0, N, E).astype(np.int32),
             "labels": rng.integers(0, cfg.n_classes, N).astype(np.int32)}
    return (cfg, G, lambda p, b: G.loss_fn(p, cfg, b), batch,
            GC.batch_specs(cfg, "ogb_products"))


def _gnn_mesh_steps(arch, devices, steps=2):
    """``steps`` AdamW steps of `_gnn_mesh_case` over a ("data",) mesh of
    ``devices`` from a seeded CPU draw: the losses and the parameters
    and moments, joined on the CPU."""
    from repro_torch.configs import gnn_common as GC
    from repro_torch.launch.mesh import (Sharded, join_leaf,
                                         make_serving_mesh, place_batch)
    from repro_torch.models import common as C
    from repro_torch.train import optim as O
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.tree import map_sharded
    cfg, mod, loss, batch, specs = _gnn_mesh_case(arch)
    mesh = make_serving_mesh(devices)
    p = GC.shard_params(_tree_on(mod.init_params(
        cfg, torch.Generator().manual_seed(0)), devices[0]), cfg, mesh)
    o = O.init_opt_state(GC.TRAIN_OPT, p)
    step = make_train_step(loss, GC.TRAIN_OPT, mesh=mesh, batch_specs=specs,
                           one_thread=True)
    placed = place_batch(batch, mesh, specs)
    losses = []
    for _ in range(steps):       # the first step's warm-up rate is 0
        p, o, m = step(p, o, placed)
        losses.append(float(m["loss"]))
    return losses, C.flatten_params(map_sharded(
        lambda x: (join_leaf(x) if isinstance(x, Sharded) else x).cpu(),
        {"p": p, "m": o.m, "v": o.v}))


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "gatedgcn", "nequip"])
def test_gnn_mesh_step_on_card_equals_cpu(card, arch, monkeypatch):
    """Two sharded AdamW steps over 4 logical shards of the card (the
    GNNs past a lowered `BIG_GRAPH`: each shard's edges in 5 chunks
    inside a recomputed block of 4 layers; NequIP with forces) against
    the same steps over 4 CPU shards: the losses within 1e-5, every
    parameter and moment within 1e-4 of its max |ref| (TF32 off), and
    bit-identical across two runs on the card."""
    from repro_torch.models import gnn as G
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(G, "BIG_GRAPH", 10)
    monkeypatch.setattr(G, "EDGE_CHUNK", 13)
    dev = torch.device("cuda", torch.cuda.current_device())
    la, a = _gnn_mesh_steps(arch, [dev] * 4)
    lb, b = _gnn_mesh_steps(arch, [dev] * 4)
    lc, c = _gnn_mesh_steps(arch, [torch.device("cpu")] * 4)
    assert la == lb and np.allclose(la, lc, rtol=1e-5, atol=0), (la, lc)
    for k in c:
        assert torch.equal(a[k], b[k]), k
        if c[k].abs().max() > 0:
            assert _rel(a[k], c[k]) <= 1e-4, k


def test_gnn_mesh_over_several_cards(card, monkeypatch):
    """Every arch's two sharded steps over 4 cards ("data",) against the
    same steps over 4 logical shards of card 0 (the GNNs' edge chunks
    inside a recomputed block, NequIP's force loss): the losses,
    parameters and moments bit for bit (every cross-card sum runs in
    linear shard order, and the backward on one thread). Skips with
    fewer than four cards."""
    from repro_torch.models import gnn as G
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(G, "BIG_GRAPH", 10)
    monkeypatch.setattr(G, "EDGE_CHUNK", 13)
    cards = [torch.device("cuda", i) for i in range(4)]
    for arch in ("gin-tu", "pna", "gatedgcn", "nequip"):
        la, a = _gnn_mesh_steps(arch, cards)
        lb, b = _gnn_mesh_steps(arch, [cards[0]] * 4)
        assert la == lb, (arch, la, lb)
        for k in b:
            assert torch.equal(a[k], b[k]), (arch, k)
