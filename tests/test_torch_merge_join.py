"""The merge-join kernels' plain versions on the rows those kernels must
tell apart: K9 `wcsd_query_gathered` (gathered padded rows), K2
`wcsd_profile_ragged` and K1 `wcsd_query_ragged` (arena tiles through a
ragged worklist), and K6 `wcsd_profile_ragged_compressed` and K5
`wcsd_query_ragged_compressed` (the same tiles in the compressed arena's
format, `_torch_parity.compressed_rows`, in bfloat16 and float16).

On the card both kernels merge-join rows whose real cells are hub-sorted
with inert pads after them, and join every other row all-pairs. The
rows here (`_torch_parity.ROW_CASES`) are store-shaped (sorted real
prefix, inert pad tail, cells masked by level; also with long runs of
one hub) or break that shape (a feasible pad on both sides, a pad
mid-row, a descending pair, no real cell at all). The plain versions
must give the reference's answer on every one: the Pallas kernels in
interpret mode and the `kernels/ref.py` oracles, exactly. K2 runs at
``num_levels + 1`` of 1, 5 and 32 (the most the kernels bin) with levels
up to one past the last bin, and lane 48; K9 at a shape the Pallas
kernel takes (B % 8 == 0, L % 128 == 0) and at an odd one (oracle only);
K1 at lane 48 with query levels from 0 to one above every cell, and the
trash level on the worklist's pads; K6 and K5 as K2 and K1.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ml_dtypes

from _torch_parity import (DEV_INF, ROW_CASES, assert_same_array,
                           compressed_rows, gathered_rows, label_rows,
                           ragged_items, tile_spans)
from repro.kernels import ref as j_ref
from repro.kernels import wcsd_query as j_wq
from repro_torch.kernels import wcsd_query as t_wq

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import mergeable_at, mergeable_rows  # noqa: E402
# (the smoke's checks)

BROKEN = {"live-pad", "mid-row-pad", "descending"}
TRASH_LEVEL = 1 << 20


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


FLOATS = {"bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "float16": (np.float16, torch.float16)}


def _compressed(hub, dist, wlev, lo, dtype):
    """The tiles in the compressed format, as (jnp arrays, torch
    tensors)."""
    hd, bits, wl = compressed_rows(hub, dist, wlev, lo, dtype)
    np_f, torch_f = FLOATS[dtype]
    return (_j(hd, bits.view(np_f), wl),
            [torch.from_numpy(hd),
             torch.from_numpy(bits.view(np.int16)).view(torch_f),
             torch.from_numpy(wl)])


def test_row_cases_are_what_they_say():
    """Store-shaped rows pass the kernels' check (as the smoke computes it
    to report the merge share), broken ones fail it in some row: the
    generators make the rows each test needs."""
    rng = np.random.default_rng(0)
    for case in ROW_CASES:
        hs, ds, ht, dt = gathered_rows(rng, 16, 40, case)
        ok9 = mergeable_rows(hs, ds >= DEV_INF) & mergeable_rows(
            ht, dt >= DEV_INF)
        hub, _, wlev = label_rows(rng, 16, 40, case)
        ok2 = mergeable_rows(hub, wlev < 0)
        assert ok9.all() == ok2.all() == (case not in BROKEN), case
    hub, _, _ = label_rows(rng, 64, 40, "duplicates")
    assert (hub[:, 1:] == hub[:, :-1])[hub[:, 1:] >= 0].mean() > 0.5


@pytest.mark.parametrize("B,L", [(16, 128), (5, 131)])
@pytest.mark.parametrize("case", ROW_CASES)
def test_gathered_plain_on_merge_cases(case, B, L):
    """K9's plain version == the jnp oracle (capped at DEV_INF) == the
    Pallas kernel in interpret mode where its shape rules allow; a feasible
    pad on both sides gives the pads' sum."""
    rng = np.random.default_rng(ROW_CASES.index(case) * 100 + L)
    rows = gathered_rows(rng, B, L, case)
    got = t_wq.wcsd_query_gathered_plain(*_t(*rows)).numpy()
    exp = np.minimum(np.asarray(j_ref.wcsd_query_gathered_ref(*_j(*rows))),
                     DEV_INF).astype(np.int32)
    assert_same_array(got, exp)
    if B % 8 == 0 and L % 128 == 0:
        assert_same_array(got, np.asarray(j_wq.wcsd_query_gathered(
            *_j(*rows))))
    hs, ds, ht, dt = rows
    if case == "live-pad":       # the first pads' sum beats every real meet
        k_s, k_t = (hs >= 0).sum(1), (ht >= 0).sum(1)
        r = np.arange(B)
        assert_same_array(got, (ds[r, k_s] + dt[r, k_t]).astype(np.int32))
    elif case == "pads-only":
        assert (got == DEV_INF).all()
    else:
        assert (got < DEV_INF).any()


@pytest.mark.parametrize("num_levels", [0, 4, 31])
@pytest.mark.parametrize("case", ROW_CASES)
def test_profile_plain_on_merge_cases(case, num_levels):
    """K2's plain version == the Pallas kernel (interpret) == the jnp
    oracle on arena tiles of every row case, lane 48, through a
    query-major worklist with trash-row pads; a tenth of the real cells
    sit one level past the last bin; feasible pads meet in the top bin."""
    rng = np.random.default_rng(ROW_CASES.index(case) * 100 + num_levels)
    T, Q, lane = 24, 10, 48
    hub, dist, wlev = label_rows(rng, T, lane, case, top_level=num_levels)
    past = (hub >= 0) & (rng.random(hub.shape) < 0.1)
    wlev = np.where(past, num_levels + 1, wlev).astype(np.int32)
    lo, hi = tile_spans(hub, wlev)
    q, st, tt, first = ragged_items(rng, Q, T, length=4 * Q + 8)
    rows = Q + 1
    arena = (hub, dist, wlev)
    pallas = np.asarray(j_wq.wcsd_profile_ragged(
        *_j(*arena, lo, hi, q, st, tt, first), num_rows=rows,
        num_levels=num_levels, interpret=True))
    ref = np.asarray(j_ref.wcsd_profile_ragged_ref(
        *_j(*arena, q, st, tt), rows, num_levels))
    plain = t_wq.wcsd_profile_ragged_plain(*_t(*arena, q, st, tt), rows,
                                           num_levels).numpy()
    assert_same_array(pallas, ref)
    assert_same_array(plain, pallas)
    assert plain.shape == (rows, num_levels + 1)
    if case == "live-pad":       # every item meets its tiles' first pads
        assert (plain[:Q, num_levels] <= 8).all()
    elif case == "pads-only":
        assert (plain == DEV_INF).all()
    else:
        assert (plain[:Q] < DEV_INF).any()


@pytest.mark.parametrize("case", ROW_CASES)
def test_query_plain_on_merge_cases(case):
    """K1's plain version == the Pallas kernel (interpret) == the jnp
    oracle on arena tiles of every row case, lane 48, through a
    query-major worklist whose pads feed the trash row at TRASH_LEVEL;
    query levels 0 to one above every cell. K1's merge check depends on
    the item's level (a pad is inert where its distance, masked at that
    level, is DEV_INF): a "live-pad" tile passes it only above the live
    pads' level, where the pads' meet is masked too."""
    rng = np.random.default_rng(ROW_CASES.index(case) * 100 + 7)
    T, Q, lane, top = 24, 12, 48, 4
    hub, dist, wlev = label_rows(rng, T, lane, case, top_level=top)
    lo, hi = tile_spans(hub, wlev)
    q, st, tt, first = ragged_items(rng, Q, T, length=4 * Q + 8)
    wq = np.concatenate([rng.integers(0, top + 2, Q), [TRASH_LEVEL]])
    wq[:3] = 0, top, top + 1           # the lowest, the top, one above it
    wq = wq.astype(np.int32)
    arena = (hub, dist, wlev)
    pallas = np.asarray(j_wq.wcsd_query_ragged(
        *_j(*arena, lo, hi, q, st, tt, first, wq), interpret=True))
    ref = np.asarray(j_ref.wcsd_query_ragged_ref(*_j(*arena, q, st, tt,
                                                     wq)))
    plain = t_wq.wcsd_query_ragged_plain(*_t(*arena, q, st, tt,
                                             wq)).numpy()
    assert_same_array(pallas, ref)
    assert_same_array(plain, pallas)
    above = wq > top                  # every cell masked: no meet counts
    assert (plain[above] == DEV_INF).all()
    ok = mergeable_at(hub, dist, wlev, st, wq[q]) & mergeable_at(
        hub, dist, wlev, tt, wq[q])
    if case == "live-pad":       # the pads meet wherever their level allows
        assert (plain[~above] <= 8).all()
        assert_same_array(ok, wq[q] > top)
    elif case == "pads-only":
        assert (plain == DEV_INF).all()
        assert ok.all()
    else:
        assert (plain[~above] < DEV_INF).any()
        assert ok.all() == (case not in BROKEN)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_compressed_row_cases_are_what_they_say(dtype):
    """The row cases in the compressed format decode to the int32 rows
    (hubs and levels exactly, distances as the float format rounds them,
    +inf pads to DEV_INF), and the smoke's checks computed on them (on hub
    deltas, float distances and int8 levels) agree with the same checks
    on the int32 rows: store rows pass, broken ones fail."""
    rng = np.random.default_rng(2)
    for case in ROW_CASES:
        hub, dist, wlev = label_rows(rng, 16, 40, case)
        lo, _ = tile_spans(hub, wlev)
        _, (hd, df, wl) = _compressed(hub, dist, wlev, lo, dtype)
        tiles = torch.arange(16, dtype=torch.int32)
        h, d, w = t_wq._tiles_compressed(hd, df, wl, torch.from_numpy(lo))(
            tiles)
        assert_same_array(h.numpy(), hub)
        assert_same_array(w.numpy(), wlev)
        real = dist < DEV_INF
        exp = df.float().clamp_max(DEV_INF).round().int().numpy()
        assert_same_array(d.numpy()[~real], np.full((~real).sum(), DEV_INF,
                                                    np.int32))
        assert_same_array(d.numpy()[real], exp[real])
        ok6 = mergeable_rows(hd, wl < 0)
        assert ok6.all() == (case not in BROKEN), case
        int32 = _t(hub, dist, wlev)
        assert torch.equal(ok6, mergeable_rows(int32[0], int32[2] < 0))
        lev = torch.from_numpy(rng.integers(0, 6, 16).astype(np.int32))
        assert torch.equal(mergeable_at(hd, df, wl, tiles, lev),
                           mergeable_at(*int32, tiles, lev))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("num_levels", [0, 4, 31])
@pytest.mark.parametrize("case", ROW_CASES)
def test_profile_compressed_plain_on_merge_cases(case, num_levels, dtype):
    """K6's plain version == the Pallas kernel (interpret) == the jnp
    oracle on K2's tiles of every row case in the compressed format, lane
    48, through a query-major worklist with trash-row pads; in float16
    (exact to 2,048) it also equals K2's plain version on the int32
    tiles."""
    rng = np.random.default_rng(ROW_CASES.index(case) * 100 + num_levels
                                + 50)
    T, Q, lane = 24, 10, 48
    hub, dist, wlev = label_rows(rng, T, lane, case, top_level=num_levels)
    past = (hub >= 0) & (rng.random(hub.shape) < 0.1)
    wlev = np.where(past, num_levels + 1, wlev).astype(np.int32)
    lo, hi = tile_spans(hub, wlev)
    q, st, tt, first = ragged_items(rng, Q, T, length=4 * Q + 8)
    rows = Q + 1
    jc, tc = _compressed(hub, dist, wlev, lo, dtype)
    pallas = np.asarray(j_wq.wcsd_profile_ragged_compressed(
        *jc, *_j(lo, hi, q, st, tt, first), num_rows=rows,
        num_levels=num_levels, interpret=True))
    ref = np.asarray(j_ref.wcsd_profile_ragged_compressed_ref(
        *jc, *_j(lo, q, st, tt), rows, num_levels))
    plain = t_wq.wcsd_profile_ragged_compressed_plain(
        *tc, *_t(lo, q, st, tt), rows, num_levels).numpy()
    assert_same_array(pallas, ref)
    assert_same_array(plain, pallas)
    if dtype == "float16":
        assert_same_array(plain, t_wq.wcsd_profile_ragged_plain(
            *_t(hub, dist, wlev, q, st, tt), rows, num_levels).numpy())
    if case == "live-pad":       # every item meets its tiles' first pads
        assert (plain[:Q, num_levels] <= 8).all()
    elif case == "pads-only":
        assert (plain == DEV_INF).all()
    else:
        assert (plain[:Q] < DEV_INF).any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", ROW_CASES)
def test_query_compressed_plain_on_merge_cases(case, dtype):
    """K5's plain version == the Pallas kernel (interpret) == the jnp
    oracle on K1's tiles of every row case in the compressed format, lane
    48, query levels 0 to one above every cell, the trash level on the
    worklist's pads; in float16 it also equals K1's plain version on the
    int32 tiles. The smoke's K5 check, computed on the compressed tiles,
    passes a "live-pad" tile only above the live pads' level."""
    rng = np.random.default_rng(ROW_CASES.index(case) * 100 + 57)
    T, Q, lane, top = 24, 12, 48, 4
    hub, dist, wlev = label_rows(rng, T, lane, case, top_level=top)
    lo, hi = tile_spans(hub, wlev)
    q, st, tt, first = ragged_items(rng, Q, T, length=4 * Q + 8)
    wq = np.concatenate([rng.integers(0, top + 2, Q), [TRASH_LEVEL]])
    wq[:3] = 0, top, top + 1           # the lowest, the top, one above it
    wq = wq.astype(np.int32)
    jc, tc = _compressed(hub, dist, wlev, lo, dtype)
    pallas = np.asarray(j_wq.wcsd_query_ragged_compressed(
        *jc, *_j(lo, hi, q, st, tt, first, wq), interpret=True))
    ref = np.asarray(j_ref.wcsd_query_ragged_compressed_ref(
        *jc, *_j(lo, q, st, tt, wq)))
    plain = t_wq.wcsd_query_ragged_compressed_plain(
        *tc, *_t(lo, q, st, tt, wq)).numpy()
    assert_same_array(pallas, ref)
    assert_same_array(plain, pallas)
    if dtype == "float16":
        assert_same_array(plain, t_wq.wcsd_query_ragged_plain(
            *_t(hub, dist, wlev, q, st, tt, wq)).numpy())
    above = wq > top                  # every cell masked: no meet counts
    assert (plain[above] == DEV_INF).all()
    w = torch.from_numpy(wq[q])
    ok = (mergeable_at(*tc, torch.from_numpy(st), w)
          & mergeable_at(*tc, torch.from_numpy(tt), w)).numpy()
    if case == "live-pad":       # the pads meet wherever their level allows
        assert (plain[~above] <= 8).all()
        assert_same_array(ok, wq[q] > top)
    elif case == "pads-only":
        assert (plain == DEV_INF).all()
        assert ok.all()
    else:
        assert (plain[~above] < DEV_INF).any()
        assert ok.all() == (case not in BROKEN)
