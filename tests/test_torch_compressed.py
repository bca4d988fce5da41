"""The port's compressed arena and its kernels (K5
`wcsd_query_ragged_compressed`, K6 `wcsd_profile_ragged_compressed`)
against the JAX package, exactly.

`CompressedArena`: every array (hub deltas, the bf16 / fp16 distance BIT
PATTERNS, levels, overflow flags, side tables) equals the reference's on
real stores, at the int16 hub-delta boundary, on level and fp16 range
overflow, and on distances past 2^24 where float64 -> bf16 rounding
could go astray; `decode` and `memory_bytes` agree. The plain K5/K6 and
their `ops` wrappers equal the reference Pallas kernels (interpret mode)
and its jnp oracles. The engine with ``compressed=True`` equals the
reference engine and the BFS grid, serves an overflowing store
uncompressed with ``compression_overflow`` set, and refuses bucket-pair
dispatch.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import assert_same_array, port_index
from repro.core.baselines import constrained_distance_grid
from repro.core.generators import erdos_renyi, scale_free
from repro.core.query import DeviceQueryEngine as JEngine
from repro.core.wc_index import CompressedArena as JComp
from repro.core.wc_index import LabelArena as JArena
from repro.core.wc_index import PackedLabels as JPacked
from repro.core.wc_index import PackedWCIndex as JPackedIndex
from repro.core.wc_index import build_wc_index
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels import wcsd_query as j_wq
from repro_torch.core.query import DeviceQueryEngine as TEngine
from repro_torch.core.query import TRASH_LEVEL
from repro_torch.core.wc_index import CompressedArena as TComp
from repro_torch.core.wc_index import LabelArena as TArena
from repro_torch.core.wc_index import float16_bits
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import wcsd_query as t_wq

I16_MAX = int(np.iinfo(np.int16).max)
I8_MAX = int(np.iinfo(np.int8).max)
CELL_FIELDS = ("hub_delta", "wlev", "tile_base", "tile_cnt", "tile_lo",
               "tile_hi", "overflow", "side_slot", "side_hub", "side_dist",
               "side_wlev")
ARENA_FIELDS = ("hub", "dist", "wlev", "tile_base", "tile_cnt", "tile_lo",
                "tile_hi")


def _t_arena(jar) -> TArena:
    """The reference arena's arrays as the port's `LabelArena`."""
    return TArena(**{f: getattr(jar, f) for f in ARENA_FIELDS})


def _assert_same_compressed(tc, jc):
    for f in CELL_FIELDS:
        assert_same_array(getattr(tc, f), getattr(jc, f), f)
    assert tc.dist.dtype == np.uint16
    assert_same_array(tc.dist, jc.dist.view(np.uint16), "dist bits")
    assert tc.dist_dtype == jc.dist.dtype.name
    assert tc.num_overflow_tiles == jc.num_overflow_tiles
    assert tc.memory_bytes() == jc.memory_bytes()
    for f in ARENA_FIELDS:
        assert_same_array(getattr(tc.decode(), f), getattr(jc.decode(), f),
                          f"decode.{f}")


def _compare(jar, dtype="bfloat16"):
    jc = JComp.from_arena(jar, dtype=dtype)
    tc = TComp.from_arena(_t_arena(jar), dtype=dtype)
    _assert_same_compressed(tc, jc)
    return tc, jc


# ------------------------------------------------------- the arena format
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("lane", [128, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_real_stores_match_reference(dtype, lane, seed):
    g = (erdos_renyi(30, 3.0, num_levels=3, seed=seed) if seed == 0
         else scale_free(60, m=3, num_levels=4, seed=seed))
    idx = build_wc_index(g)
    tc, _ = _compare(idx.packed(lane=lane).arena(lane=lane), dtype)
    assert tc.num_overflow_tiles == 0
    # the port's store caches one compressed view per (lane, dtype)
    tp = port_index(idx, lane=lane).packed(lane=lane)
    assert tp.compressed_arena(lane=lane, dtype=dtype) is \
        tp.compressed_arena(lane=lane, dtype=dtype)
    _assert_same_compressed(tp.compressed_arena(lane=lane, dtype=dtype),
                            idx.packed(lane=lane).compressed_arena(
                                lane=lane, dtype=dtype))


def _gap_store(gap: int, lane: int = 8, extra_wlev: int = 2):
    """Two vertices sharing hub ranks {0, gap}: one tile per row, so the
    in-tile hub delta is the gap (the reference suite's store)."""
    hub = np.array([0, gap, 0, gap], np.int32)
    dist = np.array([3, 5, 4, 6], np.int32)
    wlev = np.array([extra_wlev, 1, extra_wlev, 1], np.int32)
    offsets = np.array([0, 2, 4], np.int64)
    return JPacked.from_flat(hub, dist, wlev, offsets, lane=lane)


@pytest.mark.parametrize("gap", [I16_MAX - 600, I16_MAX - 1, I16_MAX,
                                 I16_MAX + 1, I16_MAX + 2, I16_MAX + 600])
def test_int16_delta_boundary_matches_reference(gap):
    tc, _ = _compare(_gap_store(gap).arena(lane=8))
    assert tc.num_overflow_tiles == (2 if gap > I16_MAX else 0)
    if gap <= I16_MAX:
        assert int(tc.hub_delta.max()) == gap


def test_wlev_and_fp16_range_overflow_match_reference():
    tc, _ = _compare(_gap_store(5, extra_wlev=I8_MAX + 1).arena(lane=8))
    assert tc.num_overflow_tiles == 2
    hub = np.array([0, 1], np.int32)
    dist = np.array([70_000, 2], np.int32)      # finite, > 65000
    packed = JPacked.from_flat(hub, dist, np.array([1, 1], np.int32),
                               np.array([0, 2], np.int64), lane=8)
    ar = packed.arena(lane=8)
    assert _compare(ar, "bfloat16")[0].num_overflow_tiles == 0
    assert _compare(ar, "float16")[0].num_overflow_tiles == 1
    with pytest.raises(ValueError, match="dtype"):
        TComp.from_arena(_t_arena(ar), dtype="float32")


def _adversarial_distances() -> np.ndarray:
    """Every bf16 and fp16 rounding midpoint of every binade up to 2^29,
    one below and one above it, plus the exact range, random values and
    the no-path values."""
    rng = np.random.default_rng(3)
    out = [np.arange(0, 2049), rng.integers(0, 1 << 29, 4096)]
    for e in range(8, 29):
        for mbits in (7, 10):          # bf16 / fp16 significand bits
            if e <= mbits:
                continue
            ulp = 1 << (e - mbits)
            k = np.arange(1 << mbits, 1 << (mbits + 1), max(1, (1 << mbits)
                                                             // 64))
            mid = k * ulp + ulp // 2
            out += [mid - 1, mid, mid + 1]
    out.append([(1 << 29) - 1, 1 << 29, INF_DIST_INT])
    d = np.concatenate([np.asarray(x, np.int64) for x in out])
    return d[(d >= 0) & (d <= INF_DIST_INT)].astype(np.int32)


INF_DIST_INT = 1 << 30


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_rounding_matches_reference_bit_for_bit(dtype):
    """Distances past 2^24, at and around every rounding midpoint: the
    port's cast (torch) gives the reference's bits (ml_dtypes / numpy)
    for every value of the set, in the arena and in the raw cast."""
    d = _adversarial_distances()
    assert (d >= 1 << 24).sum() > 1000
    f = np.where(d >= 1 << 29, np.inf, d.astype(np.float64))
    want = np.dtype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                    else np.float16)
    with np.errstate(over="ignore"):
        exp = f.astype(want).view(np.uint16)
    assert_same_array(float16_bits(f, dtype), exp)
    n = len(d)
    store = JPacked.from_flat(np.arange(n, dtype=np.int32), d,
                              np.ones(n, np.int32),
                              np.array([0, n], np.int64), lane=64)
    jar = store.arena(lane=64)
    jc = JComp.from_arena(jar, dtype=dtype)
    tc = TComp.from_arena(_t_arena(jar), dtype=dtype)
    for fld in CELL_FIELDS:
        assert_same_array(getattr(tc, fld), getattr(jc, fld), fld)
    assert_same_array(tc.dist, jc.dist.view(np.uint16))


def test_skew8_memory_ratio_matches_reference():
    """The capacity claim on the reference's SKEW8 store (lane 32): the
    same compressed/uncompressed byte ratio, 2.2146."""
    from benchmarks.bench_wcsd import make_skewed_store
    pidx, _ = make_skewed_store()
    jp = pidx.packed(lane=32)
    tp = port_index(pidx, lane=32).packed(lane=32)
    jr = jp.arena(lane=32).memory_bytes() / \
        jp.compressed_arena(lane=32).memory_bytes()
    tr = tp.arena(lane=32).memory_bytes() / \
        tp.compressed_arena(lane=32).memory_bytes()
    assert tr == jr
    assert round(tr, 4) == 2.2146
    _assert_same_compressed(tp.compressed_arena(lane=32),
                            jp.compressed_arena(lane=32))


# ------------------------------------------------------------ K5 and K6
W = 3


def _kernel_cases():
    rng = np.random.default_rng(0)
    g = scale_free(90, m=3, num_levels=W, seed=5)
    idx = build_wc_index(g, ordering="degree")
    from benchmarks.bench_wcsd import make_skewed_store
    pidx, heavy = make_skewed_store(V=40, W=W, lane=48, buckets=3,
                                    rng=np.random.default_rng(1))
    out = {}
    for name, (ix, lane, V) in {"real-lane128": (idx, 128, 90),
                                "real-lane48": (idx, 48, 90),
                                "skewed": (pidx, 48, 40)}.items():
        ar = ix.packed(lane=lane).arena(lane=lane)
        s = rng.integers(0, V, 24).astype(np.int32)
        t = rng.integers(0, V, 24).astype(np.int32)
        wl = rng.integers(0, W + 1, 24).astype(np.int32)
        t[:3] = s[:3]
        if name == "skewed":
            s[3:6], t[3:6] = np.resize(heavy, 3), np.resize(heavy[::-1], 3)
        out[name] = (ar, s, t, wl)
    return out


@pytest.fixture(scope="module")
def kcases():
    return _kernel_cases()


def _worklist(ar, s, t, pad_to=None):
    from repro.core.query import emit_ragged_worklist, ragged_worklist_len
    L = max(ragged_worklist_len(ar.tile_cnt, s, t), pad_to or 0)
    return [np.asarray(a) for a in emit_ragged_worklist(
        jnp.asarray(ar.tile_base), jnp.asarray(ar.tile_cnt),
        jnp.asarray(s), jnp.asarray(t), worklist_len=L)]


def _comp_args(jar, dtype):
    """(reference jnp arrays, port torch tensors) of the compressed trio
    and the tile spans."""
    jc = JComp.from_arena(jar, dtype=dtype)
    tc = TComp.from_arena(_t_arena(jar), dtype=dtype)
    fdt = torch.bfloat16 if dtype == "bfloat16" else torch.float16
    j = [jnp.asarray(a) for a in (jc.hub_delta, jc.dist, jc.wlev,
                                  jc.tile_lo, jc.tile_hi)]
    t = [torch.from_numpy(tc.hub_delta),
         torch.from_numpy(tc.dist.view(np.int16)).view(fdt),
         torch.from_numpy(tc.wlev), torch.from_numpy(tc.tile_lo),
         torch.from_numpy(tc.tile_hi)]
    return j, t


def _tt(a):
    return torch.from_numpy(np.array(a))


CASES = ["real-lane128", "real-lane48", "skewed"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", CASES)
def test_query_compressed_plain_matches_pallas_and_ref(kcases, case, dtype):
    """K5 raw best sums: port plain == Pallas (interpret) == jnp oracle,
    worklist pads routed to the trash row."""
    jar, s, t, wl = kcases[case]
    q, st, tt, first = _worklist(jar, s, t, pad_to=256)
    wq = np.concatenate([wl, [TRASH_LEVEL]]).astype(np.int32)
    j, tr = _comp_args(jar, dtype)
    wl_j = [jnp.asarray(a) for a in (q, st, tt, first, wq)]
    pallas = np.asarray(j_wq.wcsd_query_ragged_compressed(
        *j, *wl_j, interpret=True))
    ref = np.asarray(j_ref.wcsd_query_ragged_compressed_ref(
        j[0], j[1], j[2], j[3], wl_j[0], wl_j[1], wl_j[2], wl_j[4]))
    plain = t_wq.wcsd_query_ragged_compressed_plain(
        tr[0], tr[1], tr[2], tr[3], _tt(q), _tt(st), _tt(tt), _tt(wq))
    assert_same_array(pallas, ref)
    assert_same_array(plain.numpy(), pallas)
    k1 = t_wq.wcsd_query_ragged_plain(
        *(_tt(a) for a in (jar.hub, jar.dist, jar.wlev, q, st, tt, wq)))
    # hop distances are exact in both formats, the skewed store's (up to
    # 999) only in float16 (exact to 2048), not in bfloat16 (to 256)
    if case != "skewed" or dtype == "float16":
        assert_same_array(plain.numpy(), k1.numpy())
    else:
        assert not torch.equal(plain, k1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", CASES)
def test_profile_compressed_plain_matches_pallas_and_ref(kcases, case,
                                                         dtype):
    jar, s, t, _ = kcases[case]
    q, st, tt, first = _worklist(jar, s, t, pad_to=256)
    rows = len(s) + 1
    j, tr = _comp_args(jar, dtype)
    wl_j = [jnp.asarray(a) for a in (q, st, tt, first)]
    pallas = np.asarray(j_wq.wcsd_profile_ragged_compressed(
        *j, *wl_j, num_rows=rows, num_levels=W, interpret=True))
    ref = np.asarray(j_ref.wcsd_profile_ragged_compressed_ref(
        j[0], j[1], j[2], j[3], wl_j[0], wl_j[1], wl_j[2], rows, W))
    plain = t_wq.wcsd_profile_ragged_compressed_plain(
        tr[0], tr[1], tr[2], tr[3], _tt(q), _tt(st), _tt(tt), rows, W)
    assert_same_array(pallas, ref)
    assert_same_array(plain.numpy(), pallas)


def test_decode_of_large_distances_matches_oracle():
    """The in-kernel decode on distances far past bf16's exact range and
    on +inf pads: the plain K5 equals the reference oracle cell for cell
    (one single-cell tile per work item, joined with itself)."""
    d = _adversarial_distances()
    n = len(d)
    store = JPacked.from_flat(np.arange(n, dtype=np.int32), d,
                              np.ones(n, np.int32),
                              np.array([0, n], np.int64), lane=1)
    jar = store.arena(lane=1)
    for dtype in ("bfloat16", "float16"):
        j, tr = _comp_args(jar, dtype)
        k = np.arange(n, dtype=np.int32)
        wq = np.zeros(n, np.int32)
        ref = np.asarray(j_ref.wcsd_query_ragged_compressed_ref(
            j[0], j[1], j[2], j[3], jnp.asarray(k), jnp.asarray(k),
            jnp.asarray(k), jnp.asarray(wq)))
        plain = t_wq.wcsd_query_ragged_compressed_plain(
            tr[0], tr[1], tr[2], tr[3], _tt(k), _tt(k), _tt(k), _tt(wq))
        assert_same_array(plain.numpy(), ref)


@pytest.mark.parametrize("case", ["real-lane128", "skewed"])
def test_ops_compressed_wrappers_match_reference_ops(kcases, case):
    """The wrappers' post-processing (>= DEV_INF -> INF_DIST, suffix min
    over levels) equals the reference ops'."""
    jar, s, t, wl = kcases[case]
    q, st, tt, first = _worklist(jar, s, t)
    wq = np.concatenate([wl, [TRASH_LEVEL]]).astype(np.int32)
    j, tr = _comp_args(jar, "bfloat16")
    wj = [jnp.asarray(a) for a in (q, st, tt, first)]
    wt = [_tt(a) for a in (q, st, tt, first)]
    assert_same_array(
        t_ops.wcsd_query_ragged_compressed(*tr, *wt, _tt(wq)).numpy(),
        np.asarray(j_ops.wcsd_query_ragged_compressed(
            *j, *wj, jnp.asarray(wq), interpret=True, use_kernel=True)))
    rows = len(s) + 1
    assert_same_array(
        t_ops.wcsd_profile_ragged_compressed(*tr, *wt, num_rows=rows,
                                             num_levels=W).numpy(),
        np.asarray(j_ops.wcsd_profile_ragged_compressed(
            *j, *wj, num_rows=rows, num_levels=W, interpret=True,
            use_kernel=True)))


# ------------------------------------------------------------ the engine
def _grid(V, Wl):
    s, t, w = np.meshgrid(np.arange(V), np.arange(V), np.arange(Wl + 1),
                          indexing="ij")
    return (s.ravel().astype(np.int32), t.ravel().astype(np.int32),
            w.ravel().astype(np.int32))


@pytest.mark.parametrize("lane", [128, 16])
def test_compressed_engine_matches_reference_and_bfs(lane):
    """Every (s, t, w) and every profile: the compressed engine == the
    reference compressed engine (Pallas, interpret mode) == the BFS
    grid."""
    g = erdos_renyi(12, 3.5, num_levels=3, seed=41)
    idx = build_wc_index(g)
    D = constrained_distance_grid(g)
    s, t, wl = _grid(g.num_nodes, g.num_levels)
    eng = TEngine(port_index(idx, lane=lane), lane=lane, compressed=True,
                  device="cpu")
    assert eng.compressed is True and eng.compression_overflow is False
    assert eng._arena[0].dtype == torch.int16
    assert eng._arena[1].dtype == torch.bfloat16
    ref = JEngine(idx, layout="csr", lane=lane, compressed=True,
                  use_pallas=True, interpret=True)
    got = eng.query(s, t, wl)
    assert_same_array(got, D[s, t, wl])
    assert_same_array(got, np.asarray(ref.query(s, t, wl)))
    s2, t2 = s[::g.num_levels + 1], t[::g.num_levels + 1]
    prof = eng.query_profile(s2, t2)
    assert_same_array(prof, D[s2, t2, :])
    assert_same_array(prof, np.asarray(ref.query_profile(s2, t2)))


def test_overflow_store_is_served_uncompressed_and_flagged():
    """A store past the int16 delta is served from the uncompressed
    arena, flagged, with the reference's answers."""
    packed = _gap_store(I16_MAX + 10)
    pidx = JPackedIndex(order=np.arange(2, dtype=np.int64),
                        rank=np.arange(2, dtype=np.int64),
                        levels=np.array([1.0, 2.0, 3.0]), labels=packed)
    s, t, wl = _grid(2, pidx.num_levels)
    ref = JEngine(pidx, layout="csr", lane=8, compressed=True,
                  use_pallas=True, interpret=True)
    assert ref.compressed is False and ref.compression_overflow is True
    tidx = port_index(pidx, lane=8)
    eng = TEngine(tidx, lane=8, compressed=True, device="cpu")
    assert eng.compressed is False
    assert eng.compression_overflow is True
    assert eng._arena[0].dtype == torch.int32
    plain = TEngine(tidx, lane=8, device="cpu")
    assert_same_array(eng.query(s, t, wl), np.asarray(ref.query(s, t, wl)))
    assert_same_array(eng.query(s, t, wl), plain.query(s, t, wl))
    assert_same_array(eng.query_profile(s, t),
                      np.asarray(ref.query_profile(s, t)))
    assert int(eng.query(np.array([0]), np.array([1]), np.array([0]))[0]) \
        == 7


def test_compressed_requires_ragged_dispatch():
    from repro_torch.core.serve import WCSDServer
    g = erdos_renyi(8, 2.5, num_levels=2, seed=3)
    tidx = port_index(build_wc_index(g))
    with pytest.raises(ValueError, match="csr"):
        TEngine(tidx, dispatch="bucket_pair", compressed=True, device="cpu")
    with pytest.raises(ValueError, match="csr"):
        WCSDServer(tidx, dispatch="bucket_pair", compressed=True,
                   device="cpu")
    # the padded layout is ported; like the reference it refuses the
    # compressed arena
    with pytest.raises(ValueError, match="csr"):
        TEngine(tidx, layout="padded", compressed=True, device="cpu")
    with pytest.raises(ValueError, match="csr"):
        JEngine(build_wc_index(g), layout="padded", compressed=True)
