"""The sharded serving path of the port against the JAX package on the
CPU: the collectives (`distributed.collectives`) against the reference's
under `shard_map` on 8 virtual host devices, the row-sharded flush's
host planners against the reference's methods, `ShardedQueryEngine` in
every layout x dispatch x placement x mesh x compressed leg against the
reference's `DeviceQueryEngine`, its placement decision against the
reference's on the same meshes, `WCSDServer(backend="sharded")` (epoch,
continuous batching, dynamic) against the BFS grid, the fallback ladder
of a row-sharded compressed server and the chaos schedule against the
reference's, and the `launch.dryrun` launcher on 8 CPU shards.

The reference side of the 8-device comparisons runs in one subprocess
(the virtual device count must be set before jax starts), fed and read
through ``.npz`` files; everything else runs in this process. The bar is
exact equality throughout.
"""
import inspect
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _torch_parity import port_graph, port_index
from repro.core.baselines import constrained_distance_grid
from repro.core.generators import erdos_renyi, random_queries, scale_free
from repro.core.graph import mutate_edges
from repro.core.query import DeviceQueryEngine as JDevice
from repro.core.query import ShardedQueryEngine as JSharded
from repro.core.wc_index import build_wc_index
from repro_torch.core.query import ShardedQueryEngine
from repro_torch.core.serve import WCSDServer
from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import batch_axes, make_serving_mesh

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(REPO, "src")
CPU8 = [torch.device("cpu")] * 8
CHAOS = (120, 7, 60)       # steps, seed, crash step: the dry run's quick leg

REF_PROG = r"""
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import tempfile  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core.query import ShardedQueryEngine, shard_map_compat  # noqa
from repro.distributed import collectives as C  # noqa: E402
from repro.launch.mesh import make_serving_mesh  # noqa: E402

T0 = time.time()
inp = dict(np.load(sys.argv[1]))
out = {}
assert len(jax.devices()) == 8
for tag, mp in (("1d", False), ("2x4", True)):
    mesh = make_serving_mesh(multi_pod=mp)
    ax = ("pod", "data") if mp else ("data",)

    def run(fn, in_specs, out_specs, *args):
        return jax.jit(shard_map_compat(fn, mesh, in_specs, out_specs))(*args)

    store, store2, col, rows = (inp[k] for k in ("store", "store2", "col",
                                                 "rows"))
    per = store.shape[0] // 8
    out[f"{tag}_lin"] = np.asarray(run(
        lambda x: x + C.axis_linear_index(ax), (P(ax),), P(ax),
        np.zeros(8, np.int32)))
    out[f"{tag}_slice"] = np.asarray(run(
        lambda x: C.batch_slice(x, ax, x.shape[0] // 8), (P(None),), P(ax),
        rows))
    out[f"{tag}_gather"] = np.asarray(run(
        lambda sh, rr: C.row_gather_psum(sh, rr, ax, per),
        (P(ax, None), P(None)), P(None), store, rows))
    out[f"{tag}_scatter"] = np.asarray(run(
        lambda sh, rr: C.row_gather_psum_scatter(sh, rr, ax, per),
        (P(ax, None), P(None)), P(ax), store, rows))
    for i, a in enumerate(run(
            lambda a, b, c, rr: C.multi_row_gather_psum_scatter(
                (a, b, c), rr, ax, per),
            (P(ax, None),) * 3 + (P(None),), (P(ax),) * 3,
            store, store2, col, rows)):
        out[f"{tag}_multi{i}"] = np.asarray(a)
    tper = inp["hub16"].shape[0] // 8
    for fmt, bits in (("bf16", inp["dbf16"]), ("f16", inp["df16"])):
        fdt = jnp.bfloat16 if fmt == "bf16" else jnp.float16

        def tiles(h, d, w, rr, fdt=fdt):
            d = jax.lax.bitcast_convert_type(d, fdt)
            gh, gd, gw = C.ragged_tile_gather((h, d, w), rr, ax, tper)
            return gh, jax.lax.bitcast_convert_type(gd, jnp.int16), gw
        got = run(tiles, (P(ax, None),) * 3 + (P(None),), (P(ax),) * 3,
                  inp["hub16"], bits.view(np.int16), inp["wlev8"],
                  inp["trows"])
        for i, a in enumerate(got):
            out[f"{tag}_tiles_{fmt}{i}"] = np.asarray(a)
    for i, a in enumerate(run(
            lambda h, d, w, rr: C.ragged_tile_gather((h, d, w), rr, ax,
                                                     tper),
            (P(ax, None),) * 3 + (P(None),), (P(ax),) * 3,
            inp["h32"], inp["d32"], inp["w32"], inp["trows"])):
        out[f"{tag}_tiles_i32{i}"] = np.asarray(a)
mesh2 = make_serving_mesh(multi_pod=True)
out["hpsum"] = np.asarray(jax.jit(shard_map_compat(
    lambda x: C.hierarchical_psum(x, "pod", "data"), mesh2,
    (P(("pod", "data")),), P(("pod", "data"))))(inp["psum_x"]))
print("collectives", time.time() - T0, flush=True)

# placement: mode and store_bytes_per_device on the 8-device meshes
from repro.core.generators import erdos_renyi, scale_free  # noqa: E402
from repro.core.wc_index import build_wc_index  # noqa: E402


def instances():
    yield "er12", build_wc_index(erdos_renyi(12, 3.5, num_levels=3, seed=5))
    yield "er10", build_wc_index(erdos_renyi(10, 2.5, num_levels=2, seed=11))
    yield "sf150", build_wc_index(scale_free(150, 3, num_levels=4, seed=12),
                                  ordering="degree")


LEGS = (("csr", "ragged", False), ("csr", "ragged", True),
        ("csr", "bucket_pair", False), ("padded", "ragged", False))
for name, idx in instances():
    for mp in (False, True):
        mesh = make_serving_mesh(multi_pod=mp)
        for layout, dispatch, comp in LEGS:
            key = f"place_{name}_{int(mp)}_{layout}_{dispatch}_{int(comp)}"
            full = ShardedQueryEngine(idx, mesh=mesh, layout=layout,
                                      dispatch=dispatch, compressed=comp,
                                      use_pallas=True, interpret=True)
            b = full.store_bytes_per_device
            rec = []
            for budget in (-1, 1, b, b - 1):
                e = ShardedQueryEngine(
                    idx, mesh=mesh, layout=layout, dispatch=dispatch,
                    compressed=comp, use_pallas=True, interpret=True,
                    device_budget_bytes=None if budget < 0 else budget)
                rec.append((budget, int(e.mode == "sharded_labels"),
                            e.store_bytes_per_device, int(e.compressed)))
            out[key] = np.array(rec, dtype=np.int64)
print("placement", time.time() - T0, flush=True)

# the chaos schedule over the sharded backend
from repro.checkpoint.fault import run_chaos_schedule  # noqa: E402
KEYS = ("submitted", "answered", "updates", "crashes", "integrity_probes",
        "wal_probes", "replayed_records", "graph_version", "injected",
        "wal_appends")
with tempfile.TemporaryDirectory() as tmp:
    s = run_chaos_schedule(server_kwargs={"backend": "sharded",
                                          "mesh": make_serving_mesh()},
                           steps=int(inp["chaos"][0]),
                           seed=int(inp["chaos"][1]),
                           crash_step=int(inp["chaos"][2]), workdir=tmp)
out["chaos"] = np.array([s[k] for k in KEYS], dtype=np.int64)
out["chaos_primary"] = np.array(s["final_mode"] == "primary")
print("chaos", time.time() - T0, flush=True)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The sharded paths issue many small ops a shard: one intra-op
    thread keeps them from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _collective_inputs() -> dict:
    rng = np.random.default_rng(0)
    V, W, B, T, lane = 64, 16, 32, 40, 16
    d = {"store": rng.integers(-5, 100, (V, W)).astype(np.int32),
         "store2": rng.integers(0, 7, (V, 3)).astype(np.int32),
         "col": rng.integers(1, 50, (V, 1)).astype(np.int32)}
    rows = rng.integers(0, V, B).astype(np.int32)
    rows[[3, 9, 20]] = [-3, V, V + 40]          # owned by no shard: zeros
    d["rows"] = rows
    d["hub16"] = rng.integers(-1, 3000, (T, lane)).astype(np.int16)
    f = rng.uniform(0, 300, (T, lane))
    f[rng.random((T, lane)) < 0.1] = np.inf
    ft = torch.from_numpy(f)
    d["dbf16"] = ft.to(torch.bfloat16).view(torch.int16).numpy()
    d["df16"] = ft.to(torch.float16).view(torch.int16).numpy()
    d["wlev8"] = rng.integers(-1, 6, (T, lane)).astype(np.int8)
    d["h32"] = rng.integers(-1, 3000, (T, lane)).astype(np.int32)
    d["d32"] = rng.integers(0, 1 << 30, (T, lane)).astype(np.int32)
    d["w32"] = rng.integers(-1, 6, (T, lane)).astype(np.int32)
    trows = np.sort(rng.integers(0, T, (8, 12)), axis=1).astype(np.int32)
    trows[2, -1], trows[5, -2:] = T, [T, T + 7]  # past the last tile
    d["trows"] = trows.reshape(-1)
    d["psum_x"] = rng.integers(-100, 100, (8, 5)).astype(np.int32)
    d["chaos"] = np.array(CHAOS)
    return d


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's collectives, placements and chaos counts on 8
    virtual host devices, from one subprocess."""
    d = tmp_path_factory.mktemp("sharded_ref")
    inp = _collective_inputs()
    np.savez(d / "in.npz", **inp)
    (d / "ref.py").write_text(REF_PROG)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(d / "ref.py"), str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return inp, dict(np.load(d / "out.npz"))


def _blocks(a: np.ndarray, n: int = 8):
    per = a.shape[0] // n
    return [torch.from_numpy(np.ascontiguousarray(a[k * per:(k + 1) * per]))
            for k in range(n)], per


def _cat(xs):
    return torch.cat(list(xs)).numpy()


# ------------------------------------------------------------ the mesh
def test_serving_mesh():
    m = make_serving_mesh(CPU8)
    assert m.axis_names == ("data",) and m.shape == (8,) and m.size == 8
    assert m.physical_devices() == (torch.device("cpu"),)
    m2 = make_serving_mesh(CPU8, multi_pod=True)
    assert m2.axis_names == ("pod", "data") and m2.shape == (2, 4)
    assert batch_axes(True) == ("pod", "data")
    assert batch_axes(False) == ("data",)
    with pytest.raises(ValueError, match="even"):
        make_serving_mesh(CPU8[:3], multi_pod=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_serving_mesh()


# ------------------------------------------------------ (a) collectives
@pytest.mark.parametrize("mesh", ["1d", "2x4"])
def test_collectives_match_reference(reference, mesh):
    inp, out = reference
    shape = (8,) if mesh == "1d" else (2, 4)
    coords = ([(k,) for k in range(8)] if mesh == "1d"
              else [(p, q) for p in range(2) for q in range(4)])
    np.testing.assert_array_equal(
        [C.axis_linear_index(c, shape) for c in coords], out[f"{mesh}_lin"])
    rows = inp["rows"]
    store, per = _blocks(inp["store"])
    B = len(rows)
    np.testing.assert_array_equal(
        _cat(C.batch_slice(torch.from_numpy(rows), k, B // 8)
             for k in range(8)), out[f"{mesh}_slice"])
    for g in C.row_gather_psum(store, rows, per):
        np.testing.assert_array_equal(g.numpy(), out[f"{mesh}_gather"])
    np.testing.assert_array_equal(
        _cat(C.row_gather_psum_scatter(store, rows, per)),
        out[f"{mesh}_scatter"])
    arrays = [store, _blocks(inp["store2"])[0], _blocks(inp["col"])[0]]
    got = C.multi_row_gather_psum_scatter(arrays, rows, per)
    for i in range(3):
        np.testing.assert_array_equal(_cat(g[i] for g in got),
                                      out[f"{mesh}_multi{i}"])
    trows = inp["trows"]
    h16, tper = _blocks(inp["hub16"])
    w8 = _blocks(inp["wlev8"])[0]
    for fmt, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        d16 = [b.view(dt) for b in _blocks(inp["d" + fmt])[0]]
        got = C.ragged_tile_gather((h16, d16, w8), trows, tper)
        assert got[0][1].dtype == dt and got[0][2].dtype == torch.int8
        np.testing.assert_array_equal(_cat(g[0] for g in got),
                                      out[f"{mesh}_tiles_{fmt}0"])
        np.testing.assert_array_equal(
            _cat(g[1].view(torch.int16) for g in got),
            out[f"{mesh}_tiles_{fmt}1"])
        np.testing.assert_array_equal(_cat(g[2] for g in got),
                                      out[f"{mesh}_tiles_{fmt}2"])
    i32 = [_blocks(inp[k])[0] for k in ("h32", "d32", "w32")]
    got = C.ragged_tile_gather(i32, trows, tper)
    for i in range(3):
        np.testing.assert_array_equal(_cat(g[i] for g in got),
                                      out[f"{mesh}_tiles_i32{i}"])


def test_hierarchical_psum_matches_reference(reference):
    inp, out = reference
    xs = [torch.from_numpy(inp["psum_x"][k:k + 1]) for k in range(8)]
    np.testing.assert_array_equal(_cat(C.hierarchical_psum(xs, (2, 4))),
                                  out["hpsum"])


def test_gather_takes_host_or_device_row_ids():
    store, per = _blocks(np.arange(64 * 3, dtype=np.int32).reshape(64, 3))
    rows = np.array([5, 63, 0, 17, 64, -1, 40, 8], np.int32)
    a = C.row_gather_psum_scatter(store, rows, per)
    b = C.row_gather_psum_scatter(store, torch.from_numpy(rows), per)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    exp = np.where((rows >= 0)[:, None] & (rows < 64)[:, None],
                   np.arange(192).reshape(64, 3)[np.clip(rows, 0, 63)], 0)
    np.testing.assert_array_equal(_cat(a), exp)
    with pytest.raises(ValueError, match="split"):
        C.row_gather_psum_scatter(store, rows[:5], per)
    mixed = C.multi_row_gather_psum_scatter(     # any dtype, any rank
        [store, [b.to(torch.int16) for b in store],
         [b[:, 0].to(torch.bfloat16) for b in store]], rows, per)
    np.testing.assert_array_equal(_cat(g[1] for g in mixed), exp)
    assert mixed[0][1].dtype == torch.int16
    np.testing.assert_array_equal(
        _cat(g[2].float() for g in mixed), exp[:, 0].astype(np.float32))


# ----------------------------------------------------- instances, indices
INSTANCES = {
    "er12": lambda: (erdos_renyi(12, 3.5, num_levels=3, seed=5), {}),
    "er10": lambda: (erdos_renyi(10, 2.5, num_levels=2, seed=11), {}),
    "sf150": lambda: (scale_free(150, 3, num_levels=4, seed=12),
                      {"ordering": "degree"}),
}
LEGS = (("csr", "ragged", False), ("csr", "ragged", True),
        ("csr", "bucket_pair", False), ("padded", "ragged", False))


@pytest.fixture(scope="module")
def worlds():
    """name -> (graph, reference index, port index, queries)."""
    out = {}
    for name, make in INSTANCES.items():
        g, kw = make()
        jidx = build_wc_index(g, **kw)
        V, W = g.num_nodes, g.num_levels
        if V <= 16:
            s, t, wl = np.meshgrid(np.arange(V), np.arange(V),
                                   np.arange(W + 1), indexing="ij")
            q = tuple(a.ravel().astype(np.int32) for a in (s, t, wl))
        else:
            q = random_queries(g, 300, seed=3)
        out[name] = (g, jidx, port_index(jidx), q)
    return out


# --------------------------------------------------- (b) host planners
@pytest.mark.parametrize("ndev", [1, 2, 8])
@pytest.mark.parametrize("clustered", [False, True])
def test_host_planners_match_reference(worlds, ndev, clustered):
    """The row-sharded flush's planners, called unbound on a stand-in
    engine, give the reference's outputs on the same staged batch."""
    _, _, tidx, _ = worlds["sf150"]
    ar = tidx.packed(lane=8).arena(lane=8)     # rows of several tiles
    ns = types.SimpleNamespace(ndev=ndev, _tile_cnt_np=ar.tile_cnt,
                               _tile_base_np=ar.tile_base,
                               _num_tiles_np=int(ar.num_tiles))
    rng = np.random.default_rng(ndev)
    n = 40 * ndev
    s = rng.integers(0, tidx.num_nodes, n).astype(np.int32)
    t = rng.integers(0, tidx.num_nodes, n).astype(np.int32)
    if clustered:     # the heaviest rows first: one shard would take all
        hot = np.argsort(-ar.tile_cnt, kind="stable")[:4]
        s[: n // 4] = hot[rng.integers(0, 4, n // 4)]
        t[: n // 4] = hot[rng.integers(0, 4, n // 4)]
    stq = np.stack([s, t, rng.integers(0, 5, n).astype(np.int32)])
    jb, jperm = JSharded._balance_ragged(ns, stq)
    tb, tperm = ShardedQueryEngine._balance_ragged(ns, stq)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tperm, jperm)
    b = n // ndev
    for st, jcap in ((stq, JSharded._shard_worklist_len(ns, stq)),
                     (tb, JSharded._balanced_worklist_len(ns, tb))):
        # each shard's worklist is its slice's exact tile-pair count, no
        # longer than the reference's padded capacity
        lens = ShardedQueryEngine._shard_worklist_lens(ns, st)
        exact = (ar.tile_cnt[st[0]].astype(np.int64)
                 * ar.tile_cnt[st[1]]).reshape(ndev, b).sum(1)
        assert lens == exact.tolist() and max(lens) <= jcap
        # the same tile sets, padded only to the largest shard's count
        ju, _ = JSharded._gather_plan(ns, st, jcap)
        tu = ShardedQueryEngine._gather_plan(ns, st)
        G = max(len(np.unique(u)) for u in tu)
        assert tu.shape == (ndev, G) and G <= ju.shape[1]
        np.testing.assert_array_equal(tu, ju[:, :G])
    if clustered and ndev > 1:   # balancing pays: the heaviest slice
        def heaviest(st):        # comes down towards the mean
            c = ar.tile_cnt[st[0]].astype(np.int64) * ar.tile_cnt[st[1]]
            return c.reshape(ndev, -1).sum(1).max()
        assert heaviest(tb) < heaviest(stq)


# ---------------------------------------------------- (c) engine answers
@pytest.fixture(scope="module")
def expected(worlds):
    """(name, layout, dispatch) -> the reference `DeviceQueryEngine`'s
    answers and its per-level profile loop."""
    cache = {}

    def get(name, layout, dispatch):
        key = (name, layout, dispatch)
        if key not in cache:
            g, jidx, _, (s, t, wl) = worlds[name]
            eng = JDevice(jidx, layout=layout, dispatch=dispatch)
            exp = np.asarray(eng.query(s, t, wl))
            prof = np.stack([np.asarray(eng.query(
                s, t, np.full(len(s), w, np.int32)))
                for w in range(g.num_levels + 1)], axis=1)
            cache[key] = (exp, prof)
        return cache[key]
    return get


@pytest.mark.parametrize("leg", LEGS, ids=lambda x: "-".join(map(str, x)))
@pytest.mark.parametrize("name", list(INSTANCES))
def test_engine_answers_match_reference(worlds, expected, name, leg):
    layout, dispatch, compressed = leg
    _, _, tidx, (s, t, wl) = worlds[name]
    exp, prof = expected(name, layout, dispatch)
    meshes = [make_serving_mesh(CPU8), make_serving_mesh(CPU8, multi_pod=True),
              make_serving_mesh(CPU8[:1])]
    pallas = (True, False) if layout == "padded" else (True,)
    for mesh in meshes:
        for budget in (None, 1):
            for use_pallas in pallas:
                eng = ShardedQueryEngine(
                    tidx, mesh=mesh, layout=layout, dispatch=dispatch,
                    compressed=compressed, device_budget_bytes=budget,
                    use_pallas=use_pallas)
                tag = (mesh.shape, budget, use_pallas)
                assert eng.mode == ("replicated" if budget is None
                                    else "sharded_labels"), tag
                assert eng.compressed == compressed, tag
                np.testing.assert_array_equal(eng.query(s, t, wl), exp,
                                              err_msg=str(tag))
                np.testing.assert_array_equal(eng.query_profile(s, t), prof,
                                              err_msg=str(tag))


def test_engine_refuses_what_the_reference_refuses(worlds):
    tidx = worlds["er12"][2]
    mesh = make_serving_mesh(CPU8)
    for kw, match in ((dict(layout="nope"), "layout"),
                      (dict(dispatch="dense"), "dispatch"),
                      (dict(layout="csr", cap=4), "cap"),
                      (dict(dispatch="bucket_pair", compressed=True),
                       "compressed"),
                      (dict(use_pallas=False), "use_pallas")):
        with pytest.raises(ValueError, match=match):
            ShardedQueryEngine(tidx, mesh=mesh, **kw)
    with pytest.raises(ValueError, match="batch axis"):
        ShardedQueryEngine(tidx, mesh=mesh.__class__(
            tuple(CPU8), ("model",), (8,)))


def test_compressed_row_shard_pads_are_inf(worlds):
    """The compressed dist pad of a row-sharded arena is the bit pattern
    of +inf in the arena's float format (bf16 0x7F80)."""
    _, _, tidx, _ = worlds["sf150"]
    eng = ShardedQueryEngine(tidx, mesh=make_serving_mesh(CPU8),
                             compressed=True, device_budget_bytes=1)
    T = eng.arena.num_tiles
    assert eng.compressed and T % 8 and eng._tiles_per * 8 > T
    last = eng._blocks[1][-1]
    pads = last[T - 7 * eng._tiles_per:]
    assert pads.dtype == torch.int16
    assert (pads == 0x7F80).all()
    assert (eng._blocks[0][-1][T - 7 * eng._tiles_per:] == -1).all()
    assert (eng._blocks[2][-1][T - 7 * eng._tiles_per:] == -1).all()


# ---------------------------------------------------- (d) placement
@pytest.mark.parametrize("name", list(INSTANCES))
def test_placement_matches_reference(reference, worlds, name):
    """mode and store_bytes_per_device equal the reference's on 8
    devices (1-D and 2x4) for the same budgets: none, 1 byte, exactly the
    replicated bytes, and one byte less."""
    _, out = reference
    _, _, tidx, _ = worlds[name]
    for mp in (False, True):
        mesh = make_serving_mesh(CPU8, multi_pod=mp)
        for layout, dispatch, comp in LEGS:
            rec = out[f"place_{name}_{int(mp)}_{layout}_{dispatch}_"
                      f"{int(comp)}"]
            for budget, sharded, nbytes, engine_comp in rec:
                eng = ShardedQueryEngine(
                    tidx, mesh=mesh, layout=layout, dispatch=dispatch,
                    compressed=comp,
                    device_budget_bytes=None if budget < 0 else int(budget))
                tag = (mp, layout, dispatch, comp, int(budget))
                assert eng.mode == ("sharded_labels" if sharded
                                    else "replicated"), tag
                assert eng.store_bytes_per_device == nbytes, tag
                assert eng.compressed == bool(engine_comp), tag


# ------------------------------------------------------- (e) servers
@pytest.fixture(scope="module")
def serve_world():
    g = erdos_renyi(40, 3.0, num_levels=4, seed=2)
    jidx = build_wc_index(g, ordering="degree")
    return g, port_index(jidx), constrained_distance_grid(g)


@pytest.mark.parametrize("budget,compressed", [(None, False), (1, False),
                                               (1, True)])
def test_sharded_servers_match_bfs_grid(serve_world, budget, compressed):
    g, tidx, D = serve_world
    s, t, wl = random_queries(g, 300, seed=7)
    ps, pt, _ = random_queries(g, 80, seed=8)
    kw = dict(backend="sharded", mesh=make_serving_mesh(CPU8),
              device_budget_bytes=budget, compressed=compressed,
              max_batch=128)
    srv = WCSDServer(tidx, **kw)
    assert isinstance(srv.engine, ShardedQueryEngine)
    assert srv.device == torch.device("cpu")
    np.testing.assert_array_equal(srv.query_many(s, t, wl), D[s, t, wl])
    np.testing.assert_array_equal(srv.query_profile_many(ps, pt), D[ps, pt])
    assert not srv.results and not srv.profile_results
    cb = WCSDServer(tidx, max_wait_us=200.0, min_batch=32, **kw)
    rids = [cb.submit(int(a), int(b), int(c))
            for a, b, c in zip(s[:160], t[:160], wl[:160])]
    prids = [cb.submit_profile(int(a), int(b))
             for a, b in zip(ps[:32], pt[:32])]
    cb.flush()
    np.testing.assert_array_equal([cb.result(r) for r in rids],
                                  D[s[:160], t[:160], wl[:160]])
    np.testing.assert_array_equal(
        np.stack([cb.profile_result(r) for r in prids]), D[ps[:32], pt[:32]])
    assert cb.stats.opportunistic_flushes > 0


@pytest.mark.parametrize("budget", [None, 1])
def test_dynamic_sharded_server_after_updates(serve_world, budget):
    """A dynamic server over the sharded backend serves the
    delta-extended arena: every answer after two update batches equals
    the BFS grid of the mutated graph."""
    g, tidx, _ = serve_world
    srv = WCSDServer(tidx, graph=port_graph(g), backend="sharded",
                     mesh=make_serving_mesh(CPU8, multi_pod=True),
                     device_budget_bytes=budget, compact_threshold=None,
                     max_batch=128)
    cur = g
    for ins, dels in (([(0, 39, float(g.levels[2]))], [(int(g.edges_src[0]),
                                                       int(g.edges_dst[0]))]),
                      ([(5, 21, float(g.levels[-1]))], [])):
        srv.apply_updates(inserts=ins, deletes=dels)
        cur = mutate_edges(cur, inserts=ins, deletes=dels)
        assert isinstance(srv.engine, ShardedQueryEngine)
        assert srv.engine.mode == ("replicated" if budget is None
                                   else "sharded_labels")
        D = constrained_distance_grid(cur)
        s, t, wl = random_queries(cur, 200, seed=srv.graph_version)
        np.testing.assert_array_equal(srv.query_many(s, t, wl), D[s, t, wl])
        np.testing.assert_array_equal(srv.query_profile_many(s, t), D[s, t])
    assert not srv.index.delta.is_empty()


def test_server_config_plumbing(serve_world):
    """`ServeConfig.server_kwargs` are `WCSDServer` keywords, the
    reference's but ``interpret``; ``multi_pod`` reaches the mesh."""
    from repro.configs.wcsd_serve import ServeConfig as JConfig
    from repro_torch.configs.wcsd_serve import (ServeConfig, serve_config,
                                                smoke_serve_config)
    g, tidx, D = serve_world
    params = set(inspect.signature(WCSDServer).parameters)
    kw = ServeConfig().server_kwargs()
    assert set(kw) <= params
    assert set(kw) == set(JConfig().server_kwargs()) - {"interpret"}
    assert serve_config().max_batch == 4096 and \
        smoke_serve_config().max_batch == 256
    srv = WCSDServer(tidx, mesh=make_serving_mesh(CPU8, multi_pod=True),
                     **ServeConfig(multi_pod=True, max_batch=32)
                     .server_kwargs())
    assert srv.engine.mesh.axis_names == ("pod", "data")
    s = np.arange(30, dtype=np.int32)
    np.testing.assert_array_equal(srv.query_many(s, s, np.zeros(30,
                                                                np.int32)),
                                  np.zeros(30, np.int32))
    with pytest.raises(ValueError, match="backend"):
        WCSDServer(tidx, device="cpu", backend="nope")


# ------------------------------------------------------- (f) the ladder
def test_row_sharded_ladder_matches_reference(serve_world):
    """A row-sharded compressed sharded server under a fault schedule
    walks uncompressed -> replicated -> single_device -> bucket_pair ->
    oracle and back up, with the reference server's answers, mode stamps,
    retry counters and fault draws for the same config; the
    single_device rung is a `DeviceQueryEngine` on the server's device."""
    import jax
    from repro.checkpoint.fault import FaultSchedule as JSchedule
    from repro.checkpoint.fault import FaultyEngine as JFaulty
    from repro.core.serve import WCSDServer as JServer
    from repro.launch.mesh import make_serving_mesh as j_mesh
    from repro_torch.checkpoint.fault import FaultSchedule, FaultyEngine
    sys.path.insert(0, REPO)
    from chip_smoke import ladder_walk

    g, tidx, D = serve_world
    jidx = build_wc_index(g, ordering="degree")
    rungs = ["primary", "uncompressed", "replicated", "single_device",
             "bucket_pair", "oracle"]
    demotions = len(rungs) - 1
    flushes, per = 4 + 3 * demotions, 16
    q = random_queries(g, flushes * per, seed=11)
    p = random_queries(g, flushes * per // 4, seed=12)[:2]
    common = dict(backend="sharded", layout="csr", dispatch="ragged",
                  compressed=True, device_budget_bytes=1, max_batch=4096,
                  flush_timeout_ms=500.0, max_retries=1, probe_interval=2,
                  backoff_base_ms=0.01, retry_seed=3, memo_capacity=0)
    walk = ladder_walk(demotions)
    ts, js = FaultSchedule(fixed=walk), JSchedule(fixed=walk)
    built = []

    def wrap(e):
        built.append((type(e).__name__, getattr(e, "mode", None),
                      e.compressed, str(getattr(e, "device", None))))
        return FaultyEngine(e, ts)

    tsrv = WCSDServer(tidx, mesh=make_serving_mesh(CPU8), engine_wrapper=wrap,
                      **common)
    jsrv = JServer(jidx, mesh=j_mesh(jax.devices()[:1]),
                   engine_wrapper=lambda e: JFaulty(e, js), **common)
    got = _walk(tsrv, q, p, flushes, per)
    exp = _walk(jsrv, q, p, flushes, per)
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[2], exp[2])
    assert got[1] == exp[1] and got[3] == exp[3]
    assert set(got[1]) == set(rungs)
    for k in ("timeout_retries", "error_retries", "exhausted", "demotions",
              "promotions", "batches"):
        assert getattr(tsrv.stats, k) == getattr(jsrv.stats, k), k
    assert ts.injected == js.injected and ts.draws == js.draws
    assert tsrv.mode == jsrv.mode == "primary"
    np.testing.assert_array_equal(got[0], D[q[0], q[1], q[2]])
    down = built[:demotions + 1]
    assert down == [
        ("ShardedQueryEngine", "sharded_labels", True, "cpu"),
        ("ShardedQueryEngine", "sharded_labels", False, "cpu"),
        ("ShardedQueryEngine", "replicated", False, "cpu"),
        ("DeviceQueryEngine", None, False, "cpu"),
        ("DeviceQueryEngine", None, False, "cpu"),
        ("DeviceQueryEngine", None, False, "cpu")], down


def _walk(srv, queries, profiles, flushes, per):
    """``flushes`` flushes of ``per`` scalar + ``per // 4`` profile
    requests; the answers and the rung each was stamped with."""
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


# -------------------------------------------------------- (g) chaos
CHAOS_KEYS = ("submitted", "answered", "updates", "crashes",
              "integrity_probes", "wal_probes", "replayed_records",
              "graph_version", "injected", "wal_appends")


def test_sharded_chaos_matches_reference(reference, tmp_path):
    """The dry run's sharded chaos leg through the port on 8 CPU shards:
    every answer equals the BFS oracle at its stamped version (the
    harness raises otherwise), and the schedule-driven counts equal the
    reference's on 8 virtual devices."""
    from repro_torch.checkpoint.fault import run_chaos_schedule
    _, out = reference
    steps, seed, crash = CHAOS
    got = run_chaos_schedule(dict(backend="sharded",
                                  mesh=make_serving_mesh(CPU8)),
                             steps=steps, seed=seed, crash_step=crash,
                             workdir=str(tmp_path))
    assert [got[k] for k in CHAOS_KEYS] == out["chaos"].tolist()
    assert got["final_mode"] == "primary" and bool(out["chaos_primary"])
    assert got["answered"] == got["submitted"]


# ------------------------------------------------------ (h) the launcher
def test_dryrun_launcher_on_cpu_shards():
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--serve", "--chaos", "--quick", "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "serve dryrun PASS on 8 shards" in r.stdout
    assert "chaos dryrun PASS on 8 shards" in r.stdout
    # 2 instances x (4 csr-ragged + 4 bucket-pair + 4 padded + 4
    # compressed) engine legs
    assert r.stdout.count("queries + profiles bit-identical") == 32
    assert r.stdout.count("(+profiles)") == 2
