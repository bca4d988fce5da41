"""The dry-run matrix of the port (`repro_torch.configs` cells,
`launch.mesh`, `launch.dryrun`, `launch.roofline`) against the JAX
package on the CPU.

The reference's side runs in one subprocess on 512 virtual host devices
(the device count must be set before jax starts): it builds all 84
cells (the 40 of `all_cells` on both production meshes and wcsd-serve's
2 x 2), their abstract outputs (`jax.eval_shape`, once a cell) and the
per-device bytes of every argument and output leaf under
`NamedSharding(mesh, spec).shard_shape`, and writes them as JSON. The
port's cells must equal them exactly: kind, name, meta, every argument
leaf's path, shape and dtype, every in- and out-sharding entry, the
donated arguments, the abstract outputs, and the per-card argument and
output bytes on both meshes. Also here: the serve cells' functions at
`smoke_config` sizes answer exactly as `query_batch_jnp` /
`profile_batch_jnp`; `roofline_row` on a hand-made record; the meta
routes (segment backend, kernel wrappers, a decode position) and a
meta-tensor training step of each family; the CLI on the CPU.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.query import profile_batch_jnp, query_batch_jnp

from repro_torch.configs import ARCHS, EXTRA_ARCHS, all_cells, get_arch
from repro_torch.configs import gnn_common as gnc
from repro_torch.configs import lm_common as lmc
from repro_torch.configs import wcsd_serve
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import (Spec, make_production_mesh,
                                     shard_shape)
from repro_torch.launch.op_analysis import OpCounter, count_step
from repro_torch.models import common as C
from repro_torch.train.tree import flatten_with_paths

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(REPO, "src")

REF_PROG = r"""
import json
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import all_cells, get_arch  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402

assert len(jax.devices()) == 512


def key(k):
    if isinstance(k, jax.tree_util.DictKey):
        return str(k.key)
    if isinstance(k, jax.tree_util.SequenceKey):
        return str(k.idx)
    if isinstance(k, jax.tree_util.GetAttrKey):
        return "." + k.name
    raise TypeError(k)


def leaves(tree):
    return {"/".join(key(k) for k in path): [list(x.shape), str(x.dtype)]
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def plain(x):
    if x is None:
        return None
    if isinstance(x, P):
        return ["P"] + [list(e) if isinstance(e, tuple) else e for e in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return [type(x).__name__, {f: plain(getattr(x, f))
                                   for f in x._fields}]
    return [plain(v) for v in x]


def nbytes(tree, specs, mesh):
    if specs is None or isinstance(specs, P):
        sh = NamedSharding(mesh, specs if specs is not None else P())
        return sum(int(np.prod(sh.shard_shape(x.shape))) * x.dtype.itemsize
                   for x in jax.tree_util.tree_leaves(tree))
    if isinstance(tree, dict):
        return sum(nbytes(tree[k], specs[k], mesh) for k in tree)
    return sum(nbytes(a, b, mesh) for a, b in zip(tree, specs))


cells = []
for mp in (False, True):
    cells += [(n, s, c, mp) for n, s, c in all_cells(mp)]
    w = get_arch("wcsd-serve")
    cells += [("wcsd-serve", s, w.make_cell(s, multi_pod=mp), mp)
              for s in w.SHAPES]
outs = {}
out = {}
with jax.set_mesh(make_production_mesh(multi_pod=False)):
    for n, s, c, mp in cells:
        if not mp:
            outs[(n, s)] = jax.eval_shape(c.fn, *c.args)
for n, s, c, mp in cells:
    mesh = make_production_mesh(multi_pod=mp)
    o = outs[(n, s)]
    out[f"{n}|{s}|{int(mp)}"] = {
        "kind": c.kind, "name": c.name, "meta": c.meta,
        "args": leaves(c.args), "outs": leaves(o),
        "in_shardings": plain(c.in_shardings),
        "out_shardings": plain(c.out_shardings),
        "donate_argnums": list(c.donate_argnums),
        "argument_bytes": nbytes(c.args, c.in_shardings, mesh),
        "output_bytes": nbytes(o, c.out_shardings, mesh)}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def plain(x):
    """The port's sharding tree in the reference program's spelling."""
    if x is None:
        return None
    if isinstance(x, Spec):
        return ["P"] + [list(e) if isinstance(e, tuple) else e for e in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return [type(x).__name__, {f: plain(getattr(x, f))
                                   for f in x._fields}]
    return [plain(v) for v in x]


def leaves(tree) -> dict:
    return {p: [list(t.shape), str(t.dtype).replace("torch.", "")]
            for p, t in flatten_with_paths(tree).items()}


def jsonable(x):
    return json.loads(json.dumps(x))


class Reference:
    """The reference program, started at first use and read once."""

    def __init__(self, tmp):
        self.path = tmp / "ref.json"
        (tmp / "ref.py").write_text(REF_PROG)
        env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
        env.pop("XLA_FLAGS", None)
        self.proc = subprocess.Popen(
            [sys.executable, str(tmp / "ref.py"), str(self.path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self._cells = None

    def cells(self) -> dict:
        if self._cells is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, f"{out}\n{err}"
            with open(self.path) as f:
                self._cells = json.load(f)
        return self._cells


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(tmp_path_factory.mktemp("dryrun_ref"))
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


@pytest.fixture(scope="module")
def port_cells():
    cells = {}
    for mp in (False, True):
        for n, s, c in all_cells(mp):
            cells[f"{n}|{s}|{int(mp)}"] = c
        w = get_arch("wcsd-serve")
        for s in w.SHAPES:
            cells[f"wcsd-serve|{s}|{int(mp)}"] = w.make_cell(s, multi_pod=mp)
    return cells


ALL_ARCHS = list(ARCHS) + list(EXTRA_ARCHS)


# ------------------------------------------------------------- the mesh
def test_reference_started(reference):
    """Starts the reference program; the in-process tests below run
    while it does."""
    assert reference.proc.pid > 0


def test_production_mesh_and_shard_shape():
    m1, m2 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (m1.axis_names, m1.shape, m1.size) == (("data", "model"),
                                                  (16, 16), 256)
    assert (m2.axis_names, m2.shape, m2.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    assert Spec(("data",), None) == Spec("data", None)
    assert shard_shape((64, 7), Spec(("pod", "data"), None), m2) == (2, 7)
    assert shard_shape((33, 64), Spec("data", "model"), m1) == (3, 4)
    assert shard_shape((5,), None, m1) == (5,)
    assert shard_shape((8, 8, 8), Spec(None, ("data", "model")), m1) == \
        (8, 1, 8)


# ------------------------------------------------ the cells, both meshes
def test_eighty_four_cells(port_cells):
    assert len(port_cells) == 84
    assert len(list(all_cells(False))) == 40


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cells_equal_reference(arch, reference, port_cells):
    ref = reference.cells()
    keys = [k for k in ref if k.startswith(arch + "|")]
    assert keys and sorted(keys) == sorted(
        k for k in port_cells if k.startswith(arch + "|"))
    for k in keys:
        r, c = ref[k], port_cells[k]
        assert (c.kind, c.name) == (r["kind"], r["name"]), k
        assert jsonable(c.meta) == r["meta"], k
        assert leaves(c.args) == r["args"], k
        assert leaves(c.outs) == r["outs"], k
        assert jsonable(plain(c.in_shardings)) == r["in_shardings"], k
        assert jsonable(plain(c.out_shardings)) == r["out_shardings"], k
        assert list(c.donate_argnums) == r["donate_argnums"], k


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_per_card_bytes_equal_reference(arch, reference, port_cells):
    ref = reference.cells()
    for k in (k for k in ref if k.startswith(arch + "|")):
        got = dryrun.cell_bytes(port_cells[k], k.endswith("|1"))
        assert got["argument_bytes"] == ref[k]["argument_bytes"], k
        assert got["output_bytes"] == ref[k]["output_bytes"], k


# ------------------------------------------------------ the serve cells
@pytest.mark.parametrize("shape", wcsd_serve.SHAPES)
def test_serve_cells_answer_as_reference(shape):
    """At smoke_config sizes (V 256, L 16, B 64), through the cell's own
    function: `ops.wcsd_query` (K9's plain version here) and the chunked
    plain profile join."""
    sc = wcsd_serve.smoke_config()
    V, L, B = sc["V"], sc["L"], sc["B"]
    gen = torch.Generator().manual_seed(5)
    hub, dist, wlev, count = wcsd_serve.label_rows(V, L, gen, levels=4)
    q = [torch.randint(0, V, (B,), generator=gen, dtype=torch.int32)
         for _ in range(2)]
    w = torch.randint(0, 5, (B,), generator=gen, dtype=torch.int32)
    # rows as a built index holds them: sorted hubs, pads at the end
    real = hub >= 0
    assert torch.equal(real.sum(1).int(), count)
    assert bool((hub[:, 1:][real[:, 1:]] >= hub[:, :-1][real[:, 1:]]).all())
    cell = wcsd_serve.make_cell(shape)
    store = [jnp.asarray(a.numpy()) for a in (hub, dist, wlev, count)]
    if shape == "serve_1m":
        got = cell.fn(hub, dist, wlev, count, q[0], q[1], w)
        exp = query_batch_jnp(*store, *(jnp.asarray(a.numpy())
                                        for a in (q[0], q[1], w)))
        assert (np.asarray(exp) < (1 << 30)).any()
    else:
        got = cell.fn(hub, dist, wlev, count, q[0], q[1])
        exp = profile_batch_jnp(*store, jnp.asarray(q[0].numpy()),
                                jnp.asarray(q[1].numpy()), num_levels=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


# --------------------------------------------------------- the roofline
def test_roofline_row():
    rec = {"arch": "a", "shape": "s", "mesh": "16x16", "kind": "train",
           "chips": 256, "meta": {"model_flops": 2.0 * 256 * 989.4e12},
           "memory": {"peak_bytes": 81e9},
           "cost": {"flops": 989.4e12, "bytes_accessed": 9e12,
                    "moved_bytes": 6.7e12, "int_ops": 132 * 64 * 1.98e9},
           "count_s": 1.5,
           "executed": {"step_ms": 4000.0, "roofline_share": 0.5}}
    row = roofline.roofline_row(rec)
    assert row["compute_s"] == pytest.approx(2.0)
    assert row["memory_s"] == pytest.approx(2.0)
    assert row["bottleneck"] == "compute" and row["step_s"] == \
        pytest.approx(2.0)
    assert row["useful_flops_frac"] == pytest.approx(2.0)
    assert row["roofline_frac"] == pytest.approx(1.0)
    assert row["fits_80g"] is False
    assert (row["executed_ms"], row["executed_share"]) == (4000.0, 0.5)
    assert "| a | s | train |" in roofline.fmt_table([row])
    assert roofline.bound_s(0.0, 0.0, 3.35e12) == (pytest.approx(1.0),
                                                   "memory")


def test_matrix_table():
    """One row a cell from its two meshes' records: per-card bytes on
    both, the bound from the counted moved bytes, the measured step or
    why there is none."""
    def rec(mesh, per_card, shape, executed):
        return {"arch": "a", "shape": shape, "mesh": mesh,
                "memory": {"argument_bytes": per_card, "output_bytes": 0},
                "count": {"flops": 0.0, "int_ops": 0.0,
                          "moved_bytes": 3.35e9, "hbm_bytes": 9e9,
                          "peak_bytes": 2e9},
                "executed": executed}
    recs = [rec("16x16", 2e9, "s", {"step_ms": 4.0, "peak_bytes": 3e9,
                                    "roofline_share": 0.25}),
            rec("2x16x16", 1e9, "s", None),
            rec("16x16", 2e9, "t", {"skipped": "counted peak 90 GB: no"}),
            rec("2x16x16", 1e9, "t", None)]
    rows = roofline.matrix_table(recs).splitlines()[2:]
    assert rows[0] == ("| a s | 2.000 / 1.000 | 0 | 3.35 (9) | 1 (memory) "
                       "| 2 | 4.000 | 3.00 | 0.250 |")
    assert rows[1].endswith("| not run: counted peak 90 GB | | |")


# -------------------------------------------------------- meta routes
def test_segment_plan_meta_route():
    ids = torch.empty(100, dtype=torch.int32, device="meta")
    x = torch.empty(100, 8, device="meta", requires_grad=True)
    plan = C.SegmentPlan(ids, 11)
    assert plan.trashed is None
    y = C.segment_sum(x, plan)
    assert y.shape == (11, 8) and y.is_meta
    (g,) = torch.autograd.grad(C.segment_max(x, plan).sum(), x)
    assert g.shape == x.shape
    assert C.segment_gather(torch.empty(11, 8, device="meta"),
                            plan).shape == (100, 8)


def test_kernel_wrappers_meta_route():
    meta = {"device": "meta"}
    B, H, M, K, D, V, L = 4, 6, 5, 3, 2, 9, 7
    with OpCounter() as oc:
        x1 = torch.empty(B, H, D, **meta)
        x0 = torch.empty(B, M, D, **meta)
        w = torch.empty(K, H, M, **meta)
        assert ops.cin_layer(x1, x0, w).shape == (B, K, D)
        g = torch.empty(B, K, D, **meta)
        assert ops.cin_weight_grad(g, x1, x0).shape == (K, H, M)
        store = [torch.empty(V, L, dtype=torch.int32, **meta)
                 for _ in range(3)]
        q = [torch.empty(B, dtype=torch.int32, **meta) for _ in range(4)]
        out = ops.wcsd_query(*store, *q)
        assert (out.shape, out.dtype) == ((B,), torch.int32)
    assert oc.kernels["cin_layer_narrow"]["flops"] == 2 * B * H * M * K * D
    assert oc.kernels["cin_weight_grad"]["flops"] == 2 * B * H * M * K * D
    assert oc.kernels["wcsd_query_gathered"]["int_ops"] == 4 * B * L
    assert oc.kernels["wcsd_query_gathered"]["bytes"] == 4 * B * L * 4 \
        + 4 * B
    assert ops.WORK_SINKS == []
    with pytest.raises(ValueError, match="unsupported device meta"):
        ops.frontier_relax(store[0], store[1], q[0], q[1])


def test_gather_moves_the_rows_it_reads():
    """A gather's table is charged whole in hbm_bytes (the reference's
    HLO convention) and only the rows it reads in moved_bytes."""
    table = torch.empty(1000, 8, device="meta")
    ids = torch.empty(10, dtype=torch.int64, device="meta")
    for gather in (lambda: table.index_select(0, ids), lambda: table[ids],
                   lambda: torch.nn.functional.embedding(ids, table)):
        with OpCounter() as oc:
            gather()
        assert oc.hbm_bytes == 1000 * 8 * 4 + 10 * 8 + 10 * 8 * 4
        assert oc.moved_bytes == 10 * 8 * 4 + 10 * 8 + 10 * 8 * 4


@pytest.mark.parametrize("B,H,K", [(512, 200, 200), (4, 39, 39)])
def test_cin_meta_route_holds_the_kernels_scratch(B, H, K):
    """The meta routes allocate the scratch the CUDA wrappers do (split
    workspace and weight images, `cin_fuse.cin_scratch` /
    `cin_grad_scratch` planned for an H100), so the counted peak holds
    it: inputs, output and scratch, all live at once. At serve_p99's
    widths the wide kernel splits its r axis; K = 39 is a narrow call."""
    from repro_torch.kernels import cin_fuse
    M, D, meta = 39, 10, torch.device("meta")
    x1, x0, w, g = (torch.empty(*s, device=meta) for s in (
        (B, H, D), (B, M, D), (K, H, M), (B, K, D)))
    fwd, nwords = cin_fuse.cin_scratch(meta, B, H, M, D, K, False)
    grad, gwords = cin_fuse.cin_grad_scratch(meta, B, H, M, D, K)
    assert (len(fwd) == 4) == (K == 200) and nwords > 0 and gwords > 0
    for fn, ins, scratch in (
            (ops.cin_layer, (x1, x0, w), 4 * (math.prod(fwd) + nwords)),
            (ops.cin_weight_grad, (g, x1, x0),
             4 * (math.prod(grad) + gwords))):
        with OpCounter() as oc:
            oc.track(ins)
            out = fn(*ins)
        assert oc.peak_live == 4 * (sum(t.numel() for t in ins)
                                          + out.numel()) + scratch
        assert oc.live == 4 * (sum(t.numel() for t in ins) + out.numel())


def test_decode_step_takes_a_meta_position():
    cell = get_arch("llama3-8b").make_cell("long_500k")
    cfg = get_arch("llama3-8b").smoke_config()
    small = lmc.make_lm_cell(cfg, "decode_32k")
    out, counts = count_step(small.fn, small.args)
    assert dryrun.describe(out) == dryrun.describe(small.outs)
    assert cell.args[3].shape == () and cell.args[3].is_meta
    assert counts["flops"] > 0


@pytest.mark.parametrize("arch,shape", [
    ("llama3-8b", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"),
    ("gin-tu", "molecule"), ("gatedgcn", "full_graph_sm"),
    ("nequip", "molecule"), ("xdeepfm", "train_batch")])
def test_meta_training_step(arch, shape):
    """A whole training step on meta tensors: LM cells at smoke width
    (the full train_4k batch), the others at full width; the result's
    shapes are the cell's."""
    mod = get_arch(arch)
    if arch in ("llama3-8b", "qwen2-moe-a2.7b"):
        cell = lmc.make_lm_cell(mod.smoke_config(), shape)
    else:
        cell = mod.make_cell(shape)
    counts, outs = dryrun.count_cell(cell)
    assert dryrun.describe(outs) == dryrun.describe(cell.outs)
    assert counts["flops"] > 0 and counts["hbm_bytes"] > 0
    assert counts["peak_bytes"] >= counts["argument_bytes"] \
        + counts["new_output_bytes"]
    if arch == "xdeepfm":
        assert {k: v["calls"] for k, v in counts["kernels"].items()} == {
            "cin_layer": 5, "cin_layer_narrow": 4, "cin_weight_grad": 3}


def test_count_checks_the_cell_outputs():
    cell = get_arch("xdeepfm").make_cell("serve_p99")
    cell.outs = torch.empty(3, device="meta")
    with pytest.raises(RuntimeError, match="the cell says"):
        dryrun.count_cell(cell)


def test_record_memory_and_cost():
    """A decode cell writes its cache in place: the output's cache is the
    argument's storage, counted once in the peak."""
    cfg = get_arch("llama3-8b").smoke_config()
    cell = lmc.make_lm_cell(cfg, "decode_32k")
    counts, outs = dryrun.count_cell(cell)
    rec = dryrun.cell_record("llama3-smoke", "decode_32k", cell, False,
                             counts, outs)
    cache = sum(math.prod(t.shape) * 2 for t in cell.args[1].values())
    m = rec["memory"]
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert m["alias_bytes"] == dryrun.sharded_bytes(
        cell.args[1], cell.in_shardings[1], make_production_mesh())
    assert m["inplace_bytes"] == m["alias_bytes"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["output_bytes"] \
        - m["inplace_bytes"] + m["temp_bytes"]
    assert counts["new_output_bytes"] < cache
    assert rec["cost"]["flops"] == counts["flops"] / 256


def test_gnn_concrete_args_in_range():
    cell = get_arch("gin-tu").make_cell("molecule")
    args = gnc.concrete_args(cell, torch.Generator().manual_seed(0))
    b = args[2]
    N, ng = b["feat"].shape[0], b["labels"].shape[0]
    assert int(b["edges_src"].max()) < N and int(b["edges_dst"].min()) >= 0
    assert int(b["graph_id"].max()) < ng and int(b["labels"].max()) < 2
    assert dryrun.describe(args) == dryrun.describe(cell.args)


def test_execute_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: execute_cell would run on it")
    cell = get_arch("gin-tu").make_cell("molecule")
    counts, _ = dryrun.count_cell(cell)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.execute_cell(cell, counts)


# --------------------------------------------------------------- the CLI
def test_cli_writes_record_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "gin-tu", "--shape", "molecule",
                        "--execute", "--device", "cpu",
                        "--out", str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    names = sorted(os.listdir(tmp_path))
    assert names == ["gin-tu__molecule__16-16.json",
                     "gin-tu__molecule__2-16-16.json"]
    with open(tmp_path / names[0]) as f:
        rec = json.load(f)
    assert rec["chips"] == 256 and rec["kind"] == "train"
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes", "peak_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes_accessed", "moved_bytes",
                                "int_ops"}
    ex = rec["executed"]
    assert ex["device"] == "cpu" and ex["step_ms"] > 0
    assert ex["peak_bytes"] is None and ex["roofline_share"] is None
    rows = [roofline.roofline_row(r) for r in roofline.load_records(
        str(tmp_path))]
    assert {r["mesh"] for r in rows} == {"16x16", "2x16x16"}
