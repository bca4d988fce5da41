"""The graph family over a mesh, the port against the JAX package on the
CPU: GIN, PNA, GatedGCN and NequIP trained with the edges split over the
data shards and the node state replicated (`models.segment_mesh`,
`gnn.loss_fn` and `nequip.loss_fn` / `energy_fn` over `Sharded`
parameters, `configs.gnn_common.make_train_step_for(..., mesh=)`).

The reference side runs in one subprocess on 8 virtual host devices,
fed and read through ``.npz`` files, as in `tests/test_torch_train_mesh.py`:
each case's train step (`make_train_step` over the family's loss) jitted
with the cell's ``(param, opt_state, batch)`` shardings under
`jax.set_mesh`, on ("data",) 8 or ("pod", "data") 2 x 4: a node task with
the nodes and labels split over the data axes (the `ogb_products` /
`minibatch_lg` specs), a graph task with the nodes replicated (the
`molecule` specs), NequIP with forces, and NequIP's energy MSE in
float64 as its `ogb_products` cell runs it (edge chunks on each shard,
each layer recomputed in the backward). Each GNN arch runs one task on
each mesh, NequIP on 2 x 4; the node task's bf16 forward too. The port
runs the same numpy weights over 8 CPU shards.

Bars, `tests/test_torch_gnn.py`'s: each step's loss within `OUT_TOL`,
each step's clipped gradient (read off the first moments, ``(m_t - b1
m_{t-1}) / (1 - b1)``) within `GRAD_TOL` of each leaf's max |ref|, the
bf16 logits within `BF16_TOL`. PNA's graph task runs in float64 on both
sides (its float32 gradients are ill-conditioned, see that file). The
port against itself: sharded against unsharded and chunked against whole
in float64 within 1e-10, a re-run bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.data import graphs as ref_graphs
from repro.models import gnn as ref_gnn
from repro_torch.configs import get_arch
from repro_torch.configs import gnn_common as GC
from repro_torch.distributed.collectives import (all_reduce, pmax, pmin,
                                                 psum)
from repro_torch.launch.mesh import (Sharded, Spec, join_leaf,
                                     make_serving_mesh, place_batch)
from repro_torch.models import common as C
from repro_torch.models import gnn as tg
from repro_torch.models import nequip as tnq
from repro_torch.train import optim as O
from repro_torch.train.loop import make_train_step, value_and_grad
from repro_torch.train.tree import map_sharded
from test_torch_gnn import BF16_TOL, GRAD_TOL, OUT_TOL, rel_err

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CPU = torch.device("cpu")
STEPS = 3
B1 = 0.9                             # AdamW's first beta (the default)
OWN_TOL = 1e-10                      # the port against itself, float64
# (arch, task, dtype, mesh): every GNN arch on both meshes, one task each;
# NequIP's force step on the 2 x 4 mesh alone (partitioning its second
# derivative takes the reference ~15 s a mesh)
CASES = [("gin-tu", "node", "float32", "8"),
         ("gin-tu", "graph", "float32", "2x4"),
         ("pna", "node", "float32", "2x4"),
         ("pna", "graph", "float64", "8"),
         ("gatedgcn", "node", "float32", "8"),
         ("gatedgcn", "graph", "float32", "2x4"),
         ("nequip", "molecule", "float32", "2x4"),
         ("nequip", "energy", "float64", "2x4")]
ENERGY_CHUNK = 4                     # edges a chunk: 4 chunks a shard of 16

REF_PROG = r"""
import os
import sys
# the least XLA optimisation: compiling the 8-way partitioned steps
# dominates this program's time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import dataclasses  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.models import gnn as G  # noqa: E402
from repro.models import nequip as NQ  # noqa: E402
from repro.train import optim as O  # noqa: E402
from repro.train.loop import make_train_step  # noqa: E402

inp = dict(np.load(sys.argv[1]))
out = {}
assert len(jax.devices()) == 8
ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=1, weight_decay=0.0)


def mesh_of(name):
    shape = tuple(int(s) for s in name.split("x"))
    axes = ("data",) if len(shape) == 1 else ("pod", "data")
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    m = jax.sharding.Mesh(devs, axes, axis_types=(
        jax.sharding.AxisType.Auto,) * len(shape))
    return m, (axes[0] if len(axes) == 1 else axes)


def flat(tree):
    return {".".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def put(key, tree):
    for k, v in flat(tree).items():
        out[f"{key}.{k}"] = np.asarray(v, dtype=np.float64)


def batch_of(task, dt):
    pre = task + "."
    return {k[len(pre):]: jnp.asarray(v).astype(dt) if v.dtype.kind == "f"
            else jnp.asarray(v) for k, v in inp.items()
            if k.startswith(pre) and k != pre + "n_graphs"}


def bspec_of(task, bd):
    # configs/gnn_common.py's make_gnn_cell / make_nequip_cell
    if task in ("molecule", "energy"):
        n = P(None, None)
        return {"feat": n, "pos": n, "edges_src": P(bd), "edges_dst": P(bd),
                "graph_id": P(None), "energy": P(None), "forces": n}
    if task == "graph":
        return {"feat": P(None, None), "edges_src": P(bd),
                "edges_dst": P(bd), "graph_id": P(None), "labels": P(None)}
    return {"feat": P(bd, None), "edges_src": P(bd), "edges_dst": P(bd),
            "labels": P(bd)}


def run(case, arch, task, dt, mesh):
    cfg = get_arch(arch).smoke_config()
    mod = NQ if arch == "nequip" else G
    if arch != "nequip":
        cfg = dataclasses.replace(cfg, graph_level=task == "graph",
                                  compute_dtype=dt)
    params = mod.init_params(cfg, jax.random.key(0))
    put(f"init/{arch}", params)
    fdt = jnp.float64 if dt == "float64" else jnp.float32
    params = jax.tree.map(lambda a: a.astype(fdt), params)
    batch = batch_of(task, fdt)
    ng = int(inp[task + ".n_graphs"])
    if task == "energy":
        # make_nequip_cell's loss off the molecule shape
        chunk = int(inp["energy_chunk"])

        def loss(p, b):
            e = NQ.energy_fn(p, cfg, b, n_graphs=ng, edge_chunk=chunk)
            return jnp.mean((e - b["energy"]) ** 2)
    elif arch == "nequip":
        loss = lambda p, b: NQ.loss_fn(p, cfg, b, n_graphs=ng)  # noqa: E731
    else:
        loss = lambda p, b: G.loss_fn(  # noqa: E731
            p, cfg, b, n_graphs=ng if task == "graph" else None)
    m, bd = mesh_of(mesh)
    ps = mod.param_shardings(cfg)
    ins = (ps, O.opt_state_shardings(ocfg, ps), bspec_of(task, bd))
    step = jax.jit(make_train_step(loss, ocfg), in_shardings=ins)
    p, o = params, O.init_opt_state(ocfg, params)
    with jax.set_mesh(m):
        for i in range(3):
            p, o, met = step(p, o, batch)
            out[f"{case}/loss{i}"] = np.asarray(met["loss"], np.float64)
            put(f"{case}/m{i}", o.m)
        if task == "node":
            c16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
            fwd = jax.jit(lambda q, b: G.forward(q, c16, b),
                          in_shardings=(ps, ins[2]))
            out[f"{case}/bf16_logits"] = np.asarray(fwd(params, batch),
                                                    np.float32)


for case in inp["cases"]:
    arch, task, dt, mesh = case.split("/")
    with jax.enable_x64(dt == "float64"):
        run(case, arch, task, dt, mesh)
np.savez(sys.argv[2], **out)
"""


def _inputs() -> dict:
    """The four tasks' batches: a node task (N = 64, E = 256, every
    seventh node unlabelled), a graph task (6 molecules of 9 atoms,
    E = 168), NequIP's molecules with forces (4 of 6 atoms, E = 80) and
    NequIP's energy task, `cell_batch`'s `ogb_products` graph at N = 64,
    E = 128 (uniform random, symmetrized; one graph); every edge count
    splits over 8 shards."""
    rng = np.random.default_rng(0)
    c = get_arch("gin-tu").smoke_config()
    N, E = 64, 256
    labels = rng.integers(0, c.n_classes, N).astype(np.int32)
    labels[::7] = -1
    d = {"node.feat": rng.standard_normal((N, c.d_feat)).astype(np.float32),
         "node.edges_src": rng.integers(0, N, E).astype(np.int32),
         "node.edges_dst": rng.integers(0, N, E).astype(np.int32),
         "node.labels": labels, "node.n_graphs": np.int64(0)}
    for task, (ng, atoms, edges, feat) in (
            ("graph", (6, 9, 14, c.d_feat)),
            ("molecule", (4, 6, 10,
                          get_arch("nequip").smoke_config().d_feat))):
        m = ref_graphs.synthetic_molecules(ng, atoms, edges, feat, seed=2)
        for k in ("feat", "graph_id") + (("pos", "energy", "forces")
                                         if task == "molecule" else ()):
            d[f"{task}.{k}"] = m[k]
        d[f"{task}.edges_src"] = np.concatenate([m["edges_src"],
                                                 m["edges_dst"]])
        d[f"{task}.edges_dst"] = np.concatenate([m["edges_dst"],
                                                 m["edges_src"]])
        d[f"{task}.n_graphs"] = np.int64(ng)
    d["graph.labels"] = rng.integers(0, c.n_classes, 6).astype(np.int32)
    u, v = rng.integers(0, N, (2, 64)).astype(np.int32)
    d.update({"energy.feat": rng.standard_normal(
                  (N, get_arch("nequip").smoke_config().d_feat)),
              "energy.pos": rng.standard_normal((N, 3)) * 2,
              "energy.edges_src": np.concatenate([u, v]),
              "energy.edges_dst": np.concatenate([v, u]),
              "energy.graph_id": np.zeros(N, np.int32),
              "energy.energy": rng.standard_normal(1),
              "energy.forces": np.zeros((N, 3)),
              "energy.n_graphs": np.int64(1),
              "energy_chunk": np.int64(ENERGY_CHUNK)})
    d["cases"] = np.array(["/".join(c) for c in CASES])
    return d


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs on 8 virtual host devices, from one
    subprocess."""
    d = tmp_path_factory.mktemp("gnn_mesh_ref")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    (d / "ref.py").write_text(REF_PROG)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(d / "ref.py"), str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return inp, dict(np.load(d / "out.npz"))


def cpu_mesh(name: str):
    return make_serving_mesh([CPU] * 8, multi_pod=name == "2x4")


def task_batch(inp, task, dtype) -> tuple:
    """(the batch as numpy arrays in ``dtype``, n_graphs or None)."""
    pre = task + "."
    b = {k[len(pre):]: v.astype(dtype) if v.dtype.kind == "f" else v
         for k, v in inp.items()
         if k.startswith(pre) and k != pre + "n_graphs"}
    ng = int(inp[pre + "n_graphs"])
    return b, (ng or None)


def port_case(arch, task, dtype):
    """(cfg, the module, the shape whose batch specs the task takes)."""
    cfg = get_arch(arch).smoke_config()
    if arch == "nequip":
        return cfg, tnq, "ogb_products" if task == "energy" else "molecule"
    cfg = dataclasses.replace(cfg, graph_level=task == "graph",
                              compute_dtype=dtype)
    return cfg, tg, "molecule" if task == "graph" else "ogb_products"


def ref_tree(out, arch, dtype) -> dict:
    p = f"init/{arch}."
    tdt = torch.float64 if dtype == "float64" else torch.float32
    return C.nest_params({k[len(p):]: torch.tensor(v, dtype=tdt)
                          for k, v in out.items() if k.startswith(p)})


def joined(tree) -> dict:
    return C.flatten_params(map_sharded(
        lambda x: join_leaf(x) if isinstance(x, Sharded) else x, tree))


def step_grads(ms: list) -> list:
    """Each step's clipped gradient from the first moments after each
    step: ``(m_t - b1 m_{t-1}) / (1 - b1)``, in float64."""
    out, prev = [], None
    for m in ms:
        m = {k: np.asarray(v, np.float64) for k, v in m.items()}
        out.append({k: (v - (B1 * prev[k] if prev else 0.0)) / (1 - B1)
                    for k, v in m.items()})
        prev = m
    return out


# ---------------------------------------------------- against the reference
def nequip_energy_path(monkeypatch):
    """NequIP's `ogb_products` path at the energy task's size: each
    shard's edges in chunks of `ENERGY_CHUNK` (`nequip_edge_chunk`) and
    each layer recomputed in the backward (`BIG_GRAPH` below N)."""
    monkeypatch.setattr(tnq, "BIG_GRAPH", 10)
    monkeypatch.setattr(GC, "nequip_edge_chunk", lambda E: ENERGY_CHUNK)


@pytest.mark.parametrize("case", CASES, ids="/".join)
def test_sharded_steps_equal_the_reference(reference, case, monkeypatch):
    """Three sharded train steps over 8 CPU shards against the
    reference's steps jitted with the cell's shardings: each loss within
    `OUT_TOL`, each step's clipped gradient within `GRAD_TOL` of each
    leaf's max |ref|; the node task's bf16 forward within `BF16_TOL`.
    NequIP's energy task runs `make_train_step_for`'s `ogb_products`
    step (`nequip_energy_path`)."""
    inp, out = reference
    arch, task, dtype, mname = case
    key = "/".join(case)
    cfg, mod, shape = port_case(arch, task, dtype)
    mesh = cpu_mesh(mname)
    params = ref_tree(out, arch, dtype)
    batch, ng = task_batch(inp, task, np.float64 if dtype == "float64"
                           else np.float32)
    if arch == "nequip":
        def loss(p, b):
            return tnq.loss_fn(p, cfg, b, n_graphs=ng)
    else:
        def loss(p, b):
            return tg.loss_fn(p, cfg, b, n_graphs=ng)
    ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=1, weight_decay=0.0)
    specs = GC.batch_specs(cfg, shape, multi_pod=mname == "2x4")
    if task == "energy":
        nequip_energy_path(monkeypatch)
        step = GC.make_train_step_for(cfg, shape, ocfg, mesh=mesh)
    else:
        step = make_train_step(loss, ocfg, mesh=mesh, batch_specs=specs,
                               one_thread=True)
    p = GC.shard_params(params, cfg, mesh)
    o = O.init_opt_state(ocfg, p)
    ms = []
    for i in range(STEPS):
        p, o, met = step(p, o, batch)
        ref_loss = float(out[f"{key}/loss{i}"])
        assert abs(float(met["loss"]) - ref_loss) <= OUT_TOL * abs(
            ref_loss), (i, float(met["loss"]), ref_loss)
        ms.append({k: v.numpy() for k, v in joined(o.m).items()})
    ref_ms = [{k[len(f"{key}/m{i}."):]: v for k, v in out.items()
               if k.startswith(f"{key}/m{i}.")} for i in range(STEPS)]
    for i, (got, ref) in enumerate(zip(step_grads(ms), step_grads(ref_ms))):
        assert set(got) == set(ref)
        for k, r in ref.items():
            assert rel_err(got[k], r) <= GRAD_TOL, (i, k, rel_err(got[k], r))
    if task == "node":
        c16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
        placed = place_batch(batch, mesh, specs)
        logits = tg.forward(GC.shard_params(params, cfg, mesh), c16, placed)
        assert len(logits) == 8 and logits[0].dtype == torch.bfloat16
        got = torch.cat([x.float() for x in logits]).numpy()
        assert rel_err(got, out[f"{key}/bf16_logits"]) <= BF16_TOL


# ---------------------------------------------------- the port against itself
def _float64(arch, graph_level, n_layers=None):
    cfg = get_arch(arch).smoke_config()
    cfg = dataclasses.replace(cfg, graph_level=graph_level,
                              compute_dtype="float64",
                              n_layers=n_layers or cfg.n_layers)
    params = tg.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, map_sharded(lambda x: x.double(), params)


def f32_loss_tol(labels) -> float:
    """The float64 tests' bar on the loss: the cross-entropy reduces in
    float32 whatever the compute dtype, as the reference's does, so the
    sharded path (the shards' float32 sums added) and the whole path
    (one float32 sum) differ by up to that sum's own bound, the count of
    labelled rows times 2^-24, relative."""
    return int((np.asarray(labels) >= 0).sum()) * 2.0 ** -24


def _grads(cfg, params, batch, ng=None, mesh=None):
    fn = value_and_grad(lambda p, b: tg.loss_fn(p, cfg, b, n_graphs=ng))
    if mesh is not None:
        params = GC.shard_params(params, cfg, mesh)
    loss, g = fn(params, batch)
    return float(loss), {k: v.double() for k, v in joined(g).items()}


def _assert_close(a, b, tol, loss_tol=None):
    loss_tol = tol if loss_tol is None else loss_tol
    assert abs(a[0] - b[0]) <= loss_tol * abs(b[0]), (a[0], b[0])
    assert set(a[1]) == set(b[1])
    for k, v in b[1].items():
        err = float((a[1][k] - v).abs().max() / v.abs().max().clamp_min(
            1e-300))
        assert err <= tol, (k, err)


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "gatedgcn"])
@pytest.mark.parametrize("task", ["node", "graph"])
def test_sharded_equals_unsharded_in_float64(arch, task):
    """Every gradient leaf of the sharded step (each replica's, after
    `sum_replicas`) equals the unsharded step's within 1e-10 in float64,
    and the loss within its float32 sum's bound (`f32_loss_tol`), on
    ("data",) 8 and ("pod", "data") 2 x 4 (the node task's nodes and
    labels split, the graph task's replicated)."""
    inp = _inputs()
    cfg, params = _float64(arch, task == "graph")
    batch, ng = task_batch(inp, task, np.float64)
    whole = _grads(cfg, params, batch, ng)
    shape = "molecule" if task == "graph" else "ogb_products"
    for mname in ("8", "2x4"):
        mesh = cpu_mesh(mname)
        placed = place_batch(batch, mesh, GC.batch_specs(
            cfg, shape, multi_pod=mname == "2x4"))
        _assert_close(_grads(cfg, params, placed, ng, mesh), whole, OWN_TOL,
                      f32_loss_tol(batch["labels"]))


@pytest.mark.parametrize("arch", ["gin-tu", "pna", "gatedgcn"])
def test_chunked_path_equals_the_whole_path(arch, monkeypatch):
    """With `BIG_GRAPH` and `EDGE_CHUNK` set small, a depth-4 model over
    4 shards recomputes each shard's edges in chunks (5 a shard, the last
    one short) inside its block of 4 layers: every gradient leaf equals
    the whole path's within 1e-10 in float64 (the loss within
    `f32_loss_tol`), and the mesh
    ran `edge_pass` once a layer a forward."""
    inp = _inputs()
    cfg, params = _float64(arch, False, n_layers=4)
    batch, _ = task_batch(inp, "node", np.float64)
    mesh = make_serving_mesh([CPU] * 4)
    whole = _grads(cfg, params, batch, mesh=mesh)
    calls = []
    orig = tg.edge_pass
    monkeypatch.setattr(tg, "edge_pass", lambda *a: calls.append(
        [len(c) for c in a[-1]]) or orig(*a))
    monkeypatch.setattr(tg, "BIG_GRAPH", 10)
    monkeypatch.setattr(tg, "EDGE_CHUNK", 13)
    _assert_close(_grads(cfg, params, batch, mesh=mesh), whole, OWN_TOL,
                  f32_loss_tol(batch["labels"]))
    # 4 layers, then 4 again as the block recomputes; 64 edges a shard
    assert calls == [[5] * 4] * 8


def _energy_steps(params, cfg, batch, mesh=None) -> tuple:
    """Two `make_train_step_for` steps of NequIP's `ogb_products` energy
    MSE: (the losses, each step's clipped gradient from the moments)."""
    ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=1, weight_decay=0.0)
    step = GC.make_train_step_for(cfg, "ogb_products", ocfg, mesh=mesh)
    p = params if mesh is None else GC.shard_params(params, cfg, mesh)
    o = O.init_opt_state(ocfg, p)
    losses, ms = [], []
    for _ in range(2):
        p, o, met = step(p, o, batch)
        losses.append(float(met["loss"]))
        ms.append({k: v.numpy() for k, v in joined(o.m).items()})
    return losses, step_grads(ms)


def test_nequip_chunked_energy_step_equals_unsharded(monkeypatch):
    """NequIP's `ogb_products` step in float64 on ("pod", "data") 2 x 4,
    each shard's 16 edges in 4 chunks and each layer recomputed in the
    backward (`nequip_energy_path`), against the unsharded step without
    chunks or recompute: both losses and every leaf of both steps'
    gradients within 1e-10; the mesh ran the chunks and the recompute."""
    inp = _inputs()
    cfg = get_arch("nequip").smoke_config()
    params = map_sharded(lambda x: x.double(), tnq.init_params(
        cfg, torch.Generator().manual_seed(0)))
    batch, _ = task_batch(inp, "energy", np.float64)
    whole = _energy_steps(params, cfg, batch)
    nequip_energy_path(monkeypatch)
    chunks, layers = [], []
    plans, recompute = tnq._plans, tnq.recompute
    monkeypatch.setattr(tnq, "_plans", lambda *a: chunks.append(
        len(plans(*a))) or plans(*a))
    monkeypatch.setattr(tnq, "recompute", lambda *a: layers.append(1) or
                        recompute(*a))
    got = _energy_steps(params, cfg, batch, cpu_mesh("2x4"))
    assert chunks == [4] * 8 * 2 and len(layers) == cfg.n_layers * 2
    for a, b in zip(got[0], whole[0]):
        assert abs(a - b) <= OWN_TOL * abs(b), (a, b)
    for g, w in zip(got[1], whole[1]):
        assert set(g) == set(w)
        for k, v in w.items():
            assert rel_err(g[k], v) <= OWN_TOL, (k, rel_err(g[k], v))


def test_a_mesh_forward_takes_only_stored_leaves():
    """The mesh comes from the parameters: a tree whose leaves are all
    `Sharded` runs over their mesh, and one whole leaf among them
    raises (every shard would read one tensor, and its replicas'
    gradients would add in the order they arrive)."""
    inp = _inputs()
    cfg, _, shape = port_case("gin-tu", "node", "float32")
    mesh = cpu_mesh("8")
    params = GC.shard_params(tg.init_params(
        cfg, torch.Generator().manual_seed(0)), cfg, mesh)
    batch, _ = task_batch(inp, "node", np.float32)
    assert isinstance(tg.forward(params, cfg, batch), list)
    params["head_b"] = join_leaf(params["head_b"])
    with pytest.raises(ValueError, match="head_b"):
        tg.forward(params, cfg, batch)


def test_psum_pmax_pmin_hand_each_shard_its_own_tensor():
    """`psum` adds in linear shard order in float32 at least and casts
    once; `psum`, `pmax` and `pmin` give each shard a tensor of its own
    even where shards share a device."""
    xs = [torch.tensor([1.0, -2.0, 3.0]).to(torch.bfloat16) * (k + 1) / 3
          for k in range(4)]
    for fn, exp in ((psum, sum(x.float() for x in xs).to(torch.bfloat16)),
                    (pmax, torch.stack(xs).amax(0)),
                    (pmin, torch.stack(xs).amin(0))):
        out = fn(xs)
        assert len({id(o) for o in out}) == 4
        assert len({o.data_ptr() for o in out}) == 4
        assert all(o.dtype == torch.bfloat16 and torch.equal(o, exp)
                   for o in out), fn
    assert psum(xs, torch.float32)[2].dtype == torch.float32


def test_a_max_tied_across_shards_splits_its_gradient_as_jax_does():
    """PNA with one edge given twice, its copies on two shards: the
    destination's max and min message arrive on both, and every
    gradient leaf of the sharded loss equals `jax.value_and_grad` of the
    reference's unsharded loss in float64 (JAX splits a tied extreme's
    gradient evenly among all its rows)."""
    cfg = dataclasses.replace(get_arch("pna").smoke_config(),
                              compute_dtype="float64")
    rcfg = dataclasses.replace(ref_arch("pna").smoke_config(),
                               compute_dtype="float64")
    rng = np.random.default_rng(4)
    N, E = 24, 32
    src = rng.integers(1, N, E).astype(np.int32)
    dst = rng.integers(1, N, E).astype(np.int32)
    src[[3, 3 + E // 2]] = 5          # node 0's only in-edges: shards 0, 2
    dst[[3, 3 + E // 2]] = 0
    batch = {"feat": rng.standard_normal((N, cfg.d_feat)),
             "edges_src": src, "edges_dst": dst,
             "labels": rng.integers(0, cfg.n_classes, N).astype(np.int32)}
    p = jax.tree_util.tree_map(np.asarray, ref_gnn.init_params(
        rcfg, jax.random.key(1)))
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), p)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        ref_loss, ref_g = jax.jit(jax.value_and_grad(
            lambda q, b: ref_gnn.loss_fn(q, rcfg, b)))(jp, jb)
        ref_g = {k: np.asarray(v) for k, v in C.flatten_params(
            jax.tree_util.tree_map(np.asarray, ref_g)).items()}
    params = C.nest_params({k: torch.tensor(v, dtype=torch.float64)
                            for k, v in C.flatten_params(p).items()})
    loss, g = _grads(cfg, params, batch, mesh=make_serving_mesh([CPU] * 4))
    assert abs(loss - float(ref_loss)) <= OUT_TOL * abs(float(ref_loss))
    for k, r in ref_g.items():
        assert rel_err(g[k].numpy(), r) <= OWN_TOL * 1e4, k


@pytest.mark.parametrize("arch", ["gatedgcn", "nequip"])
def test_sharded_step_reruns_bit_for_bit(arch, monkeypatch):
    """Two runs of the sharded train step from the same state give the
    same loss, parameters and moments, bit for bit (GatedGCN chunked
    inside its block recompute; NequIP with forces)."""
    inp = _inputs()
    task = "molecule" if arch == "nequip" else "node"
    cfg, mod, shape = port_case(arch, task, "float32")
    if arch == "gatedgcn":
        cfg = dataclasses.replace(cfg, n_layers=4)
        monkeypatch.setattr(tg, "BIG_GRAPH", 10)
        monkeypatch.setattr(tg, "EDGE_CHUNK", 13)
    batch, ng = task_batch(inp, task, np.float32)
    mesh = cpu_mesh("2x4")
    params = mod.init_params(cfg, torch.Generator().manual_seed(3))
    step = make_train_step(lambda p, b: mod.loss_fn(p, cfg, b, n_graphs=ng),
                           GC.TRAIN_OPT, mesh=mesh, batch_specs=GC.batch_specs(
                               cfg, shape, multi_pod=True), one_thread=True)
    runs = []
    for _ in range(2):
        p = GC.shard_params(params, cfg, mesh)
        o = O.init_opt_state(GC.TRAIN_OPT, p)
        for _ in range(2):
            p, o, met = step(p, o, batch)
        runs.append((met["loss"], joined(p), joined(o.m), joined(o.v)))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1:], runs[1][1:]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_a_batch_that_does_not_split_raises():
    """Rows that do not split evenly over the data shards raise, and so
    does a spec that names only some of the mesh's data axes."""
    mesh = cpu_mesh("2x4")
    specs = {"edges_src": Spec(("pod", "data"))}
    with pytest.raises(ValueError, match="do not split over 8"):
        place_batch({"edges_src": np.zeros(20, np.int32)}, mesh, specs)
    with pytest.raises(ValueError, match="data axes"):
        place_batch({"edges_src": np.zeros(16, np.int32)}, mesh,
                    {"edges_src": Spec("data")})
    placed = place_batch({"edges_src": np.arange(16), "x": np.ones(3)},
                         mesh, specs)
    assert [len(b) for b in placed["edges_src"]] == [2] * 8
    assert all(tuple(b.shape) == (3,) for b in placed["x"])
    assert placed["x"][0] is placed["x"][7]      # one copy a device


def test_all_reduce_sums_in_order_and_differentiates_twice():
    """`collectives.all_reduce`: every shard gets the linear-order sum as
    a tensor of its own (bf16 partials summed in float32, cast once);
    its first and second derivatives pass `gradcheck` /
    `gradgradcheck`."""
    xs = [torch.randn(5, 3, dtype=torch.float64, requires_grad=True)
          for _ in range(3)]
    out = all_reduce([[x, 2 * x] for x in xs])
    assert len({id(o[0]) for o in out}) == 3
    assert torch.equal(out[1][0], (xs[0] + xs[1]) + xs[2])
    bf = all_reduce([[x.detach().to(torch.bfloat16)] for x in xs])
    exact = sum(x.detach().to(torch.bfloat16).double() for x in xs)
    assert torch.equal(bf[0][0], exact.float().to(torch.bfloat16))

    def fn(*xs):
        return tuple(o[0] * o[1] for o in all_reduce([[x, x * x]
                                                      for x in xs]))
    assert torch.autograd.gradcheck(fn, xs)
    assert torch.autograd.gradgradcheck(fn, xs)
