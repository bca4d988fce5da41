"""Training over a mesh, the port against the JAX package on the CPU:
the storage of every leaf by its `PartitionSpec` (`launch.mesh.Sharded`,
`transformer.shard_params`, `init_params(..., mesh=)`), the gather and
its backward (`distributed.collectives.gather_leaf`), the optimizer over
sharded trees, `train.loop.make_train_step(..., mesh=)`, and
`transformer.decode_step` over parameters stored by their specs.

The reference side runs in one subprocess on 8 virtual host devices,
fed and read through ``.npz`` files, as in `tests/test_torch_parallel.py`:
`jax.device_put` of each leaf by its `NamedSharding` on a ("data",
"model") 4 x 2 mesh (the addressable shards), the train cell's step
(`configs.lm_common.make_lm_cell`'s loss with its activation specs)
jitted with the cell's ``(param, opt_state, batch)`` shardings under
`jax.set_mesh` and, for llama3-8b, without a mesh, and dbrx-132b's
decode jitted with the parameters by their specs on a 1 x 4 mesh. The
reference's MoE takes its expert-parallel route under a mesh with a
"model" axis, whose balance loss is the mean of the data shards'
(``pmean``); the port's sharded step takes the same route. The port
runs the same weights (carried across from numpy) over meshes of 8 (or
4) CPU shards.

Bars against the reference: `tests/test_distributed.py`'s (the loss
within rtol 1e-4, parameters within rtol 3e-3 / atol 3e-5), and each
gradient leaf (read off the first moment after one step) within
`tests/test_torch_lm.py`'s Frobenius bar; decode at that file's decode
bars. Against the port's own unsharded step in float32, within 1e-5 of
each leaf's max |ref|. Storage and the sharded draw: byte for byte.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.distributed.collectives import (gather_leaf,
                                                 gather_leaf_rows,
                                                 sum_replicas)
from repro_torch.launch.mesh import (ProductionMesh, Sharded, Spec,
                                     block_region, data_shards, join_leaf,
                                     leaf_bytes, make_serving_mesh,
                                     shard_leaf, shard_shape, split_rows)
from repro_torch.models import common as C
from repro_torch.models import transformer as TT
from repro_torch.train import optim as O
from repro_torch.train.grad_compress import (compress_decompress,
                                             compress_decompress_sharded)
from repro_torch.train.loop import make_train_step, value_and_grad
from repro_torch.train.tree import map_sharded
from test_torch_lm import (F32_JUMP, F32_TOL, GRAD_TOL, assert_positions,
                           fro_err, rel_err)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CPU = torch.device("cpu")
STORE_ARCHS = ("llama3-8b", "dbrx-132b")
TRAIN_ARCHS = ("llama3-8b", "qwen2-moe-a2.7b")
B, T = 8, 32                         # 4 data shards of 2 rows
LR = 1e-3
DEC_B, DEC_S = 2, 64                 # dbrx decode: 4 blocks of 16
DEC_POS = (15, 16, 40, 63)
OWN_TOL = 1e-5                       # the port against itself, float32

REF_PROG = r"""
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.train import optim as O  # noqa: E402
from repro.train.loop import make_train_step  # noqa: E402

inp = dict(np.load(sys.argv[1]))
out = {}
assert len(jax.devices()) == 8
ax = ("data", "model")


def mesh_of(shape):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return jax.sharding.Mesh(devs, ax,
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)


def flat(tree):
    return {".".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def put(out_key, tree):
    for k, v in flat(tree).items():
        out[f"{out_key}.{k}"] = np.asarray(v, dtype=np.float32)


is_spec = lambda s: isinstance(s, P)  # noqa: E731
m42, m14 = mesh_of((4, 2)), mesh_of((1, 4))
lin = {d: k for k, d in enumerate(m42.devices.flat)}

init = {}
for arch in ("llama3-8b", "dbrx-132b", "qwen2-moe-a2.7b"):
    cfg = get_arch(arch).smoke_config()
    params = init[arch] = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.key(0))
    put(f"init_{arch}", params)
    if arch == "qwen2-moe-a2.7b":
        continue
    shard = jax.tree.map(lambda s: NamedSharding(m42, s),
                         T.param_shardings(cfg), is_leaf=is_spec)
    for k, arr in flat(jax.device_put(params, shard)).items():
        for sh in arr.addressable_shards:
            out[f"block_{arch}.{k}.{lin[sh.device]}"] = np.asarray(sh.data)


def cell_step(cfg, ocfg, accum=1, compress=False):
    # configs.lm_common.make_lm_cell's train step (single pod)
    act = P("data", None, "model") if cfg.heads_shardable \
        else P("data", "model", None)
    head = None if cfg.heads_shardable else P("data", None, "model")
    return make_train_step(
        lambda p, b: T.loss_fn(p, cfg, b, act_spec=act,
                               head_act_spec=head),
        ocfg, accum_steps=accum, compress_grads=compress)


def shardings(cfg, ocfg):
    ps = T.param_shardings(cfg)
    bspec = {"tokens": P("data", None), "labels": P("data", None)}
    return (ps, O.opt_state_shardings(ocfg, ps), bspec)


def record(tag, p, o, m):
    put(tag + "_params", p)
    put(tag + "_m", o.m)
    for k in ("loss", "grad_norm", "lr"):
        out[f"{tag}_{k}"] = np.asarray(m[k], np.float32)


batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "labels")}
for arch in ("llama3-8b", "qwen2-moe-a2.7b"):
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              compute_dtype="float32")
    params = init[arch]
    ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=0)
    opt = O.init_opt_state(ocfg, params)
    step = cell_step(cfg, ocfg)
    with jax.set_mesh(m42):
        record(f"mesh_{arch}", *jax.jit(
            step, in_shardings=shardings(cfg, ocfg))(params, opt, batch))
    if arch == "llama3-8b":
        one = make_train_step(lambda p, b: T.loss_fn(p, cfg, b), ocfg)
        record(f"one_{arch}", *jax.jit(one)(params, opt, batch))
        ocfg3 = O.OptimizerConfig(lr=1e-3, warmup_steps=1)
        ins = shardings(cfg, ocfg3)
        step3 = jax.jit(cell_step(cfg, ocfg3, accum=2, compress=True),
                        in_shardings=ins, out_shardings=ins[:2] + (None,))
        p, o = params, O.init_opt_state(ocfg3, params)
        with jax.set_mesh(m42):
            for i in range(3):
                p, o, m = step3(p, o, batch)
                out[f"three_{arch}_loss_{i}"] = np.asarray(m["loss"])
        put(f"three_{arch}_params", p)
        step1 = jax.jit(make_train_step(lambda p, b: T.loss_fn(p, cfg, b),
                                        ocfg3, accum_steps=2,
                                        compress_grads=True))
        p, o = params, O.init_opt_state(ocfg3, params)
        for i in range(3):
            p, o, m = step1(p, o, batch)
        put(f"three_one_{arch}_params", p)

cfg = dataclasses.replace(get_arch("dbrx-132b").smoke_config(),
                          compute_dtype="float32")
params = init["dbrx-132b"]
cs = P(None, None, ax, None, None)
cache = {k: jnp.asarray(inp["dec_cache"]).astype(jnp.bfloat16)
         for k in ("k", "v")}
toks = jnp.asarray(inp["dec_toks"])
with jax.set_mesh(m14):
    dec = jax.jit(T.decode_step, static_argnums=(1,),
                  in_shardings=(T.param_shardings(cfg), {"k": cs, "v": cs},
                                None, None))
    for i, pos in enumerate(inp["dec_pos"]):
        toks, lg, cache = dec(params, cfg, cache, toks, jnp.int32(pos))
        out[f"dec_{i}_toks"] = np.asarray(toks)
        out[f"dec_{i}_logits"] = np.asarray(lg)
np.savez(sys.argv[2], **out)
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 128, (B, T)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[1, :20] = -1              # uneven masks: a shard's mean is not
    labels[6, 3:9] = -1              # the global one
    c = get_arch("dbrx-132b").smoke_config()
    return {"tokens": toks, "labels": labels,
            "dec_cache": rng.standard_normal(
                (c.n_layers, DEC_B, DEC_S, c.n_kv_heads, c.d_head))
            .astype(np.float32),
            "dec_toks": rng.integers(0, c.vocab, DEC_B).astype(np.int32),
            "dec_pos": np.array(DEC_POS, np.int32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs on 8 virtual host devices, from one
    subprocess."""
    d = tmp_path_factory.mktemp("train_mesh_ref")
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


def mesh(shape=(4, 2)):
    return make_serving_mesh([CPU] * int(np.prod(shape)),
                             axes=dict(zip(("data", "model"), shape)))


def tree_of(out, prefix) -> dict:
    p = prefix + "."
    return C.nest_params({k[len(p):]: v for k, v in out.items()
                          if k.startswith(p)})


def port_params(arch, out, compute_dtype=None) -> tuple:
    cfg = get_arch(arch).smoke_config()
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    tree = tree_of(out, f"init_{arch}")
    return cfg, C.param_tree(TT.params_from_numpy(cfg, tree, device="cpu"))


def joined(tree) -> dict:
    """A tree with its `Sharded` leaves joined, flattened."""
    return C.flatten_params(map_sharded(
        lambda x: join_leaf(x) if isinstance(x, Sharded) else x, tree))


# ------------------------------------------------------------- storage
@pytest.mark.parametrize("arch", STORE_ARCHS)
def test_blocks_equal_the_reference_shards(reference, arch):
    """Every block of every leaf on a (4, 2) mesh is the reference's
    addressable shard of `jax.device_put(leaf, NamedSharding(mesh,
    spec))`, byte for byte; joining the blocks gives the leaf back."""
    _, out = reference
    cfg, params = port_params(arch, out)
    m = mesh()
    placed = C.flatten_params(TT.shard_params(params, cfg, m))
    whole = C.flatten_params(params)
    for path, leaf in placed.items():
        assert isinstance(leaf, Sharded) and len(leaf) == 8
        for k, blk in enumerate(leaf):
            exp = out[f"block_{arch}.{path}.{k}"]
            assert tuple(blk.shape) == exp.shape, (path, k)
            assert np.array_equal(blk.numpy(), exp), (path, k)
        assert torch.equal(join_leaf(leaf), whole[path]), path


@pytest.mark.parametrize("arch", ("llama3-8b", "dbrx-132b",
                                  "qwen2-moe-a2.7b"))
@pytest.mark.parametrize("shape", [(4, 2), (1, 4), (2, 2)])
def test_sharded_init_equals_sharding_the_whole_draw(arch, shape):
    """`init_params(..., mesh=)` draws each device's blocks itself and
    gives `shard_params(init_params(...))` byte for byte, the blocks of
    one region on one device one tensor, and the generator left where
    the whole draw leaves it; in bfloat16 too."""
    cfg = get_arch(arch).smoke_config()
    m = mesh(shape)
    for dtype in (torch.float32, torch.bfloat16):
        g1, g2 = torch.Generator().manual_seed(7), \
            torch.Generator().manual_seed(7)
        ref = TT.shard_params(TT.init_params(cfg, g1, dtype), cfg, m)
        got = TT.init_params(cfg, g2, dtype, mesh=m)
        assert torch.equal(g1.get_state(), g2.get_state())
        ref, got = C.flatten_params(ref), C.flatten_params(got)
        assert set(ref) == set(got)
        for path, leaf in got.items():
            assert leaf.spec == ref[path].spec
            for a, b in zip(leaf, ref[path]):
                assert a.dtype == b.dtype and torch.equal(a, b), path
            for ks in leaf.groups().values():
                assert all(leaf[k] is leaf[ks[0]] for k in ks), path


def test_block_regions_follow_xla():
    """Block shapes are `shard_shape`'s where the axes divide; an
    uneven dimension gives ceil-sized blocks and a short (or empty)
    last one; an axis the mesh lacks is one shard; a dimension over
    two axes splits major to minor."""
    pm = ProductionMesh(("data", "model"), (4, 2))
    m = mesh()
    for k in range(8):
        r = block_region((16, 8), Spec("data", "model"), m, k)
        assert tuple(b - a for a, b in r) == \
            shard_shape((16, 8), Spec("data", "model"), pm)
    # 6 over 4 "data" shards: blocks of 2, the last one empty
    assert [block_region((3, 8, 6), Spec(None, "model", "data"), m, k)[2]
            for k in range(0, 8, 2)] == [(0, 2), (2, 4), (4, 6), (6, 6)]
    spans = [block_region((10,), Spec("data"), m, k)[0] for k in range(8)]
    assert spans[::2] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert block_region((2,), Spec("data"), m, 6)[0] == (2, 2)
    assert block_region((8,), Spec(("data", "model")), m, 5)[0] == (5, 6)
    assert block_region((8,), Spec("pod"), m, 5)[0] == (0, 8)
    x = torch.arange(10.)
    leaf = shard_leaf(x, Spec("data"), m)
    assert [len(b) for b in leaf] == [3, 3, 3, 3, 3, 3, 1, 1]
    assert torch.equal(join_leaf(leaf), x)
    assert leaf[0] is leaf[1] and leaf.owners() == [0, 2, 4, 6]
    assert leaf_bytes(leaf, CPU) == 10 * 4


def test_split_rows_and_data_shards():
    m = mesh()
    assert data_shards(m) == [0, 2, 4, 6]
    assert data_shards(mesh((1, 4))) == [0]
    rows = split_rows(np.arange(8).reshape(8, 1), m)
    assert [r[:, 0].tolist() for r in rows] == [[0, 1], [2, 3], [4, 5],
                                                [6, 7]]
    with pytest.raises(ValueError):
        split_rows(np.zeros((6, 2)), m)


# ------------------------------------------------ the gather's backward
@pytest.mark.parametrize("spec", [Spec("data", "model"), Spec(None, "data"),
                                  Spec("model", None), Spec(None, None)])
def test_gather_backward_is_the_reduce_scatter(spec):
    """`gather_leaf` onto each data shard's device, a loss over all of
    them: each block's gradient is the sum of its slices of every
    gather's gradient, a block several shards hold gets the total on
    each (`value_and_grad`'s `sum_replicas`), equal to the whole leaf's
    gradient sliced; `gather_leaf_rows` the same for a row lookup."""
    m = mesh()
    g = torch.Generator().manual_seed(1)
    w = torch.randn(8, 6, generator=g, dtype=torch.float64)
    xs = [torch.randn(3, 8, generator=g, dtype=torch.float64)
          for _ in range(4)]
    ids = [torch.tensor([0, 7, 3, 3, 5]), torch.tensor([1, 1, 6]),
           torch.tensor([2]), torch.tensor([4, 0])]

    def loss(leaf):
        total = 0
        for d, k in enumerate(data_shards(m)):
            dev = m.devices[k]
            full = gather_leaf(leaf, dev)
            rows = gather_leaf_rows(leaf, ids[d], dev)
            total = total + ((xs[d] @ full) ** 2).sum() + (rows ** 3).sum()
        return total

    wl = w.clone().requires_grad_(True)
    ref = 0
    for d in range(4):
        ref = ref + ((xs[d] @ wl) ** 2).sum() + (wl[ids[d]] ** 3).sum()
    ref.backward()
    _, grads = value_and_grad(lambda p, _: loss(p["w"]))(
        {"w": shard_leaf(w, spec, m)}, None)
    gl = grads["w"]
    assert isinstance(gl, Sharded)
    for k in range(8):
        r = gl.region(k)
        torch.testing.assert_close(gl[k], wl.grad[tuple(
            slice(a, b) for a, b in r)], rtol=1e-12, atol=1e-12)
    for ks in gl.groups().values():
        assert all(gl[k] is gl[ks[0]] for k in ks)


def test_gather_where_takes_one_model_shards_box():
    """``where={"model": m}`` joins the blocks of that model shard only
    (an expert leaf's experts, over "data"); a box one block holds on
    the target device is that block."""
    m = mesh()
    w = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    leaf = shard_leaf(w, Spec("model", "data", None), m)
    for mm in range(2):
        got = gather_leaf(leaf, CPU, where={"model": mm})
        assert torch.equal(got, w[2 * mm:2 * mm + 2])
    one = shard_leaf(w, Spec("model", None, None), m)
    assert gather_leaf(one, CPU, where={"model": 1}) is one[1]
    with pytest.raises(ValueError):
        gather_leaf(leaf, CPU, where={"data": 9})


def test_sum_replicas_adds_the_parts():
    m = mesh()
    leaf = shard_leaf(torch.zeros(4, 2), Spec("data"), m)
    parts = leaf.like([torch.full((1, 2), float(k)) if k % 2 == 0 else
                       (torch.ones(1, 2) if k == 3 else None)
                       for k in range(8)])
    got = sum_replicas(parts)
    assert torch.equal(got[0], torch.zeros(1, 2))
    assert torch.equal(got[2], torch.full((1, 2), 3.0))
    assert got[2] is got[3]
    assert torch.equal(got[5], torch.full((1, 2), 4.0))


# --------------------------------------------------- optimizer pieces
def test_norm_and_compression_see_the_whole_leaf():
    """The global norm counts each block once (replicas too), and the
    int8 simulation quantizes every block on the whole leaf's grid."""
    m = mesh()
    g = torch.Generator().manual_seed(2)
    tree = {"a": torch.randn(8, 4, generator=g),
            "b": torch.randn(6, generator=g) * 10}
    specs = {"a": Spec("data", "model"), "b": Spec(None)}
    sharded = {k: shard_leaf(v, specs[k], m) for k, v in tree.items()}
    torch.testing.assert_close(O.global_norm(sharded), O.global_norm(tree),
                               rtol=1e-6, atol=0)
    for k, v in tree.items():
        got = join_leaf(compress_decompress_sharded(sharded[k]))
        assert torch.equal(got, compress_decompress(v)[0])
    state = O.init_opt_state(O.OptimizerConfig(), sharded)
    assert state.m["b"][0] is state.m["b"][7]
    assert state.step.device == CPU


# ------------------------------------------------------- the train step
def _port_step(cfg, params, batch, m, ocfg, **kw):
    step = make_train_step(lambda p, b: TT.loss_fn(p, cfg, b), ocfg,
                           mesh=m, **kw)
    placed = params if m is None else TT.shard_params(params, cfg, m)
    return step(placed, O.init_opt_state(ocfg, placed), batch)


def _flips(got, exp, lr, steps) -> int:
    """Entries past rtol 3e-3 / atol 3e-5: each must be an Adam update
    that went the other way on a near-zero gradient (within 2 lr a
    step of the reference); returns how many."""
    bad = ~np.isclose(got, exp, rtol=3e-3, atol=3e-5)
    assert np.all(np.abs(got - exp)[bad] <= 2 * lr * steps * (1 + 1e-3))
    return int(bad.sum())


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_step_matches_reference(reference, arch):
    """One step on 8 CPU shards ((4, 2): rows over "data", leaves by
    their specs) against the reference's step under the train cell's
    shardings: loss (with qwen2-moe's balance loss over the global
    batch), gradient norm, every gradient leaf, every parameter; every
    new block stored by its spec."""
    inp, out = reference
    cfg, params = port_params(arch, out, "float32")
    batch = {k: inp[k] for k in ("tokens", "labels")}
    ocfg = O.OptimizerConfig(lr=LR, warmup_steps=0)
    m = mesh()
    p, o, met = _port_step(cfg, params, batch, m, ocfg)
    tag = f"mesh_{arch}"
    np.testing.assert_allclose(float(met["loss"]), out[tag + "_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               out[tag + "_grad_norm"], rtol=1e-3)
    assert float(met["lr"]) == float(out[tag + "_lr"])
    mom, new = joined(o.m), joined(p)
    exp_m = C.flatten_params(tree_of(out, tag + "_m"))
    exp_p = C.flatten_params(tree_of(out, tag + "_params"))
    # llama3-8b: the reference's own single-device step is a second
    # yardstick (its sharded and unsharded gradients differ by up to
    # 6e-3 of a leaf: the bf16-rounded attention operands round apart)
    own = C.flatten_params(tree_of(out, f"one_{arch}_m")) \
        if f"one_{arch}_loss" in out else {}
    flips = 0
    for path in exp_p:
        bar = max(GRAD_TOL, fro_err(torch.from_numpy(own[path]),
                                    exp_m[path]) if own else 0.0)
        assert fro_err(mom[path], exp_m[path]) <= bar, path
        flips += _flips(new[path].numpy(), exp_p[path], LR, 1)
    assert flips <= 1e-3 * sum(v.size for v in exp_p.values())
    for path, leaf in C.flatten_params(p).items():
        assert isinstance(leaf, Sharded), path
        for k, blk in enumerate(leaf):
            assert tuple(blk.shape) == tuple(
                b - a for a, b in leaf.region(k)), path


def test_sharded_llama_step_matches_single_device(reference):
    """llama3-8b: the port's step on 8 shards against the reference's
    single-device step (test_distributed's bars), and against the
    port's own unsharded step within 1e-5 of each leaf's max |ref|
    (loss, the first moment, the parameters)."""
    inp, out = reference
    cfg, params = port_params("llama3-8b", out, "float32")
    batch = {k: inp[k] for k in ("tokens", "labels")}
    ocfg = O.OptimizerConfig(lr=LR, warmup_steps=0)
    p, o, met = _port_step(cfg, params, batch, mesh(), ocfg)
    np.testing.assert_allclose(float(met["loss"]),
                               out["one_llama3-8b_loss"], rtol=1e-4)
    up, uo, umet = _port_step(cfg, params, batch, None, ocfg)
    assert abs(float(met["loss"]) - float(umet["loss"])) <= \
        OWN_TOL * abs(float(umet["loss"]))
    mom, new = joined(o.m), joined(p)
    for path, ref in C.flatten_params(uo.m).items():
        assert rel_err(mom[path], ref) <= OWN_TOL, path
    exp = C.flatten_params(tree_of(out, "one_llama3-8b_params"))
    flips = 0
    for path, ref in C.flatten_params(up).items():
        assert rel_err(new[path], ref) <= OWN_TOL, path
        flips += _flips(new[path].numpy(), exp[path], LR, 1)
    assert flips <= 1e-3 * sum(v.size for v in exp.values())


def test_float64_sharded_gradient_equals_the_whole_batch():
    """llama3-8b's smoke config in float64 (the port's own compute
    dtype; the attention still rounds q, k, p, v to bf16): the gradient
    over 8 CPU shards (rows over "data", leaves by their specs) equals
    the whole batch's within 1e-12 of each leaf's max |ref|, far inside
    the float32 bar, so the row split adds nothing but rounding."""
    cfg = dataclasses.replace(get_arch("llama3-8b").smoke_config(),
                              compute_dtype="float64")
    params = map_sharded(lambda x: x.to(torch.float64), TT.init_params(
        cfg, torch.Generator().manual_seed(0)))
    inp = _inputs()
    batch = {k: inp[k] for k in ("tokens", "labels")}
    m = mesh()
    fn = value_and_grad(lambda p, b: TT.loss_fn(p, cfg, b))
    loss, whole = fn(params, batch)
    sloss, split = fn(TT.shard_params(params, cfg, m),
                      {k: split_rows(v, m) for k, v in batch.items()})
    assert abs(float(sloss) - float(loss)) <= 1e-12 * abs(float(loss))
    got = joined(split)
    for path, ref in C.flatten_params(whole).items():
        assert got[path].dtype == torch.float64
        assert rel_err(got[path], ref) <= 1e-12, path


def test_three_sharded_steps_with_accumulation_and_compression(reference):
    """Three steps (warm-up 1: step 0 moves nothing but the moments),
    two microbatches a step, int8-compressed gradients, on 8 shards
    against the reference's under the cell's shardings (an entry past
    the bar must be a flipped update, and there may be no more of them
    than between the reference's own sharded and single-device runs);
    and against the port's unsharded steps."""
    inp, out = reference
    cfg, params = port_params("llama3-8b", out, "float32")
    batch = {k: inp[k] for k in ("tokens", "labels")}
    ocfg = O.OptimizerConfig(lr=LR, warmup_steps=1)
    runs = {}
    for name, m in (("mesh", mesh()), ("one", None)):
        step = make_train_step(lambda p, b: TT.loss_fn(p, cfg, b), ocfg,
                               accum_steps=2, compress_grads=True, mesh=m)
        p = params if m is None else TT.shard_params(params, cfg, m)
        o = O.init_opt_state(ocfg, p)
        losses = []
        for _ in range(3):
            p, o, met = step(p, o, batch)
            losses.append(float(met["loss"]))
        runs[name] = (losses, joined(p) if m else C.flatten_params(p))
    for i in range(3):
        np.testing.assert_allclose(runs["mesh"][0][i],
                                   out[f"three_llama3-8b_loss_{i}"],
                                   rtol=1e-4)
        assert abs(runs["mesh"][0][i] - runs["one"][0][i]) <= \
            OWN_TOL * abs(runs["one"][0][i])
    exp = C.flatten_params(tree_of(out, "three_llama3-8b_params"))
    flips = 0
    for path in exp:
        flips += _flips(runs["mesh"][1][path].numpy(), exp[path], LR, 2)
        own = runs["one"][1][path]
        bad = (runs["mesh"][1][path] - own).abs() > OWN_TOL * own.abs().max()
        assert ((runs["mesh"][1][path] - own).abs()[bad]
                <= 2 * LR * 2 * (1 + 1e-3)).all(), path
    # the reference's own sharded and single-device runs part on as many
    # entries: an int8 grid step flips where a gradient sits on its edge
    ref_own = sum(_flips(exp[p], v, LR, 2) for p, v in C.flatten_params(
        tree_of(out, "three_one_llama3-8b_params")).items())
    assert flips <= max(1e-3 * sum(v.size for v in exp.values()), ref_own)


def test_moe_mesh_layer_recomputes_once_over_every_shard(monkeypatch):
    """qwen2-moe's smoke config in float64 over ("data", "model") 2 x 2
    CPU shards: with ``remat="full"`` each MoE layer is one
    `remat.recompute` region over every shard, never a
    `torch.utils.checkpoint`, and the loss and every gradient leaf (the
    experts', the router's and the attention's included) equal the
    step's without remat within 1e-12 of each leaf's max |ref|, so every
    leaf the region reads comes in as an input. `moe_apply` runs twice a
    layer with the recompute (the forward, then the backward's rerun),
    once without."""
    base = dataclasses.replace(get_arch("qwen2-moe-a2.7b").smoke_config(),
                               compute_dtype="float64")
    params = map_sharded(lambda x: x.to(torch.float64), TT.init_params(
        base, torch.Generator().manual_seed(0)))
    inp = _inputs()
    m = mesh((2, 2))
    batch = {k: split_rows(inp[k], m) for k in ("tokens", "labels")}
    calls = []
    moe_apply = TT.moe_apply
    monkeypatch.setattr(TT, "moe_apply", lambda *a, **kw: calls.append(1)
                        or moe_apply(*a, **kw))

    def no_checkpoint(*a, **kw):
        raise AssertionError("an MoE layer over a mesh under checkpoint")

    monkeypatch.setattr(TT, "checkpoint", no_checkpoint)
    runs = {}
    for remat in ("full", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        calls.clear()
        loss, g = value_and_grad(lambda p, b: TT.loss_fn(p, cfg, b))(
            TT.shard_params(params, cfg, m), batch)
        runs[remat] = (float(loss), joined(g), len(calls))
    (loss, got, n), (ref_loss, ref, n_ref) = runs["full"], runs["none"]
    assert (n, n_ref) == (2 * base.n_layers, base.n_layers)
    assert abs(loss - ref_loss) <= 1e-12 * abs(ref_loss)
    assert set(got) == set(ref)
    for path, r in ref.items():
        assert got[path].dtype == torch.float64
        assert float(r.abs().max()) > 0, path
        assert rel_err(got[path], r) <= 1e-12, path


def test_leaf_blocks_hand_each_tensor_in_once():
    """`remat.leaf_blocks` over 2 x 2 CPU shards: a tensor several shards
    share goes in once (a replicated leaf is one tensor; a leaf split
    over "model" two), in sorted key order, and ``rebuild`` gives the
    same storage plan over the tensors it is handed, shared as before."""
    from repro_torch.models.remat import leaf_blocks
    m = mesh((2, 2))
    g = torch.Generator().manual_seed(0)
    leaves = {"w": shard_leaf(torch.randn(6, 4, generator=g),
                              Spec(None, "model"), m),
              "norm": shard_leaf(torch.randn(4, generator=g), Spec(None), m)}
    flat, rebuild = leaf_blocks(leaves)
    assert len(flat) == 3
    assert flat[0] is leaves["norm"][0]
    assert [id(t) for t in flat[1:]] == [id(leaves["w"][k]) for k in (0, 1)]
    new = [t.clone() for t in flat]
    got = rebuild(new)
    assert set(got) == {"w", "norm"}
    assert all(b is new[0] for b in got["norm"])
    assert [b is new[1 + k % 2] for k, b in enumerate(got["w"])] == \
        [True] * 4
    for k, leaf in got.items():
        assert isinstance(leaf, Sharded)
        assert (leaf.spec, leaf.mesh, leaf.shape) == (
            leaves[k].spec, leaves[k].mesh, leaves[k].shape)


def test_moe_balance_loss_is_the_data_shards_mean(reference):
    """qwen2-moe: the sharded loss minus its cross-entropy is the mean,
    over the 4 data shards, of each shard's balance loss (its rows
    alone through the expert-parallel route), as the reference's
    ``pmean`` makes it; not the balance loss of the joined batch."""
    inp, out = reference
    cfg, params = port_params("qwen2-moe-a2.7b", out, "float32")
    m = mesh()
    sp = TT.shard_params(params, cfg, m)
    toks = inp["tokens"]
    with torch.no_grad():
        _, aux = TT.forward(sp, cfg, toks)
        per = []
        for d in range(4):
            rows = toks[2 * d:2 * d + 2]
            per.append(_ep_aux(params, cfg, rows))
        whole = _ep_aux(params, cfg, toks)
    torch.testing.assert_close(aux, torch.stack(per).mean(), rtol=1e-6,
                               atol=0)
    assert abs(float(aux) - float(whole)) > 1e-7


def _ep_aux(params, cfg, rows):
    """The balance loss of ``rows`` alone: the unsharded forward with the
    experts routed over one data shard and 2 "model" shards."""
    m = make_serving_mesh([CPU] * 2, axes={"data": 1, "model": 2})
    return TT.forward(params, cfg, rows, mesh=m)[1]


# ---------------------------------------------------------------- decode
def test_dbrx_decode_over_stored_params_matches_reference(reference):
    """dbrx-132b's smoke config, float32, its leaves stored by their
    specs over a (1, 4) mesh of CPU shards and the cache split along
    its sequence: `decode_step` against the reference's decode jitted
    with the same shardings (the reference's tokens feed both), and
    against the port's decode over the whole leaves and cache (the same
    mesh routing the experts) within 1e-5 of max |ref|, tokens equal."""
    inp, out = reference
    cfg, params = port_params("dbrx-132b", out, "float32")
    m = mesh((1, 4))
    sp = TT.shard_params(params, cfg, m)
    t = torch.from_numpy(inp["dec_cache"]).to(torch.bfloat16)
    split = {k: [b.clone() for b in torch.chunk(t, 4, dim=2)]
             for k in ("k", "v")}
    whole = {k: t.clone() for k in ("k", "v")}
    feed = torch.from_numpy(inp["dec_toks"])
    for i, pos in enumerate(DEC_POS):
        with torch.no_grad():
            tn, tl, _ = TT.decode_step(sp, cfg, split, feed, int(pos))
            wn, wl, _ = TT.decode_step(params, cfg, whole, feed, int(pos),
                                       mesh=m)
        np.testing.assert_array_equal(tn.numpy(), out[f"dec_{i}_toks"])
        assert_positions(tl, out[f"dec_{i}_logits"], F32_TOL, F32_JUMP, 0.5,
                         f"dbrx decode {i}")
        assert torch.equal(tn, wn) and rel_err(tl, wl) <= OWN_TOL
        feed = torch.from_numpy(out[f"dec_{i}_toks"])
    other = make_serving_mesh([CPU] * 4, axes={"data": 2, "model": 2})
    with pytest.raises(ValueError):
        TT.decode_step(sp, cfg, split, feed, 0, mesh=other)


def test_no_fallback_joins_split_leaves():
    """An MoE step over a mesh without "model", or experts that do not
    split, raises rather than join the leaves on one device."""
    cfg = dataclasses.replace(get_arch("dbrx-132b").smoke_config(),
                              compute_dtype="float32")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    no_model = make_serving_mesh([CPU] * 4, axes={"data": 4})
    with pytest.raises(NotImplementedError):
        TT.loss_fn(TT.shard_params(params, cfg, no_model), cfg,
                   {"tokens": np.zeros((4, 8), np.int32),
                    "labels": np.zeros((4, 8), np.int32)})
    odd = make_serving_mesh([CPU] * 8, axes={"data": 1, "model": 8})
    sp = TT.shard_params(params, cfg, odd)
    cache = TT.init_cache(cfg, 1, 16, mesh=odd)
    with pytest.raises(ValueError):
        TT.decode_step(sp, cfg, cache, torch.tensor([3]), 0)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_donated_step_updates_in_place_with_the_same_numbers(optimizer):
    """`make_train_step(..., donate=True)` on 8 CPU shards: the new
    parameters and moments are the old tensors, updated in place (a
    tensor several shards share stays shared), and equal bit for bit to
    the functional step's."""
    cfg = dataclasses.replace(get_arch("llama3-8b").smoke_config(),
                              compute_dtype="float32")
    m = mesh()
    ocfg = O.OptimizerConfig(name=optimizer, lr=LR, warmup_steps=0)
    inp = _inputs()
    batch = {k: inp[k] for k in ("tokens", "labels")}
    runs = {}
    for donate in (False, True):
        p = TT.init_params(cfg, torch.Generator().manual_seed(0), mesh=m)
        o = O.init_opt_state(ocfg, p)
        step = make_train_step(lambda pp, b: TT.loss_fn(pp, cfg, b), ocfg,
                               mesh=m, donate=donate)
        p2, o2, _ = step(p, o, batch)
        p2, o2, _ = step(p2, o2, batch)
        same = [a is b for a, b in zip(C.flatten_params(p)["layers.wq"],
                                       C.flatten_params(p2)["layers.wq"])]
        assert all(same) == donate
        runs[donate] = (joined(p2), joined(o2[1]))
        norm = C.flatten_params(p2)["final_norm"]
        assert all(b is norm[0] for b in norm)
    for a, b in zip(runs[False], runs[True]):
        for path, v in a.items():
            assert torch.equal(v, b[path]), path
