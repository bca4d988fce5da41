"""Serving over a mesh and sharded train-state checkpoints, the port
against the JAX package on the CPU: `transformer.prefill_step` over
parameters stored by their `PartitionSpec`s (`launch.mesh.Sharded`),
its sequence-sharded cache, `decode_step` from that cache, and
`checkpoint.CheckpointManager` / `FaultTolerantRunner` over a train
state whose leaves are `Sharded`.

The reference side runs in one subprocess on 8 virtual host devices,
fed and read through ``.npz`` files and checkpoint directories, as in
`tests/test_torch_train_mesh.py`: for llama3-8b, qwen2-moe-a2.7b and
dbrx-132b's smoke configs (float32 compute), its `prefill_step` jitted
with the prefill cell's shardings (`configs.lm_common.make_lm_cell`:
parameters by their specs, the prompt's rows and the cache's batch
over "data", the residual stream pinned by the cell's ``act_spec``) on
a ("data", "model") 4 x 2 mesh under `jax.set_mesh`, then `decode_step`
jitted with the decode cell's shardings on its cache zero-padded to
`MAX_LEN`; and `repro.checkpoint.ckpt.CheckpointManager` restoring the
port's checkpoint of a sharded train state, then saving that state
stored by its specs over the same mesh. The port runs the same weights
(carried across from numpy) over 8 CPU shards (4 x 2).

Bars against the reference: next tokens and greedy tokens equal; the
cache at [0, T) within `tests/test_torch_lm.py`'s float32 bar for the
bf16 cache (8e-3 of max |ref| at half the positions, `F32_JUMP` at
every one); decode logits at that file's decode bars, as
`tests/test_torch_train_mesh.py` holds decode over stored parameters;
the rest of the cache zero. Against the port's one-device serving of
the same dense weights: the prefill bit for bit, decode within
`OWN_TOL` (the mesh sums the softmax over sequence blocks), bit for bit
over the same blocks. Checkpoints: keys, shapes and values exactly.
"""
import dataclasses
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.checkpoint.fault import FaultTolerantRunner, Heartbeat
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import (Sharded, Spec, join_leaf,
                                     make_serving_mesh, shard_leaf)
from repro_torch.models import common as C
from repro_torch.models import transformer as TT
from repro_torch.train import optim as O
from repro_torch.train.loop import make_train_step
from repro_torch.train.tree import flatten_global, flatten_with_paths
from test_torch_lm import F32_JUMP, F32_TOL, POS_SHARE, assert_positions

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CPU = torch.device("cpu")
ARCHS = ("llama3-8b", "qwen2-moe-a2.7b", "dbrx-132b")
B, T = 4, 16                  # 4 data shards of one row
MAX_LEN = 24                  # the cache: 8 sequence blocks of 3
STEPS = 4                     # greedy decode steps at T .. T + 3
CACHE_TOL = 8e-3              # one bf16 ulp (test_torch_lm's cache bar)
CKPT_ARCH = "dbrx-132b"       # 4-d expert specs beside replicated leaves
OWN_TOL = 1e-5                # the port against itself, float32
CKPT_ROWS, CKPT_SEQ = 8, 16
LR = 1e-3

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

from repro.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.train import optim as O  # noqa: E402

inp = dict(np.load(sys.argv[1]))
out = {}
assert len(jax.devices()) == 8
devs = np.array(jax.devices()).reshape(4, 2)
mesh = jax.sharding.Mesh(devs, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
is_spec = lambda s: isinstance(s, P)  # noqa: E731
bd = "data"                       # lm_common._bd(multi_pod=False)
T_, S = int(inp["T"]), int(inp["max_len"])


def flat(tree):
    return {".".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


init = {}
for arch in ("llama3-8b", "qwen2-moe-a2.7b", "dbrx-132b"):
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              compute_dtype="float32")
    params = init[arch] = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.key(0))
    for k, v in flat(params).items():
        out[f"init_{arch}.{k}"] = np.asarray(v, np.float32)
    ps = T.param_shardings(cfg)
    # make_lm_cell's prefill cell (single pod)
    act = (P(bd, None, "model") if cfg.heads_shardable
           else P(bd, "model", None))
    cspec = (P(None, bd, None, "model", None)
             if cfg.n_kv_heads % cfg.tp_size == 0
             else P(None, bd, "model", None, None))
    with jax.set_mesh(mesh):
        pre = jax.jit(lambda p, t: T.prefill_step(p, cfg, t, act_spec=act),
                      in_shardings=(ps, P(bd, None)),
                      out_shardings=(P(bd), {"k": cspec, "v": cspec}))
        nxt, cache = pre(params, jnp.asarray(inp["prompt"]))
    out[f"pre_{arch}_next"] = np.asarray(nxt)
    for k in ("k", "v"):
        out[f"pre_{arch}_{k}"] = np.asarray(cache[k].astype(jnp.float32))
    # the decode cell (batch > 1) on the cache zero-padded to S
    cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, S - T_), (0, 0), (0, 0)))
             for k, v in cache.items()}
    with jax.set_mesh(mesh):
        dec = jax.jit(T.decode_step, static_argnums=(1,),
                      in_shardings=(ps, {"k": cspec, "v": cspec}, P(bd),
                                    P()))
        toks = nxt
        for i in range(int(inp["steps"])):
            toks, lg, cache = dec(params, cfg, cache, toks,
                                  jnp.int32(T_ + i))
            out[f"dec_{arch}_{i}_toks"] = np.asarray(toks)
            out[f"dec_{arch}_{i}_logits"] = np.asarray(lg)

# the port's checkpoint of a sharded train state, restored here; then
# the same state stored by its specs over the mesh, saved by the
# reference
cfg = get_arch("dbrx-132b").smoke_config()
ocfg = O.OptimizerConfig(lr=1e-3, warmup_steps=0)
p0 = init["dbrx-132b"]
got, step = CheckpointManager(sys.argv[3]).restore(
    {"params": p0, "opt_state": O.init_opt_state(ocfg, p0)})
leaves = jax.tree_util.tree_flatten_with_path(got)[0]
for path, leaf in leaves:
    key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                   for p in path)
    out["ckpt:" + key] = np.asarray(leaf)
ps = T.param_shardings(cfg)
shard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                     {"params": ps,
                      "opt_state": O.opt_state_shardings(ocfg, ps)},
                     is_leaf=is_spec)
placed = jax.device_put(got, shard)
out["ckpt_w_gate_shards"] = np.asarray(len(
    placed["params"]["layers"]["w_gate"].addressable_shards))
out["ckpt_w_gate_shard_shape"] = np.asarray(
    placed["params"]["layers"]["w_gate"].addressable_shards[0].data.shape)
CheckpointManager(sys.argv[4]).save(step, placed)
np.savez(sys.argv[2], **out)
"""


def mesh(shape=(4, 2)):
    return make_serving_mesh([CPU] * int(np.prod(shape)),
                             axes=dict(zip(("data", "model"), shape)))


def joined(tree) -> dict:
    """{key: global tensor} of a tree, its `Sharded` leaves joined."""
    return {k: join_leaf(v) if isinstance(v, Sharded) else v
            for k, v in flatten_global(tree).items()}


def _ckpt_batch(step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, 128, (CKPT_ROWS, CKPT_SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


def _ckpt_setup(shape):
    """dbrx-132b's smoke config (float32) over a ("data", "model") mesh:
    its train step and a fresh state, every leaf stored by its spec."""
    cfg = dataclasses.replace(get_arch(CKPT_ARCH).smoke_config(),
                              compute_dtype="float32")
    m = mesh(shape)
    ocfg = O.OptimizerConfig(lr=LR, warmup_steps=0)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), mesh=m)
    step = make_train_step(lambda p, b: TT.loss_fn(p, cfg, b), ocfg, mesh=m)
    return step, params, O.init_opt_state(ocfg, params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's checkpoint of a sharded train state (one AdamW step
    over 8 CPU shards), then the reference's outputs on 8 virtual host
    devices from one subprocess."""
    d = tmp_path_factory.mktemp("serve_mesh")
    rng = np.random.default_rng(0)
    inp = {"prompt": rng.integers(0, 128, (B, T)).astype(np.int32),
           "T": np.int32(T), "max_len": np.int32(MAX_LEN),
           "steps": np.int32(STEPS)}
    np.savez(d / "in.npz", **inp)
    step, params, opt = _ckpt_setup((4, 2))
    params, opt, _ = step(params, opt, _ckpt_batch(0))
    state = {"params": params, "opt_state": opt}
    port_dir, ref_dir = d / "port_ckpt", d / "ref_ckpt"
    CheckpointManager(str(port_dir)).save(1, state)
    (d / "ref.py").write_text(REF_PROG)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(d / "ref.py"), str(d / "in.npz"),
                        str(d / "out.npz"), str(port_dir), str(ref_dir)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return {"inp": inp, "out": dict(np.load(d / "out.npz")),
            "state": state, "port_dir": str(port_dir),
            "ref_dir": str(ref_dir)}


def port_params(arch, out) -> tuple:
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              compute_dtype="float32")
    p = f"init_{arch}."
    tree = C.nest_params({k[len(p):]: v for k, v in out.items()
                          if k.startswith(p)})
    return cfg, C.param_tree(TT.params_from_numpy(cfg, tree, device="cpu"))


def whole_cache(cache) -> dict:
    return {k: torch.cat(v, dim=2) for k, v in cache.items()}


# --------------------------------------------------------------- prefill
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_over_stored_params_matches_reference(world, arch):
    """The port's `prefill_step` over leaves stored by their specs on 8
    CPU shards: the next tokens equal the reference's under its prefill
    cell's shardings; the cache is `init_cache(..., mesh=)`'s (8
    sequence blocks of every row, bf16), at [0, T) within the float32
    cache bar of the reference's, zero after."""
    inp, out = world["inp"], world["out"]
    cfg, params = port_params(arch, out)
    m = mesh()
    sp = TT.shard_params(params, cfg, m)
    with torch.no_grad():
        nxt, cache = TT.prefill_step(sp, cfg, inp["prompt"], max_len=MAX_LEN)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), out[f"pre_{arch}_next"])
    for k in ("k", "v"):
        blocks = cache[k]
        assert len(blocks) == m.size
        assert all(b.shape == (cfg.n_layers, B, MAX_LEN // m.size,
                               cfg.n_kv_heads, cfg.d_head)
                   and b.dtype == torch.bfloat16 for b in blocks)
        got = whole_cache(cache)[k]
        assert_positions(got[:, :, :T], out[f"pre_{arch}_{k}"], CACHE_TOL,
                         F32_JUMP, POS_SHARE, f"{arch} {k}")
        assert not got[:, :, T:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_prefilled_cache_matches_reference(world, arch):
    """`STEPS` greedy `decode_step`s over the stored leaves from the
    prefilled, sequence-sharded cache (each fed the reference's last
    token) against the reference's decode cell on its cache zero-padded
    to `MAX_LEN`: greedy tokens equal, logits at the decode bars."""
    inp, out = world["inp"], world["out"]
    cfg, params = port_params(arch, out)
    sp = TT.shard_params(params, cfg, mesh())
    with torch.no_grad():
        feed, cache = TT.prefill_step(sp, cfg, inp["prompt"],
                                      max_len=MAX_LEN)
        for i in range(STEPS):
            tok, lg, cache = TT.decode_step(sp, cfg, cache, feed, T + i)
            np.testing.assert_array_equal(tok.numpy(),
                                          out[f"dec_{arch}_{i}_toks"])
            assert_positions(lg, out[f"dec_{arch}_{i}_logits"], F32_TOL,
                             F32_JUMP, 0.5, f"{arch} decode {i}")
            feed = torch.from_numpy(out[f"dec_{arch}_{i}_toks"])


def test_dense_mesh_serving_against_one_device(world):
    """llama3-8b: prefill and decode over the stored leaves on 8 CPU
    shards against the port's one-device `prefill_step` (into a cache of
    `MAX_LEN`) and `decode_step` on the same weights. The prefill is bit
    for bit: next tokens, logits, every cache entry (the default cache
    is the prompt's length; `forward(..., collect_kv=True)` over the
    stored leaves gives each layer's data-shard keys and values, which
    the cache holds rounded to bf16). Decode over the one-device cache
    whole is not: it sums the softmax over the whole sequence, the mesh
    over its 8 blocks (`gqa_attention_sharded`), so the logits agree
    within `OWN_TOL` of max |ref| with greedy tokens equal; over the
    one-device prefill's cache split into the same 8 blocks, decode is
    bit for bit again."""
    inp, out = world["inp"], world["out"]
    cfg, params = port_params("llama3-8b", out)
    m = mesh()
    sp = TT.shard_params(params, cfg, m)
    prompt = inp["prompt"]
    with torch.no_grad():
        mn, mc, ml = TT.prefill_step(sp, cfg, prompt, return_logits=True,
                                     max_len=MAX_LEN)
        on, oc, ol = TT.prefill_step(params, cfg, prompt,
                                     return_logits=True, max_len=MAX_LEN)
        assert torch.equal(mn, on) and torch.equal(ml, ol)
        for k in ("k", "v"):
            assert torch.equal(whole_cache(mc)[k], oc[k])
        sn, sc = TT.prefill_step(sp, cfg, prompt)
        assert torch.equal(sn, mn)
        for k in ("k", "v"):
            assert len(sc[k]) == m.size
            assert torch.equal(whole_cache(sc)[k], oc[k][:, :, :T])
        _, _, (ks, vs) = TT.forward(sp, cfg, prompt, collect_kv=True)
        assert len(ks) == cfg.n_layers and len(ks[0]) == 4
        for i in range(cfg.n_layers):
            for name, kv in (("k", ks), ("v", vs)):
                assert torch.equal(torch.cat(kv[i]).to(torch.bfloat16),
                                   oc[name][i, :, :T])
        split = {k: list(torch.chunk(v.clone(), m.size, dim=2))
                 for k, v in oc.items()}
        mt, ot, st = mn, on, on
        for i in range(STEPS):
            mt, mlg, mc = TT.decode_step(sp, cfg, mc, mt, T + i)
            ot, olg, oc = TT.decode_step(params, cfg, oc, ot, T + i)
            st, slg, split = TT.decode_step(params, cfg, split, st, T + i)
            assert torch.equal(mt, ot) and torch.equal(mt, st), i
            assert torch.equal(mlg, slg), i
            err = float((mlg - olg).abs().max() / olg.abs().max())
            assert err <= OWN_TOL, (i, err)
        for k in ("k", "v"):
            assert torch.equal(whole_cache(mc)[k], whole_cache(split)[k])


def test_prefill_cache_shorter_than_the_prompt_raises():
    cfg = dataclasses.replace(get_arch("llama3-8b").smoke_config(),
                              compute_dtype="float32")
    m = mesh()
    sp = TT.init_params(cfg, torch.Generator().manual_seed(0), mesh=m)
    with pytest.raises(ValueError):
        TT.prefill_step(sp, cfg, np.zeros((B, T), np.int32), max_len=8)
    with pytest.raises(ValueError):          # 20 positions over 8 shards
        TT.prefill_step(sp, cfg, np.zeros((B, T), np.int32), max_len=20)


# ----------------------------------------------------------- checkpoints
def test_sharded_checkpoint_is_the_references_file(world):
    """The port's checkpoint of a train state stored over 8 CPU shards
    has the keys, global shapes and dtypes the reference writes for the
    same state stored over its 8 devices, and the reference's
    `CheckpointManager.restore` loads every leaf equal to the port's
    global leaf."""
    out, state = world["out"], world["state"]
    port = np.load(os.path.join(world["port_dir"], "step_00000001",
                                "state.npz"))
    ref = np.load(os.path.join(world["ref_dir"], "step_00000001",
                               "state.npz"))
    assert sorted(port.files) == sorted(ref.files)
    assert "params/layers/w_gate" in port.files
    assert not any(k.endswith("/0") for k in port.files)
    for k in port.files:
        assert port[k].shape == ref[k].shape and \
            port[k].dtype == ref[k].dtype, k
    assert CheckpointManager(world["port_dir"]).manifest(1) == \
        CheckpointManager(world["ref_dir"]).manifest(1)
    # the reference held the state split over its 8 devices
    assert int(out["ckpt_w_gate_shards"]) == 8
    assert tuple(out["ckpt_w_gate_shard_shape"]) != \
        port["params/layers/w_gate"].shape
    for k, v in joined(state).items():
        np.testing.assert_array_equal(out["ckpt:" + k], v.numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2)])
def test_reference_checkpoint_restores_onto_a_mesh(world, shape):
    """The reference's checkpoint of the sharded state restores in the
    port onto 8 shards (4 x 2) and onto 4 (2 x 2): every leaf `Sharded`
    by its like-leaf's spec over that mesh, each block the like-leaf's
    region of the global array, equal to the port's state."""
    _, params, opt = _ckpt_setup(shape)
    like = {"params": params, "opt_state": opt}
    got, step = CheckpointManager(world["ref_dir"]).restore(like)
    assert step == 1
    exp = joined(world["state"])
    flat_like = flatten_global(like)
    for k, leaf in flatten_global(got).items():
        if isinstance(flat_like[k], Sharded):
            assert isinstance(leaf, Sharded) and leaf.mesh is \
                flat_like[k].mesh and leaf.spec == flat_like[k].spec, k
            for b, ref_b in zip(leaf, shard_leaf(exp[k], leaf.spec,
                                                 leaf.mesh)):
                assert torch.equal(b, ref_b), k
        assert torch.equal(join_leaf(leaf) if isinstance(leaf, Sharded)
                           else leaf, exp[k]), k


def test_port_checkpoint_restores_onto_a_smaller_mesh(world):
    """The port's own 8-shard checkpoint restored onto a 4-shard mesh
    gives the same global leaves; restored onto 8 it gives the same
    blocks."""
    exp = joined(world["state"])
    for shape in ((2, 2), (4, 2)):
        _, params, opt = _ckpt_setup(shape)
        got, _ = CheckpointManager(world["port_dir"]).restore(
            {"params": params, "opt_state": opt})
        for k, v in joined(got).items():
            assert torch.equal(v, exp[k]), (shape, k)
    flat = flatten_with_paths(world["state"])
    for k, v in flatten_with_paths(got).items():
        assert torch.equal(v, flat[k]), k


def test_sharded_leaf_is_one_key_not_its_blocks(tmp_path):
    """The fault this file guards against: a leaf w [8, 4] stored by
    P("data", "model") over a 2 x 2 mesh was saved as its four blocks
    (``params/w/0`` .. ``/3``, [4, 2] each), so that restoring it into
    the same leaf stored over 2 shards raised a shape mismatch. It is
    one key of the global shape, and restores onto either mesh; the
    optimizer's walk (`flatten_with_paths`) still sees the blocks."""
    w = torch.arange(32.).reshape(8, 4)
    m4 = make_serving_mesh([CPU] * 4, axes={"data": 2, "model": 2})
    m2 = make_serving_mesh([CPU] * 2, axes={"data": 2})
    state = {"params": {"w": shard_leaf(w, Spec("data", "model"), m4),
                        "b": torch.ones(3)}}
    assert sorted(flatten_with_paths(state)) == [
        "params/b", "params/w/0", "params/w/1", "params/w/2", "params/w/3"]
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, state)
    z = np.load(tmp_path / "step_00000001" / "state.npz")
    assert sorted(z.files) == ["params/b", "params/w"]
    assert z["params/w"].shape == (8, 4)
    for m in (m2, m4):
        like = {"params": {"w": shard_leaf(torch.zeros(8, 4),
                                           Spec("data", "model"), m),
                           "b": torch.zeros(3)}}
        got, _ = cm.restore(like)
        leaf = got["params"]["w"]
        assert isinstance(leaf, Sharded) and leaf.mesh is m
        assert [tuple(b.shape) for b in leaf] == [tuple(b.shape) for b in
                                                  like["params"]["w"]]
        assert torch.equal(join_leaf(leaf), w)
    bad = {"params": {"w": shard_leaf(torch.zeros(4, 4),
                                      Spec("data", "model"), m2),
                      "b": torch.zeros(3)}}
    with pytest.raises(ValueError, match="shape mismatch for params/w"):
        cm.restore(bad)


def test_unsharded_checkpoint_bytes_equal_np_savez(tmp_path):
    """A state of plain tensors is written byte for byte as `np.savez`
    writes its arrays (the clock fixed: a zip entry carries its time)."""
    state = {"params": {"w": torch.arange(6.).reshape(2, 3)},
             "opt_state": O.init_opt_state(
                 O.OptimizerConfig(), {"w": torch.zeros(2, 3)})}
    with mock.patch.object(time, "time", return_value=1.7e9):
        CheckpointManager(str(tmp_path / "c")).save(3, state)
        np.savez(tmp_path / "ref.npz", **{
            k: v.numpy() for k, v in flatten_with_paths(state).items()})
    assert (tmp_path / "c" / "step_00000003" / "state.npz").read_bytes() \
        == (tmp_path / "ref.npz").read_bytes()


def test_fault_tolerant_runner_remeshes_onto_four_shards(tmp_path):
    """`FaultTolerantRunner` over 8 CPU shards (4 x 2) with a failure
    injected at step 1 (restored from step 0 on the same mesh) and four
    workers lost during step 3: `remesh_fn` rebuilds the step and state
    over 4 shards (2 x 2), the step-4 checkpoint written over 8 shards is
    restored onto them, and steps 4 and 5 run there. The final
    parameters and moments equal, bit for bit, those of an uninterrupted
    run on 4 shards from the same checkpoint."""
    step8, params, opt = _ckpt_setup((4, 2))
    hb = Heartbeat(n_workers=8, timeout_s=1e19)   # no beat yet: alive
    remeshed = []

    def remesh(n_alive):
        remeshed.append(n_alive)
        return _ckpt_setup((2, 2))

    def batch_for_step(s):
        if s == 3 and runner.heartbeat is hb:
            for w in range(4, 8):                  # silent from now on
                hb.last[w] = -1e20
        return _ckpt_batch(s)

    cm = CheckpointManager(str(tmp_path))
    runner = FaultTolerantRunner(step8, params, opt, cm, ckpt_every=2,
                                 failure_schedule={1: RuntimeError("down")},
                                 heartbeat=hb, remesh_fn=remesh)
    log = runner.run(None, max_steps=6, batch_for_step=batch_for_step)
    assert remeshed == [4] and runner.restarts == 2
    assert [r["event"] for r in log].count("failure") == 1
    assert [r["step"] for r in log if r["event"] == "step"] == \
        [0, 0, 1, 2, 3, 4, 5]
    m4 = flatten_global(runner.params)["layers/wq"].mesh
    assert m4.shape == (2, 2)
    step4, p4, o4 = _ckpt_setup((2, 2))
    state, at = cm.restore({"params": p4, "opt_state": o4}, step=4)
    assert at == 4
    p4, o4 = state["params"], state["opt_state"]
    for s in (4, 5):
        p4, o4, _ = step4(p4, o4, _ckpt_batch(s))
    got = joined({"params": runner.params, "opt_state": runner.opt_state})
    for k, v in joined({"params": p4, "opt_state": o4}).items():
        assert torch.equal(got[k], v), k
    assert int(runner.opt_state.step) == 6
