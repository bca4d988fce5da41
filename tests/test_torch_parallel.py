"""The mesh-only parallel code of the port against the JAX package on the
CPU: `distributed.collectives.distributed_lse_decode`,
`models.moe.moe_ffn_replicated_ep` (and `moe_apply`'s choice of it),
`distributed.pipeline.gpipe_forward` / `pipeline_bubble_fraction`, and
`models.transformer.decode_step` over a sequence-sharded cache (the
reference's `long_500k` sharding: the sequence over every mesh axis).

The reference side runs in one subprocess on 8 virtual host devices
(the device count must be set before jax starts), fed and read through
``.npz`` files: the collective under `shard_map` on a ("data", "model")
(2, 4) mesh, the expert-parallel route and the decode step under
`jax.set_mesh` (the reference reads its ambient mesh), the decode step
jitted with the cache sharded over ("data", "model"). The port runs the
same inputs over `launch.mesh` meshes of 8 CPU shards.

A decode step past the cache's end is held against the reference's
step on a replicated cache: `dynamic_update_slice` clamps the write to
the last position, but XLA's partitioned form of it over the sharded
sequence axis drops a write whose offset is past the end (no shard
owns it). The port clamps at the global S, as the op is defined.

Bars: `distributed_lse_decode` within 1e-6 of max |ref| (float32); the
expert-parallel route's kept and dropped choices exactly, ``y`` within
1e-5 of max |ref| and ``aux`` within 1e-6 (float32); the pipeline at
`tests/test_distributed.py`'s bar (rtol 2e-4, atol 2e-5) and the bubble
fraction exactly; the sharded decode at the bars `tests/test_torch_lm.py`
holds decode to (float32 and bfloat16 compute), and within 1e-5 of max
|ref| of the port's own unsharded decode in float32, its cache equal.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_arch
from repro.distributed.pipeline import \
    pipeline_bubble_fraction as ref_bubble
from repro_torch.configs import get_arch
from repro_torch.distributed.collectives import distributed_lse_decode
from repro_torch.distributed.pipeline import (gpipe_forward,
                                              pipeline_bubble_fraction)
from repro_torch.launch.mesh import Spec, make_serving_mesh, shard_leaf
from repro_torch.models import common as C
from repro_torch.models import moe
from repro_torch.models import transformer as TT
from test_torch_lm import (BF16_JUMP, BF16_TOL, F32_JUMP, F32_TOL,
                           POS_SHARE, _moe_weights, assert_positions,
                           rel_err)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CPU = torch.device("cpu")
MOE_ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")
MOE_N, MOE_D = 64, 64
MOE_MESHES = {"2x4": (2, 4), "1x8": (1, 8)}
DECODE = {"llama3-8b": 1, "qwen2-moe-a2.7b": 2}   # arch -> batch rows
DECODE_S = 64                     # 8 blocks of 8 positions
# block 0's last position, block 1's first, the last block's last, and
# past the end (the write clamps to the global S - 1)
DECODE_POS = (7, 8, DECODE_S - 1, DECODE_S + 2)
DTYPES = ("float32", "bfloat16")

REF_PROG = r"""
import dataclasses
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.distributed.collectives import distributed_lse_decode  # noqa
from repro.distributed.pipeline import gpipe_forward  # noqa: E402
from repro.models import moe as M  # noqa: E402
from repro.models import transformer as T  # noqa: E402

inp = dict(np.load(sys.argv[1]))
out = {}
assert len(jax.devices()) == 8


def mesh_of(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(names))


ax = ("data", "model")
m24 = mesh_of((2, 4), ax)
for tag, masked in (("lse", False), ("lse_mask", True)):
    specs = (P(), P(None, ax), P(None, ax)) + ((P(None, ax),) if masked
                                              else ())
    fn = (lambda q, k, v, m: distributed_lse_decode(q, k, v, ax, m)) \
        if masked else (lambda q, k, v: distributed_lse_decode(q, k, v, ax))
    args = [inp["lse_q"], inp["lse_k"], inp["lse_v"]] + \
        ([inp["lse_mask"]] if masked else [])
    out[tag] = np.asarray(jax.jit(jax.shard_map(
        fn, mesh=m24, in_specs=specs, out_specs=P(), check_vma=False))(*args))

ep = jax.jit(M.moe_ffn_replicated_ep, static_argnums=(2,))
for arch in ("qwen2-moe-a2.7b", "dbrx-132b"):
    cfg = get_arch(arch).smoke_config().moe
    w = {k[len(arch) + 6:]: jnp.asarray(v) for k, v in inp.items()
         if k.startswith(f"moew_{arch}_")}
    x = jnp.asarray(inp["moe_x"])
    for tag, shape, names, n in (("2x4", (2, 4), ax, None),
                                 ("1x8", (1, 8), ax, None),
                                 ("2x4_odd", (2, 4), ax, -1),
                                 ("data8", (8,), ("data",), None)):
        with jax.set_mesh(mesh_of(shape, names)):
            y, aux = ep(x[:n], w, cfg)
        out[f"moe_{arch}_{tag}_y"] = np.asarray(y)
        out[f"moe_{arch}_{tag}_aux"] = np.asarray(aux)

m42 = mesh_of((4, 2), ("pod", "data"))
out["gpipe"] = np.asarray(gpipe_forward(m42, jnp.asarray(inp["gp_w"]),
                                        jnp.asarray(inp["gp_x"]),
                                        n_microbatches=8))

cspec = P(None, None, ax, None, None)
for arch in ("llama3-8b", "qwen2-moe-a2.7b"):
    base = get_arch(arch).smoke_config()
    params = T.init_params(base, jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = ".".join(p.key for p in path)
        out[f"params_{arch}_{key}"] = np.asarray(leaf)
    for cdt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=cdt)
        cache = {k: jnp.asarray(inp[f"cache_{arch}"]).astype(jnp.bfloat16)
                 for k in ("k", "v")}
        toks = jnp.asarray(inp[f"toks_{arch}"])
        with jax.set_mesh(m24):
            sharded = jax.jit(T.decode_step, static_argnums=(1,),
                              in_shardings=(None, {"k": cspec, "v": cspec},
                                            None, None))
            # past the end the partitioned dynamic_update_slice drops the
            # write where the whole one clamps it: that step runs on a
            # replicated cache
            whole = jax.jit(T.decode_step, static_argnums=(1,))
            for i, pos in enumerate(inp["decode_pos"]):
                step = sharded
                if pos >= cache["k"].shape[2]:
                    step = whole
                    cache = jax.device_put(cache, NamedSharding(m24, P()))
                toks, lg, cache = step(params, cfg, cache, toks,
                                       jnp.int32(pos))
                tag = f"dec_{arch}_{cdt}_{i}"
                out[tag + "_toks"] = np.asarray(toks)
                out[tag + "_logits"] = np.asarray(lg.astype(jnp.float32))
        for k in ("k", "v"):
            out[f"dec_{arch}_{cdt}_cache_{k}"] = np.asarray(
                cache[k].astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    B, Hkv, G, Dh, S = 2, 2, 3, 16, 64
    d = {"lse_q": rng.standard_normal((B, Hkv, G, Dh)).astype(np.float32),
         "lse_k": rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
         "lse_v": rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)}
    mask = rng.random((B, S)) < 0.7
    mask[:, 8:16] = False          # one whole shard masked
    d["lse_mask"] = mask
    d["moe_x"] = rng.standard_normal((MOE_N, MOE_D)).astype(np.float32)
    for arch in MOE_ARCHS:
        cfg = get_arch(arch).smoke_config().moe
        for k, v in _moe_weights(np.random.default_rng(4), cfg,
                                 MOE_D).items():
            d[f"moew_{arch}_{k}"] = v
    d["gp_w"] = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    d["gp_x"] = rng.standard_normal((8, 16, 16)).astype(np.float32)
    for arch, B in DECODE.items():
        c = get_arch(arch).smoke_config()
        d[f"cache_{arch}"] = rng.standard_normal(
            (c.n_layers, B, DECODE_S, c.n_kv_heads, c.d_head)) \
            .astype(np.float32)
        d[f"toks_{arch}"] = rng.integers(0, c.vocab, B).astype(np.int32)
    d["decode_pos"] = np.array(DECODE_POS, np.int32)
    return d


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs on 8 virtual host devices, from one
    subprocess."""
    d = tmp_path_factory.mktemp("parallel_ref")
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


def mesh(shape=(2, 4), names=("data", "model")):
    return make_serving_mesh([CPU] * 8, axes=dict(zip(names, shape)))


def blocks(x: np.ndarray, n: int = 8, axis: int = 1) -> list:
    return [torch.from_numpy(b) for b in np.split(x, n, axis=axis)]


# ------------------------------------------------- distributed_lse_decode
@pytest.mark.parametrize("masked", [False, True])
def test_distributed_lse_decode_matches_reference(reference, masked):
    inp, out = reference
    got = distributed_lse_decode(
        torch.from_numpy(inp["lse_q"]), blocks(inp["lse_k"]),
        blocks(inp["lse_v"]),
        blocks(inp["lse_mask"]) if masked else None)
    exp = out["lse_mask" if masked else "lse"]
    assert len(got) == 8
    for g in got:
        assert g.dtype == torch.float32 and g.device == CPU
        assert rel_err(g, exp) <= 1e-6


def test_distributed_lse_decode_equals_whole_softmax(reference):
    """The log-sum-exp combine is the softmax over the whole cache."""
    inp, _ = reference
    q, k, v = (torch.from_numpy(inp[n]).double()
               for n in ("lse_q", "lse_k", "lse_v"))
    lg = torch.einsum("bhgd,bshd->bhgs", q * q.shape[-1] ** -0.5, k)
    whole = torch.einsum("bhgs,bshd->bhgd", torch.softmax(lg, -1), v)
    got = distributed_lse_decode(q.float(), blocks(inp["lse_k"], 4),
                                 blocks(inp["lse_v"], 4))[0]
    assert rel_err(got, whole) <= 1e-5


# ------------------------------------------------- moe_ffn_replicated_ep
def _ref_ep_kept(x, router, cfg, DA, MP):
    """The reference's kept choices [K, N] of the replicated-EP route,
    restated in numpy from its `moe_ffn_replicated_ep` (its router
    through jax's softmax and top_k)."""
    E, Ep, K = cfg.num_experts, cfg.padded_experts, cfg.top_k
    N = len(x)
    NL, EL = N // DA, Ep // MP
    capL = min(NL, max(int(NL * K / Ep * cfg.capacity_factor), 8))
    logits = x.astype(np.float32) @ router
    logits[:, E:] = -1e30
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    idx = np.asarray(jax.lax.top_k(probs, K)[1])
    kept = np.zeros((K, N), bool)
    for d in range(DA):
        count = np.zeros(Ep, np.int64)
        for j in range(K):
            for n in range(d * NL, (d + 1) * NL):
                e = idx[n, j]
                kept[j, n] = count[e] < capL   # some "model" shard owns e
                count[e] += 1
    return kept, capL


@pytest.mark.parametrize("tag", list(MOE_MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_replicated_ep_matches_reference(reference, arch, tag):
    inp, out = reference
    cfg = get_arch(arch).smoke_config().moe
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_arch(arch).smoke_config().moe)
    w = {k[len(arch) + 6:]: torch.from_numpy(v) for k, v in inp.items()
         if k.startswith(f"moew_{arch}_")}
    x = torch.from_numpy(inp["moe_x"])
    m = mesh(MOE_MESHES[tag])
    y, aux = moe.moe_ffn_replicated_ep(x, w, cfg, m)
    y2, aux2 = moe.moe_apply(x, w, cfg, mesh=m)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert rel_err(y, out[f"moe_{arch}_{tag}_y"]) <= 1e-5
    np.testing.assert_allclose(float(aux), float(out[f"moe_{arch}_{tag}_aux"]),
                               rtol=1e-6)
    DA, MP = MOE_MESHES[tag]
    if cfg.padded_experts % MP:
        return                           # the fallback: moe_ffn's drops
    kept, capL = _ref_ep_kept(inp["moe_x"], inp[f"moew_{arch}_router"], cfg,
                              DA, MP)
    EL, NL = cfg.padded_experts // MP, MOE_N // DA
    got = np.zeros_like(kept)
    for d in range(DA):
        _, _, idx = moe.route(x[d * NL:(d + 1) * NL], w["router"], cfg)
        for mm in range(MP):
            for j, (_, _, keep) in enumerate(moe.ep_slots(
                    idx, cfg, capL, mm * EL, EL)):
                got[j, d * NL:(d + 1) * NL] |= keep.numpy()
    np.testing.assert_array_equal(got, kept)
    assert 0 < kept.mean() < 1           # some choices overflow


@pytest.mark.parametrize("case", ["ep_does_not_divide", "tokens_do_not_split",
                                  "no_model_axis", "no_mesh"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_replicated_ep_fallbacks(reference, arch, case):
    """The reference's fallbacks to `moe_ffn`: Ep % MP != 0 (dbrx-smoke's
    4 experts on 8 "model" shards; qwen2-moe-smoke's 8 divide), N % DA
    != 0 (63 tokens on 2 "data" shards), a mesh without "model" (where
    `moe_apply` takes `moe_ffn_chunked`), no mesh."""
    inp, out = reference
    cfg = get_arch(arch).smoke_config().moe
    w = {k[len(arch) + 6:]: torch.from_numpy(v) for k, v in inp.items()
         if k.startswith(f"moew_{arch}_")}
    x = torch.from_numpy(inp["moe_x"])
    if case == "ep_does_not_divide":
        m, tag = mesh((1, 8)), "1x8"
    elif case == "tokens_do_not_split":
        m, tag, x = mesh((2, 4)), "2x4_odd", x[:-1]
    elif case == "no_model_axis":
        m, tag = mesh((8,), ("data",)), "data8"
    else:
        m, tag = None, "data8"
    y, aux = moe.moe_ffn_replicated_ep(x, w, cfg, m)
    fy, faux = moe.moe_ffn(x, w, cfg)
    fell_back = case != "ep_does_not_divide" or cfg.padded_experts % 8
    if fell_back:
        assert torch.equal(y, fy) and torch.equal(aux, faux)
    assert rel_err(y, out[f"moe_{arch}_{tag}_y"]) <= 1e-5
    np.testing.assert_allclose(float(aux), float(out[f"moe_{arch}_{tag}_aux"]),
                               rtol=1e-6)


def test_shard_experts_places_each_shards_block():
    """Expert leaves stored by their `Spec` (`shard_leaf`, experts over
    "model"): shard k holds its "model" coordinate's experts; the EP
    route gives the same answer from stored and whole leaves; where the
    tokens do not split (N % DA != 0), whole leaves fall back to
    `moe_ffn` and stored ones raise (a fallback would join them on one
    device)."""
    cfg = get_arch("qwen2-moe-a2.7b").smoke_config().moe
    w = {k: torch.from_numpy(v) for k, v in _moe_weights(
        np.random.default_rng(1), cfg, MOE_D).items()}
    m = mesh((2, 4))
    split = dict(w, **{n: shard_leaf(w[n], Spec("model"), m)
                       for n in moe.EXPERT_LEAVES})
    for k in range(8):
        mm = m.coords(k)["model"]
        assert torch.equal(split["w_up"][k], w["w_up"][2 * mm:2 * mm + 2])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (32, MOE_D)).astype(np.float32))
    a = moe.moe_ffn_replicated_ep(x, w, cfg, m)
    b = moe.moe_ffn_replicated_ep(x, split, cfg, m)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    fy, faux = moe.moe_ffn(x[:-1], w, cfg)
    y, aux = moe.moe_ffn_replicated_ep(x[:-1], w, cfg, m)
    assert torch.equal(y, fy) and torch.equal(aux, faux)
    with pytest.raises(ValueError, match="never join"):
        moe.moe_ffn_replicated_ep(x[:-1], split, cfg, m)


# -------------------------------------------------------------- the pipeline
def test_gpipe_forward_matches_reference(reference):
    inp, out = reference
    m = mesh((4, 2), ("pod", "data"))
    y = gpipe_forward(m, torch.from_numpy(inp["gp_w"]),
                      torch.from_numpy(inp["gp_x"]), n_microbatches=8)
    np.testing.assert_allclose(y.numpy(), out["gpipe"], rtol=2e-4, atol=2e-5)
    ref = torch.from_numpy(inp["gp_x"])
    for w in torch.from_numpy(inp["gp_w"]):
        ref = torch.tanh(ref @ w)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("M,S", [(8, 4), (1, 1), (32, 4), (3, 7)])
def test_pipeline_bubble_fraction_matches_reference(M, S):
    assert pipeline_bubble_fraction(M, S) == ref_bubble(M, S)


# ------------------------------------------- decode over a sharded cache
def _port_params(arch, out):
    prefix = f"params_{arch}_"
    flat = {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}
    cfg = get_arch(arch).smoke_config()
    return C.param_tree(TT.params_from_numpy(cfg, C.nest_params(flat),
                                             device="cpu"))


def _sharded_cache(cache: np.ndarray) -> dict:
    t = torch.from_numpy(cache).to(torch.bfloat16)
    return {k: [b.clone() for b in torch.chunk(t, 8, dim=2)]
            for k in ("k", "v")}


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("arch", list(DECODE))
def test_sharded_decode_matches_reference(reference, arch, compute_dtype):
    """`decode_step` over the sequence-sharded cache on 8 CPU shards of a
    (2, 4) mesh against the reference's `decode_step` jitted with the
    cache sharded over ("data", "model"), the mesh passed to both, at a
    block's last position, the next block's first, the last position
    and past the end (there the reference's cache is replicated):
    tokens, logits and the cache at `tests/test_torch_lm.py`'s decode
    bars. The reference's tokens feed both sides."""
    inp, out = reference
    tp = _port_params(arch, out)
    tc = dataclasses.replace(get_arch(arch).smoke_config(),
                             compute_dtype=compute_dtype)
    cache = _sharded_cache(inp[f"cache_{arch}"])
    m = mesh()
    feed = torch.from_numpy(inp[f"toks_{arch}"])
    same = []
    for i, pos in enumerate(DECODE_POS):
        tag = f"dec_{arch}_{compute_dtype}_{i}"
        with torch.no_grad():
            tn, tl, got = TT.decode_step(tp, tc, cache, feed, int(pos),
                                         mesh=m)
        assert got is cache
        same.append(np.array_equal(tn.numpy(), out[tag + "_toks"]))
        if compute_dtype == "float32":
            assert_positions(tl, out[tag + "_logits"], F32_TOL, F32_JUMP, 0.5,
                             tag)
        else:
            assert_positions(tl, out[tag + "_logits"], BF16_TOL, BF16_JUMP,
                             0.5, tag)
        feed = torch.from_numpy(out[tag + "_toks"])
    if compute_dtype == "float32":
        assert all(same)
    else:
        assert np.mean(same) >= 0.5
    for k in ("k", "v"):
        assert all(b.shape[2] == DECODE_S // 8 for b in cache[k])
        assert_positions(torch.cat(cache[k], 2),
                         out[f"dec_{arch}_{compute_dtype}_cache_{k}"], 8e-3,
                         F32_JUMP, POS_SHARE, arch + k)


@pytest.mark.parametrize("arch", list(DECODE))
def test_sharded_decode_equals_unsharded(reference, arch):
    """The port's sharded decode against its own unsharded decode on the
    same cache and tokens (float32 compute): logits within 1e-5 of max
    |ref|, tokens equal. Layer 0's written entries and every unwritten
    position equal; the written entries of later layers within one bf16
    ulp, on at most 1% of them: a later layer's input comes from the
    attention before it, an LSE combine over the blocks on one side and
    one softmax on the other, whose float32 last bits can round a cache
    entry to the next bf16 value."""
    inp, out = reference
    tp = _port_params(arch, out)
    tc = dataclasses.replace(get_arch(arch).smoke_config(),
                             compute_dtype="float32")
    sharded = _sharded_cache(inp[f"cache_{arch}"])
    whole = {k: torch.from_numpy(inp[f"cache_{arch}"]).to(torch.bfloat16)
             for k in ("k", "v")}
    feed = torch.from_numpy(inp[f"toks_{arch}"])
    m = mesh()
    for pos in DECODE_POS:
        with torch.no_grad():
            sn, sl, _ = TT.decode_step(tp, tc, sharded, feed, int(pos),
                                       mesh=m)
            wn, wl, _ = TT.decode_step(tp, tc, whole, feed, int(pos),
                                       mesh=m)
        assert torch.equal(sn, wn)
        assert rel_err(sl, wl) <= 1e-5
        feed = wn
    written = sorted({min(p, DECODE_S - 1) for p in DECODE_POS})
    for k in ("k", "v"):
        got = torch.cat(sharded[k], 2)
        rest = [p for p in range(DECODE_S) if p not in written]
        assert torch.equal(got[:, :, rest], whole[k][:, :, rest]), k
        assert torch.equal(got[0, :, written], whole[k][0, :, written]), k
        a = got[1:, :, written].float()
        b = whole[k][1:, :, written].float()
        ulp = torch.ldexp(torch.ones_like(a), torch.frexp(
            torch.maximum(a.abs(), b.abs())).exponent - 8)
        assert ((a - b).abs() <= ulp).all(), k
        assert (a != b).float().mean() <= 0.01, k


def test_sharded_cache_layout_and_clamp():
    """`init_cache(mesh=)` gives one contiguous block a shard on its
    device, refuses a length that does not split, and a write past the
    end lands on the global S - 1 (the last block's last row), as
    `dynamic_update_slice` clamps, equal to the unsharded decode."""
    cfg = dataclasses.replace(get_arch("llama3-8b").smoke_config(),
                              compute_dtype="float32")
    m = mesh()
    cache = TT.init_cache(cfg, 1, 32, mesh=m)
    assert [b.shape for b in cache["k"]] == \
        [(cfg.n_layers, 1, 4, cfg.n_kv_heads, cfg.d_head)] * 8
    assert all(b.device == CPU for b in cache["v"])
    with pytest.raises(ValueError):
        TT.init_cache(cfg, 1, 30, mesh=m)
    # pos 40 (past the end) writes row 31 only
    params = C.param_tree(TT.LM(cfg, device="cpu", seed=0))
    whole = TT.init_cache(cfg, 1, 32, device="cpu")
    toks = torch.tensor([5])
    with torch.no_grad():
        a = TT.decode_step(params, cfg, cache, toks, 40, mesh=m)
        b = TT.decode_step(params, cfg, whole, toks, 40)
    assert torch.equal(a[0], b[0]) and rel_err(a[1], b[1]) <= 1e-5
    for k in ("k", "v"):
        got = torch.cat(cache[k], 2)
        assert torch.equal(got, whole[k])
        assert got[:, :, 31].abs().sum() > 0
        assert got[:, :, :31].abs().sum() == 0
