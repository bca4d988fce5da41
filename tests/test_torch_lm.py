"""CPU parity of the LM family of the port (`repro_torch.models.transformer`,
`.attention`, `.moe`, the LM half of `.common`, `data.lm`, the LM
configs) against the reference package: the same numpy inputs through
both, the reference's `init_params` carried across with
`params_from_numpy`, at the five archs' `smoke_config()`s.

Tolerances (of max |ref| unless said otherwise):
- building blocks and attention in float32: 1e-6 (2e-6 for rope on
  bf16-rounded angles); bfloat16 blocks: 1.6e-2 (two bf16 ulps: torch
  rounds after every op where XLA may keep float32 inside a fusion);
- the model in float32 compute (`compute_dtype="float32"`): at least half
  of the positions within 1e-5 and every one within `F32_JUMP` (3e-2),
  greedy tokens equal everywhere. The reference's attention rounds
  ``q * scale``, k, the probabilities and v to bfloat16 whatever the
  compute dtype, so where a float32 value sits within an ulp of a
  bfloat16 rounding boundary, a sum-order difference in the last bit
  (rms_norm's mean, softmax) rounds it the other way: that position's
  attention jumps, and every later position of its row with it. The
  reference jumps alike (by 1e-3-4e-3 of max |ref| at these configs)
  when its embedding table moves by one float32 ulp;
- gradients in float32 compute: each leaf's Frobenius relative error
  within 2e-3; AdamW steps taken from the reference's state each step:
  the loss within 1e-5 (relative), the gradient norm within 1e-3 and
  each new leaf's Frobenius relative error within 1e-3 (a free-running
  trajectory drifts, as Adam turns last-bit noise in a near-zero
  gradient entry into a whole step of its sign);
- bfloat16 compute: at least 75% of the positions within 2e-2 and every
  one within 0.5 (a token whose top-k experts reorder in bf16 takes
  another expert's output), greedy tokens equal at >= 90% of positions;
- `TokenStream`, `count_params`, the configs and the parameter counts
  exactly; `moe_ffn`'s dispatch (which tokens are dropped) exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_arch
from repro.configs import lm_common as ref_lmc
from repro.data.lm import TokenStream as RefStream
from repro.kernels import ref as ref_kernels
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro.models import transformer as RT
from repro.train import optim as ref_optim
from repro.train.loop import make_train_step as ref_make_train_step

from repro_torch.configs import get_arch
from repro_torch.configs import lm_common as lmc
from repro_torch.data.lm import TokenStream
from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import moe
from repro_torch.models import transformer as TT
from repro_torch.train import optim as topt
from repro_torch.train.loop import make_train_step

LM_ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b", "llama3-8b", "codeqwen1.5-7b",
            "qwen2.5-14b"]
F32_TOL = 1e-5        # float32 compute, the share POS_SHARE of positions
F32_JUMP = 3e-2       # float32 compute, every position
POS_SHARE = 0.5
BF16_TOL = 2e-2       # bfloat16 compute, the share BF16_SHARE of positions
BF16_JUMP = 0.5
BF16_SHARE = 0.75
GRAD_TOL = 2e-3      # gradients: each leaf's Frobenius relative error


def to_np(t):
    if torch.is_tensor(t):
        return t.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32)) \
        if isinstance(t, jax.Array) else np.asarray(t, np.float32)


def rel_err(got, exp) -> float:
    got, exp = np.asarray(to_np(got), np.float64), np.asarray(to_np(exp),
                                                              np.float64)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


def fro_err(got, exp) -> float:
    got, exp = np.asarray(to_np(got), np.float64), np.asarray(to_np(exp),
                                                              np.float64)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    return float(np.linalg.norm(got - exp) / max(np.linalg.norm(exp),
                                                 1e-30))


def assert_positions(got, exp, tol, jump, share, what=""):
    """``got`` against ``exp`` [..., vocab-like last axis]: the share of
    positions (rows over the last axis) within ``tol`` of max |exp| is at
    least ``share`` and every position is within ``jump``."""
    got, exp = np.asarray(to_np(got), np.float64), np.asarray(to_np(exp),
                                                              np.float64)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    scale = np.abs(exp).max()
    per = np.abs(got - exp).reshape(-1, exp.shape[-1]).max(-1) / scale
    assert (per <= tol).mean() >= share, (what, np.sort(per)[-5:])
    assert per.max() <= jump, (what, per.max())



_MODELS: dict = {}
# the reference's entry points, compiled once per config (eager, each
# call would re-trace its layer scan)
ref_init = jax.jit(RT.init_params, static_argnums=(0,))
ref_forward = jax.jit(RT.forward, static_argnums=(1,))
ref_prefill = jax.jit(RT.prefill_step, static_argnums=(1,))
ref_decode = jax.jit(RT.decode_step, static_argnums=(1,))
ref_moe_apply = jax.jit(ref_moe.moe_apply, static_argnums=(2,))


def models(arch: str, compute_dtype: str = "float32"):
    """(reference cfg, port cfg, reference params, port params) at the
    arch's smoke config in ``compute_dtype``: the reference's init, seed
    0, carried across (cached; no test mutates them)."""
    if arch not in _MODELS:
        jc, tc = ref_arch(arch).smoke_config(), get_arch(arch).smoke_config()
        jp = ref_init(jc, jax.random.key(0))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        _MODELS[arch] = (jp, C.param_tree(TT.params_from_numpy(
            tc, tree, device="cpu")))
    jp, tp = _MODELS[arch]
    return (dataclasses.replace(ref_arch(arch).smoke_config(),
                                compute_dtype=compute_dtype),
            dataclasses.replace(get_arch(arch).smoke_config(),
                                compute_dtype=compute_dtype), jp, tp)


def tokens(vocab, B=2, T=32, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)) \
        .astype(np.int32)


# ------------------------------------------------------------ TokenStream
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, 123)])
def test_token_stream_batches_are_byte_equal(seed, step):
    """Two batches from a cursor set at ``step``, then the iterator after
    the cursor is set back: the same bytes as the reference's."""
    a = RefStream(1000, 64, 3, seed=seed, doc_len_mean=16)
    b = TokenStream(1000, 64, 3, seed=seed, doc_len_mean=16)
    a.set_cursor(step)
    b.set_cursor(step)
    first = None
    for _ in range(2):
        ra, rb = a.next_batch(), b.next_batch()
        first = first or ra
        for k in ("tokens", "labels"):
            assert ra[k].dtype == rb[k].dtype == np.int32
            np.testing.assert_array_equal(ra[k], rb[k])
    assert a.step == b.step == step + 2
    b.set_cursor(step)
    np.testing.assert_array_equal(next(iter(b))["labels"], first["labels"])


# ------------------------------------------------------- building blocks
def _block_inputs(rng):
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    return {
        "rms_norm": (x.reshape(2, 8, 64),
                     rng.standard_normal(64).astype(np.float32)),
        "apply_rope": (x, *(rng.standard_normal((8, 8)).astype(np.float32)
                            for _ in range(2))),
        "swiglu": (x.reshape(2, 8, 64),) + tuple(
            (rng.standard_normal(s) / 8).astype(np.float32)
            for s in ((64, 96), (64, 96), (96, 64))),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["rms_norm", "apply_rope", "swiglu"])
def test_building_blocks_match_reference(fn, dtype):
    args = _block_inputs(np.random.default_rng(0))[fn]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    exp = getattr(ref_common, fn)(*(jnp.asarray(a).astype(jd) for a in args))
    got = getattr(C, fn)(*(torch.from_numpy(a).to(td) for a in args))
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 1.6e-2
    assert rel_err(got, exp) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta,d_head", [(1e4, 16), (5e5, 128), (1e6, 12)])
def test_rope_angles_match_reference(theta, d_head, dtype):
    pos = np.array([0, 1, 7, 511, 4096, 32767], np.int32)
    js, jc = ref_common.rope_angles(jnp.asarray(pos), d_head, theta,
                                    jnp.dtype(dtype))
    ts, tc = C.rope_angles(torch.from_numpy(pos), d_head, theta,
                           getattr(torch, dtype))
    assert ts.dtype == tc.dtype == getattr(torch, dtype)
    # angles reach 32,767 rad, where one float32 ulp is ~4e-3: sin / cos
    # of the same float32 angle, computed by two libraries
    tol = 2e-6 if dtype == "float32" else 8e-3
    assert np.abs(to_np(ts) - to_np(js)).max() <= tol
    assert np.abs(to_np(tc) - to_np(jc)).max() <= tol


def test_mlp_and_count_params_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    ws = [(rng.standard_normal((12, 20)).astype(np.float32),
           rng.standard_normal(20).astype(np.float32)),
          (rng.standard_normal((20, 3)).astype(np.float32),
           rng.standard_normal(3).astype(np.float32))]
    exp = ref_common.mlp(None, jnp.asarray(x),
                         [(jnp.asarray(w), jnp.asarray(b)) for w, b in ws])
    got = C.mlp(None, torch.from_numpy(x),
                [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in ws])
    assert rel_err(got, exp) <= 1e-6
    for arch in LM_ARCHS:
        jc, tc, jp, tp = models(arch)
        n = ref_common.count_params(jp)
        assert C.count_params(tp) == n
        assert C.count_params(TT.params_to_numpy(tp)) == n


# ------------------------------------------------------------ attention
def _qkv(rng, B, T, S, Hq, Hkv, Dh, dtype="float32"):
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh))]
    return ([jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


ATTN_CASES = {
    "causal_g1": dict(B=2, T=24, S=24, Hq=4, Hkv=4),
    "causal_g2": dict(B=2, T=24, S=24, Hq=4, Hkv=2),
    "causal_g4_bf16": dict(B=1, T=24, S=24, Hq=8, Hkv=2, dtype="bfloat16"),
    "window": dict(B=2, T=40, S=40, Hq=4, Hkv=2, kw=dict(window=7)),
    "decode": dict(B=3, T=1, S=64, Hq=4, Hkv=1,
                   kw=dict(causal=False, q_offset=37, kv_valid_len=38)),
    "decode_last_window": dict(B=2, T=1, S=64, Hq=4, Hkv=2,
                               kw=dict(causal=False, q_offset=63,
                                       kv_valid_len=64, window=9)),
    "q_chunk_1024": dict(B=1, T=1024, S=1024, Hq=2, Hkv=1),
    "dense_600": dict(B=1, T=600, S=600, Hq=2, Hkv=1),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_gqa_attention_matches_reference(case):
    c = dict(ATTN_CASES[case])
    kw = c.pop("kw", {})
    dtype = c.pop("dtype", "float32")
    (jq, jk, jv), (tq, tk, tv) = _qkv(np.random.default_rng(2), Dh=16,
                                      dtype=dtype, **c)
    exp = jax.jit(lambda q, k, v: ref_attn.gqa_attention(q, k, v, **kw))(
        jq, jk, jv)
    got = attn.gqa_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    # float32 out: the sums' order, and at T = 600-1,024 the odd
    # probability that rounds to the other bf16 neighbour (1.5e-5-9.3e-5);
    # bf16 out: one bf16 ulp
    tol = 2e-4 if dtype == "float32" else 8e-3
    assert rel_err(got, exp) <= tol


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv,Tq", [(4, 4, 16), (8, 2, 16), (4, 1, 5)])
def test_flash_attention_ref_matches_reference(Hq, Hkv, Tq, causal):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, Hq, Tq, 16)).astype(np.float32)
    k = rng.standard_normal((2, Hkv, 16, 16)).astype(np.float32)
    v = rng.standard_normal((2, Hkv, 16, 16)).astype(np.float32)
    exp = ref_kernels.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal)
    got = attn.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    assert rel_err(got, exp) <= 1e-6


# ------------------------------------------------------------------ MoE
def _moe_weights(rng, cfg, d):
    E, Fe = cfg.padded_experts, cfg.d_ff_expert
    w = {"router": rng.standard_normal((d, E)),
         "w_gate": rng.standard_normal((E, d, Fe)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, Fe)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, Fe, d)) / np.sqrt(Fe)}
    if cfg.num_shared:
        Fs = Fe * cfg.num_shared
        w.update(shared_gate_w=rng.standard_normal((d, Fs)) / np.sqrt(d),
                 shared_up=rng.standard_normal((d, Fs)) / np.sqrt(d),
                 shared_down=rng.standard_normal((Fs, d)) / np.sqrt(Fs))
        if cfg.shared_gate:
            w["shared_out_gate"] = rng.standard_normal((d, 1))
    return {k: v.astype(np.float32) for k, v in w.items()}


def _moe_cases(get):
    qm = get("qwen2-moe-a2.7b").smoke_config().moe
    dm = get("dbrx-132b").smoke_config().moe
    return {
        "qwen2_moe_smoke": (qm, 256),
        "dbrx_smoke": (dm, 256),
        # 16 dispatch shards of 16 tokens at half capacity: drops
        "qwen2_moe_sd16_drops": (dataclasses.replace(
            qm, dispatch_shards=16, capacity_factor=0.5), 256),
        "dbrx_sd4": (dataclasses.replace(dm, dispatch_shards=4), 256),
        # the chunked path: 2 chunks of 8,192 tokens
        "dbrx_chunked": (dataclasses.replace(dm, token_chunks=2,
                                             dispatch_shards=4), 16384),
    }


def _ref_kept(x, router, cfg):
    """The reference's kept mask [K, N] for tokens ``x`` (its router and
    slot arithmetic, restated in numpy from `moe_ffn`)."""
    logits = x.astype(np.float32) @ router
    E, Ep, K = cfg.num_experts, cfg.padded_experts, cfg.top_k
    logits[:, E:] = -1e30
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    idx = np.asarray(jax.lax.top_k(jnp.asarray(probs), K)[1])
    N = len(x)
    SD = cfg.dispatch_shards if (cfg.dispatch_shards > 1
                                 and N % cfg.dispatch_shards == 0) else 1
    capL = max(max(int(N * K / Ep * cfg.capacity_factor), 4) // SD, 4)
    kept = np.zeros((K, N), bool)
    count = np.zeros((SD, Ep), np.int64)
    for j in range(K):
        for n in range(N):
            s, e = n // (N // SD), idx[n, j]
            kept[j, n] = count[s, e] < capL
            count[s, e] += 1
    return kept


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["qwen2_moe_smoke", "dbrx_smoke",
                                  "qwen2_moe_sd16_drops", "dbrx_sd4",
                                  "dbrx_chunked"])
def test_moe_ffn_matches_reference(case, dtype):
    """`moe_apply` (`moe_ffn_chunked` -> `moe_ffn`): y and aux, and the
    dropped (token, choice) pairs exactly (float32 routing inputs)."""
    jcfg, N = _moe_cases(ref_arch)[case]
    tcfg, _ = _moe_cases(get_arch)[case]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    d = 64
    rng = np.random.default_rng(4)
    w = _moe_weights(rng, tcfg, d)
    x = rng.standard_normal((N, d)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jy, jaux = ref_moe_apply(jnp.asarray(x).astype(jd),
                                 {k: jnp.asarray(v) for k, v in w.items()},
                                 jcfg)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    ty, taux = moe.moe_apply(torch.from_numpy(x).to(td), tw, tcfg)
    assert ty.dtype == td and taux.dtype == torch.float32
    if dtype == "float32" and N <= 4096:
        _, _, idx = moe.route(torch.from_numpy(x), tw["router"], tcfg)
        kept = moe.dispatch_plan(idx, tcfg)[3].reshape(tcfg.top_k, N)
        ref = _ref_kept(x, w["router"], jcfg)
        np.testing.assert_array_equal(kept.numpy(), ref)
        share = 1.0 - ref.mean()
        if case == "qwen2_moe_sd16_drops":
            assert share > 0.3, share
    if dtype == "float32":
        assert rel_err(ty, jy) <= 1e-5
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    else:
        assert_positions(ty, jy, BF16_TOL, BF16_JUMP, BF16_SHARE, case)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-2)


def test_moe_routing_ties_go_to_the_lower_expert():
    """`route` orders equal probabilities by expert id, as
    `jax.lax.top_k` does; padded experts get exactly zero mass."""
    cfg = moe.MoEConfig(num_experts=6, top_k=3, d_ff_expert=4,
                        pad_experts_to=8)
    x = torch.ones((4, 2))
    router = torch.zeros((2, 8))
    router[:, 5] = 1.0
    probs, gates, idx = moe.route(x, router, cfg)
    assert idx.tolist() == [[5, 0, 1]] * 4
    assert (probs[:, 6:] == 0).all()
    jl = jnp.asarray(x.numpy() @ router.numpy()).at[:, 6:].set(-1e30)
    jidx = jax.lax.top_k(jax.nn.softmax(jl, axis=-1), 3)[1]
    assert np.asarray(jidx).tolist() == idx.tolist()


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch, compute_dtype):
    jc, tc, jp, tp = models(arch, compute_dtype)
    toks = tokens(tc.vocab)
    jl, jaux = ref_forward(jp, jc, jnp.asarray(toks))
    with torch.no_grad():
        tl, taux = TT.forward(tp, tc, toks)
    assert tl.dtype == getattr(torch, compute_dtype)
    jl, tl = to_np(jl), to_np(tl)
    if compute_dtype == "float32":
        assert_positions(tl, jl, F32_TOL, F32_JUMP, POS_SHARE, arch)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)
    else:
        assert_positions(tl, jl, BF16_TOL, BF16_JUMP, BF16_SHARE, arch)
        assert (tl.argmax(-1) == jl.argmax(-1)).mean() >= 0.9
        np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-2)


def _port_grads(tc, tp, batch):
    flat = {k: v.detach().requires_grad_(True)
            for k, v in C.flatten_params(tp).items()}
    loss = TT.loss_fn(C.nest_params(flat), tc, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b"])
def test_loss_and_gradients_match_reference(arch):
    """`loss_fn` and its gradient in every leaf against `jax.grad`, in
    float32 compute, through the full remat (a recompute changes no
    value)."""
    jc, tc, jp, tp = models(arch)
    batch = RefStream(tc.vocab, 32, 2, seed=1).next_batch()
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: RT.loss_fn(p, jc, b)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = _port_grads(tc, tp, batch)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jflat = C.flatten_params(jax.tree_util.tree_map(np.asarray, jg))
    assert set(jflat) == set(tg)
    for path, g in tg.items():
        assert fro_err(g, jflat[path]) <= GRAD_TOL, path
    # no remat: the same gradient
    tl2, tg2 = _port_grads(dataclasses.replace(tc, remat="none"), tp, batch)
    assert float(tl2) == float(tl)
    for path in tg:
        assert rel_err(tg2[path], tg[path]) <= 1e-6, path


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_matches_reference(arch):
    """`prefill_step`'s next token and bf16 cache [L, B, T, Hkv, Dh]."""
    jc, tc, jp, tp = models(arch)
    toks = tokens(tc.vocab, B=2, T=16, seed=5)
    jn, jcache = ref_prefill(jp, jc, jnp.asarray(toks))
    with torch.no_grad():
        tn, tcache = TT.prefill_step(tp, tc, toks)
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for k in ("k", "v"):
        assert tcache[k].dtype == torch.bfloat16
        # one bf16 ulp, or a jump where the attention before it jumped
        assert_positions(tcache[k], jcache[k], 8e-3, F32_JUMP, POS_SHARE,
                         arch + k)


def _decode_both(arch, compute_dtype, steps=3, S=32, T0=16):
    """As `tests/test_models.py` drives them: prefill T0 tokens, pad the
    cache to S, then ``steps`` decode steps on each side. Both sides take
    the reference's tokens, so a bf16 token that differs does not steer
    the rest."""
    jc, tc, jp, tp = models(arch, compute_dtype)
    toks = tokens(tc.vocab, B=2, T=T0, seed=6)
    jn, jcache = ref_prefill(jp, jc, jnp.asarray(toks))
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, S - T0), (0, 0), (0, 0)))
              for k, v in jcache.items()}
    with torch.no_grad():
        tn, tcache = TT.prefill_step(tp, tc, toks)
        tcache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, S - T0))
                  for k, v in tcache.items()}
    out = [(jn, None, tn, None)]
    for i in range(steps):
        feed = torch.from_numpy(np.array(jn))
        jn, jl, jcache = ref_decode(jp, jc, jcache, jn,
                                        jnp.int32(T0 + i))
        with torch.no_grad():
            tn, tl, tcache = TT.decode_step(tp, tc, tcache, feed, T0 + i)
        out.append((jn, jl, tn, tl))
    return out, jcache, tcache


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b"])
def test_decode_steps_match_reference(arch, compute_dtype):
    """Prefill's token, then three decode steps: tokens, logits and the
    cache (greedy tokens equal in float32 compute, at >= half of them in
    bf16)."""
    out, jcache, tcache = _decode_both(arch, compute_dtype)
    same = [np.array_equal(tn.numpy(), np.asarray(jn))
            for jn, _, tn, _ in out]
    if compute_dtype == "float32":
        assert all(same)
    else:
        assert np.mean(same) >= 0.5
    for jn, jl, tn, tl in out[1:]:
        if compute_dtype == "float32":
            assert_positions(tl, jl, F32_TOL, F32_JUMP, 0.5, arch)
        else:
            assert_positions(tl, jl, BF16_TOL, BF16_JUMP, 0.5, arch)
    for k in ("k", "v"):
        assert_positions(tcache[k], jcache[k], 8e-3, F32_JUMP, POS_SHARE,
                         arch + k)


def test_decode_at_the_last_cache_position():
    """pos = S - 1 writes the cache's last row and attends to all of it;
    the cache is written in place and returned."""
    jc, tc, jp, tp = models("codeqwen1.5-7b")
    S = 8
    cache = np.random.default_rng(7).standard_normal(
        (tc.n_layers, 2, S, tc.n_kv_heads, tc.d_head)).astype(np.float32)
    jcache = {k: jnp.asarray(cache).astype(jnp.bfloat16) for k in "kv"}
    tcache = {k: torch.from_numpy(cache).to(torch.bfloat16) for k in "kv"}
    toks = np.array([3, 77], np.int32)
    jn, jl, jcache = ref_decode(jp, jc, jcache, jnp.asarray(toks),
                                    jnp.int32(S - 1))
    with torch.no_grad():
        tn, tl, out = TT.decode_step(tp, tc, tcache, toks, S - 1)
    assert out is tcache
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert_positions(tl, jl, F32_TOL, F32_JUMP, 0.5, "logits")
    for k in "kv":
        assert_positions(tcache[k], jcache[k], 8e-3, F32_JUMP, POS_SHARE, k)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b"])
def test_decode_equals_the_no_cache_forward(arch):
    """Each decode step's logits equal the port's own forward over the
    same tokens at that position (float32 compute). The MoE config runs
    at capacity factor 8, where no token overflows (a dropped token
    makes the forward differ from the decode by design)."""
    jc, tc, jp, tp = models(arch)
    if tc.moe:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=8.0))
    P, steps = 24, 8
    toks = tokens(tc.vocab, B=1, T=P, seed=8)
    with torch.no_grad():
        nxt, cache = TT.prefill_step(tp, tc, toks)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, steps))
                 for k, v in cache.items()}
        seq, logits = [torch.from_numpy(toks)], []
        for i in range(steps):
            seq.append(nxt[:, None])
            nxt, lg, cache = TT.decode_step(tp, tc, cache, nxt, P + i)
            logits.append(lg)
        full, _ = TT.forward(tp, tc, torch.cat(seq, 1))
    assert rel_err(torch.stack(logits, 1), full[:, P:]) <= 1e-5


def test_served_copy_keeps_the_reference_routing():
    """A bfloat16 served copy (float32 router and shared output gate)
    gives the reference's numbers: its forward equals the reference's
    forward from the float32 masters (which rounds the router to bf16),
    and its decode equals the reference's decode (float32 router)."""
    arch = "qwen2-moe-a2.7b"
    jc, tc, jp, _ = models(arch, "bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    served = C.param_tree(TT.params_from_numpy(tc, tree, device="cpu",
                                               dtype=torch.bfloat16))
    for path, leaf in C.flatten_params(served).items():
        want = torch.float32 if path.endswith(("router", "shared_out_gate")) \
            else torch.bfloat16
        assert leaf.dtype == want, path
    toks = tokens(tc.vocab, B=2, T=16, seed=9)
    jl, _ = ref_forward(jp, jc, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = TT.forward(served, tc, toks)
    assert_positions(tl, jl, BF16_TOL, BF16_JUMP, BF16_SHARE, "forward")
    jn, jcache = ref_prefill(jp, jc, jnp.asarray(toks))
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0)))
              for k, v in jcache.items()}
    tcache = {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
              .to(torch.bfloat16) for k, v in jcache.items()}
    jn2, jl2, _ = ref_decode(jp, jc, jcache, jn, jnp.int32(16))
    with torch.no_grad():
        tn2, tl2, _ = TT.decode_step(served, tc, tcache,
                                     torch.from_numpy(np.array(jn)), 16)
    np.testing.assert_array_equal(tn2.numpy(), np.asarray(jn2))
    assert rel_err(tl2, jl2) <= BF16_TOL


def _port_state(jo):
    """The reference's AdamW state as the port's."""
    tree = lambda t: {k: (tree(v) if isinstance(v, dict) else
                          torch.from_numpy(np.array(v)))
                      for k, v in t.items()}
    return topt.AdamWState(torch.tensor(int(jo.step), dtype=torch.int32),
                           tree(jo.m), tree(jo.v))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b"])
def test_train_steps_match_reference(arch):
    """Four AdamW steps of `make_train_step` over `loss_fn` on
    `TokenStream` batches, each taken by the port from the reference's
    parameters and optimizer state of that step: the loss, the gradient
    norm, the learning rate and every new leaf (float32 compute)."""
    jc, tc, jp, tp = models(arch)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    jcfg, tcfg = ref_optim.OptimizerConfig(**ocfg), \
        topt.OptimizerConfig(**ocfg)
    jstep = jax.jit(ref_make_train_step(lambda p, b: RT.loss_fn(p, jc, b),
                                        jcfg))
    tstep = make_train_step(lambda p, b: TT.loss_fn(p, tc, b), tcfg)
    jo = ref_optim.init_opt_state(jcfg, jp)
    stream = RefStream(tc.vocab, 32, 2, seed=2)
    p_j = jp
    for _ in range(4):
        batch = stream.next_batch()
        p_t = C.nest_params({k: torch.from_numpy(np.array(v)) for k, v in
                             C.flatten_params(jax.tree_util.tree_map(
                                 np.asarray, p_j)).items()})
        p_t, to, tm = tstep(p_t, _port_state(jo), batch)
        p_j, jo, jm = jstep(p_j, jo, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(to.step) == int(jo.step)
        jflat = C.flatten_params(jax.tree_util.tree_map(np.asarray, p_j))
        for path, leaf in C.flatten_params(p_t).items():
            assert fro_err(leaf, jflat[path]) <= 1e-3, path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_numpy_round_trip(dtype):
    """`params_from_numpy` then `params_to_numpy` gives the tree back
    (exactly in float32; bf16-rounded in a served copy, whose router and
    shared output gate stay exact)."""
    jc, tc, jp, _ = models("qwen2-moe-a2.7b")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = TT.params_to_numpy(TT.params_from_numpy(tc, tree, device="cpu",
                                                   dtype=dtype))
    want = C.flatten_params(tree)
    got = C.flatten_params(back)
    assert set(got) == set(want)
    for path, v in want.items():
        assert got[path].dtype == np.float32
        if dtype == torch.float32 or path.endswith(("router",
                                                    "shared_out_gate")):
            np.testing.assert_array_equal(got[path], v)
        else:
            np.testing.assert_array_equal(
                got[path], np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                                      .astype(jnp.float32)))
    with pytest.raises(KeyError):
        TT.params_from_numpy(tc, {**tree, "extra": np.zeros(1)},
                             device="cpu")


def test_init_params_layer_by_layer_keeps_the_leaf_std():
    """A stacked leaf [L, ...] is drawn a layer at a time with the whole
    leaf's fan_in (L), as the reference's `trunc_normal` draws it whole;
    a served copy holds the same draws rounded to bf16."""
    cfg = dataclasses.replace(get_arch("llama3-8b").smoke_config(),
                              n_layers=4, d_model=128, d_ff=256)
    gen = torch.Generator().manual_seed(0)
    p = C.flatten_params(TT.init_params(cfg, gen))
    ref_std = float(np.std(np.asarray(RT.init_params(
        dataclasses.replace(ref_arch("llama3-8b").smoke_config(),
                            n_layers=4, d_model=128, d_ff=256),
        jax.random.key(0))["layers"]["w_up"])))
    # trunc_normal(-2, 2) has std 0.8796 of its scale; fan_in = L = 4
    for path in ("layers.w_up", "layers.wq", "layers.w_down"):
        assert float(p[path].std()) == pytest.approx(0.8796 / 2, rel=0.02)
    assert float(p["layers.w_up"].std()) == pytest.approx(ref_std, rel=0.02)
    assert float(p["embed"].std()) == pytest.approx(
        0.8796 / np.sqrt(cfg.vocab), rel=0.05)
    assert (p["layers.ln1"] == 1).all() and (p["final_norm"] == 1).all()
    served = C.flatten_params(TT.init_params(
        cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16))
    for path, v in p.items():
        assert torch.equal(served[path], v.to(torch.bfloat16)), path


# -------------------------------------------------------------- configs
REF_COUNTS = {"llama3-8b": (8_030_261_248, 8_030_261_248),
              "qwen2-moe-a2.7b": (14_315_833_344, 2_689_173_504)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_and_flops_equal_the_reference(arch):
    """`get_config()` / `smoke_config()` field for field, the parameter
    counts, `SHAPES`, and every FLOP count of every shape."""
    jm, tm = ref_arch(arch), get_arch(arch)
    assert tm.__name__ == "repro_torch.configs." + jm.__name__.split(".")[-1]
    for fn in ("get_config", "smoke_config"):
        jc, tc = getattr(jm, fn)(), getattr(tm, fn)()
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.heads_shardable == jc.heads_shardable
    assert tm.SHAPES == jm.SHAPES and lmc.LM_SHAPES == ref_lmc.LM_SHAPES
    c, jc = tm.get_config(), jm.get_config()
    if arch in REF_COUNTS:
        assert (c.param_count(), c.active_param_count()) == REF_COUNTS[arch]
    for shape, spec in lmc.LM_SHAPES.items():
        B, S = spec["batch"], spec["seq"]
        assert lmc.lm_flops_train(c, B * S) == ref_lmc.lm_flops_train(jc,
                                                                      B * S)
        assert lmc.lm_flops_prefill(c, B, S) == ref_lmc.lm_flops_prefill(
            jc, B, S)
        assert lmc.lm_flops_decode(c, B, S) == ref_lmc.lm_flops_decode(
            jc, B, S)
