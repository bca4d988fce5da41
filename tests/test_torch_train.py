"""Training in the port against the reference package, on the CPU (the
kernels' plain versions): the optimizers (`train/optim.py`), int8
gradient compression and its collective (`train/grad_compress.py`), the
CIN layer's gradient (`ops.CinLayer`: K11 for the input gradients, K12's
plain version for the weight gradient, x0 split where K11 cannot hold
it), xDeepFM's loss and gradients and its train-step trajectories
(`train/loop.py`), `CheckpointManager` both ways, and the restart runner
(`checkpoint/fault.py`). Inputs are made from seeds with numpy and
handed to both packages; the reference's xDeepFM weights come from its
own `init_params`.

Tolerances. Optimizer states and the learning rate rtol 1e-6 (float32,
the same operations in the same order; transcendental functions of two
libraries may differ in the last bit). CIN gradients and xDeepFM's
gradient leaves within 1e-5 of each leaf's max |ref| (fp32 sums in
another order; at the model's init scale the CIN's values are 1e-3 to
1e-5, so nothing but a scale of its own is meaningful), the loss rtol
1e-6; multi-step losses rtol 1e-5 (the first AdamW step moves each
weight by ~lr sign(g), so last-bit differences of tiny gradients show a
little in later losses).
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import CheckpointManager as JCkpt
from repro.configs import xdeepfm_arch as j_arch
from repro.data.recsys import CTRStream as JStream
from repro.kernels import ref as j_ref
from repro.models import xdeepfm as jx
from repro.train import grad_compress as JG
from repro.train import optim as JO
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.checkpoint.ckpt import CheckpointManager as TCkpt
from repro_torch.checkpoint.fault import FaultTolerantRunner, Heartbeat
from repro_torch.configs import xdeepfm_arch as t_arch
from repro_torch.data.recsys import CTRStream as TStream
from repro_torch.kernels import cin_fuse as t_cin
from repro_torch.kernels import ops as t_ops
from repro_torch.models import xdeepfm as tx
from repro_torch.train import grad_compress as TG
from repro_torch.train import optim as TO
from repro_torch.train.loop import (StepTimeMonitor, Trainer, make_train_step,
                                    value_and_grad)
from repro_torch.train.tree import flatten_with_paths

LEAF_REL = 1e-5


def t_tree(tree):
    """A numpy (or JAX) tree as the port's: float arrays -> tensors."""
    if isinstance(tree, dict):
        return {k: t_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def np_leaves(tree) -> dict:
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in flatten_with_paths(tree).items()}


def j_leaves(tree) -> dict:
    """A JAX state as {path: numpy} under the port's path spelling."""
    return np_leaves(jax.tree_util.tree_map(np.asarray, _jax_plain(tree)))


def _jax_plain(tree):
    if isinstance(tree, (JO.AdamWState, JO.SGDState)):
        cls = TO.AdamWState if isinstance(tree, JO.AdamWState) else \
            TO.SGDState
        return cls(*(_jax_plain(x) for x in tree))
    if isinstance(tree, dict):
        return {k: _jax_plain(v) for k, v in tree.items()}
    return tree


def assert_leaf_rel(got, exp, rel=LEAF_REL, what=""):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    scale = np.abs(exp).max()
    err = np.abs(got - exp).max()
    assert err <= rel * scale or (scale == 0 and err == 0), \
        (what, err, scale)


def narrow_vocab(pkg):
    return pkg.XDeepFMConfig("xdeepfm-narrow-vocab", big_vocab=64,
                             small_vocab=16)


CONFIGS = {"smoke": (j_arch.smoke_config, t_arch.smoke_config),
           "narrow_vocab": (lambda: narrow_vocab(jx),
                            lambda: narrow_vocab(tx))}


@pytest.fixture(scope="module")
def xdf():
    """Per config: (reference cfg, port cfg, reference params, the same
    params as the port's tree)."""
    cache = {}

    def get(name):
        if name not in cache:
            jc, tc = (f() for f in CONFIGS[name])
            params = jx.init_params(jc, jax.random.PRNGKey(0))
            tree = jax.tree_util.tree_map(np.asarray, params)
            cache[name] = (jc, tc, params, t_tree(tree))
        return cache[name]

    return get


# ------------------------------------------------------------------- optim
def test_warmup_cosine_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jc, tc = JO.OptimizerConfig(**cfg), TO.OptimizerConfig(**cfg)
    for step in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        exp = float(JO.warmup_cosine(jc, jnp.asarray(step, jnp.int32)))
        got = float(TO.warmup_cosine(tc, torch.tensor(step,
                                                      dtype=torch.int32)))
        np.testing.assert_allclose(got, exp, rtol=1e-6, err_msg=str(step))


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "g": {"w0": rng.standard_normal((4, 2, 3)).astype(np.float32),
                    "b0": np.zeros(4, np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.3).astype(np.float32),
        params) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("clip", [1e3, 0.5])
@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_apply_updates_matches_reference(name, clip):
    """Three steps on identical gradients (clipping off, then on, with
    weight decay): params, state and metrics."""
    cfg = dict(name=name, lr=1e-2, clip_norm=clip, warmup_steps=2,
               total_steps=10, weight_decay=0.1)
    jc, tc = JO.OptimizerConfig(**cfg), TO.OptimizerConfig(**cfg)
    params, grads = _opt_case(7)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = t_tree(params)
    js, ts = JO.init_opt_state(jc, jp), TO.init_opt_state(tc, tp)
    for g in grads:
        jp, js, jm = JO.apply_updates(jc, jp, jax.tree_util.tree_map(
            jnp.asarray, g), js)
        tp, ts, tm = TO.apply_updates(tc, tp, t_tree(g), ts)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6, err_msg=key)
        exp = j_leaves({"params": jp, "opt_state": js})
        got = np_leaves({"params": tp, "opt_state": ts})
        assert sorted(got) == sorted(exp)
        for k in exp:
            assert got[k].dtype == exp[k].dtype, k
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-6,
                                       atol=1e-9, err_msg=k)


# ----------------------------------------------------------- grad compress
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((37, 11)) * 10.0 ** rng.uniform(-6, 2)
         ).astype(np.float32)
    g[0, 0] = 0.0
    jq, js = JG.quantize_int8(jnp.asarray(g))
    tq, ts = TG.quantize_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    js, ts = np.float32(js), np.float32(ts.item())
    assert abs(ts - js) <= np.spacing(js), (ts, js)
    r = rng.standard_normal(g.shape).astype(np.float32) * np.abs(g).max()
    jh, jr = JG.compress_decompress(jnp.asarray(g), jnp.asarray(r))
    th, tr = TG.compress_decompress(torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jr)).max())
    np.testing.assert_allclose(TG.dequantize_int8(tq, torch.tensor(ts)),
                               np.asarray(JG.dequantize_int8(jq, js)),
                               rtol=1e-6)


def test_compressed_psum_matches_reference_collective():
    """8 shards: the reference's collective run over a vmapped axis (its
    pmax and psum have the same meaning there as under shard_map) against
    the port's over the list of shard tensors; the sum of the int8
    payloads is exact, so the results are equal."""
    x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    x[3] *= 5.0
    exp = np.asarray(jax.vmap(lambda v: JG.compressed_psum(v, "data"),
                              axis_name="data")(jnp.asarray(x)))
    got = TG.compressed_psum([torch.from_numpy(r) for r in x])
    assert len(got) == 8
    for k in range(8):
        np.testing.assert_array_equal(got[k].numpy(), exp[k])
    rel = np.abs(got[0].numpy() - x.sum(0)).max() / np.abs(x.sum(0)).max()
    assert rel < 0.02, rel


# ------------------------------------------------------------ CIN gradient
def _cin_inputs(rng, B, H, M, D, K, same=False):
    x1 = rng.standard_normal((B, H, D)).astype(np.float32)
    x0 = x1 if same else rng.standard_normal((B, M, D)).astype(np.float32)
    w = rng.standard_normal((K, H, M)).astype(np.float32)
    g = rng.standard_normal((B, K, D)).astype(np.float32)
    return x1, x0, w, g


@pytest.mark.parametrize("B,H,M,D,K", [(16, 6, 6, 4, 8), (16, 39, 39, 10, 200),
                                       (16, 200, 39, 10, 200),
                                       (5, 13, 7, 3, 11)])
def test_cin_layer_gradients_match_reference(B, H, M, D, K):
    """dx1, dx0, dw of one layer through `ops.CinLayer` against
    `jax.vjp` of the reference's `cin_layer_ref`, at the smoke widths,
    the model's layer 0 and layer 1 (M' = 200: dx0 in two K11 calls) and
    odd shapes."""
    x1, x0, w, g = _cin_inputs(np.random.default_rng(B + H), B, H, M, D, K)
    _, vjp = jax.vjp(j_ref.cin_layer_ref, jnp.asarray(x1), jnp.asarray(x0),
                     jnp.asarray(w))
    exp = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x1, x0, w)]
    out = t_ops.cin_layer(*ts)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, b in zip(("dx1", "dx0", "dw"), got, exp):
        assert a.dtype == torch.float32
        assert_leaf_rel(a.numpy(), np.asarray(b), what=name)


def test_cin_first_layer_sums_both_input_gradients():
    """Layer 0 takes the embeddings as x1 and x0: autograd adds dx1 and
    dx0 into one gradient."""
    x1, _, w, g = _cin_inputs(np.random.default_rng(3), 8, 6, 6, 4, 5)
    _, vjp = jax.vjp(lambda e, w_: j_ref.cin_layer_ref(e, e, w_),
                     jnp.asarray(x1), jnp.asarray(w))
    exp = vjp(jnp.asarray(g))
    e = torch.from_numpy(x1).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = torch.autograd.grad(t_ops.cin_layer(e, e, tw), (e, tw),
                              torch.from_numpy(g))
    for a, b in zip(got, exp):
        assert_leaf_rel(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["smoke", "narrow_vocab"])
def test_cin_network_gradients_match_reference(xdf, name):
    """The whole CIN (every layer chained, pooled over D) at the smoke
    config and at the model's full widths, B = 16: d(x0) and every
    d(w_i) through the port's autograd against `jax.grad` of the
    reference's `_cin`, under one random cotangent of the pooled
    features."""
    jc, tc, params, tp = xdf(name)
    rng = np.random.default_rng(11)
    x0 = (rng.standard_normal((16, jc.n_sparse, jc.embed_dim)) * 0.1
          ).astype(np.float32)
    cot = rng.standard_normal((16, sum(jc.cin_layers))).astype(np.float32)

    def f(x, cin):
        return jnp.sum(jx._cin(x, cin, jc) * cot)

    ex, ecin = jax.grad(f, argnums=(0, 1))(jnp.asarray(x0), params["cin"])
    tcin = {k: v.clone().requires_grad_() for k, v in tp["cin"].items()}
    tx0 = torch.from_numpy(x0).requires_grad_()
    loss = (tx.cin_features(tcin, tx0) * torch.from_numpy(cot)).sum()
    keys = sorted(k for k in tcin if k.startswith("w"))
    got = torch.autograd.grad(loss, [tx0] + [tcin[k] for k in keys])
    assert_leaf_rel(got[0].numpy(), np.asarray(ex), what="x0")
    for k, a in zip(keys, got[1:]):
        assert_leaf_rel(a.numpy(), np.asarray(ecin[k]), what=k)


def test_cin_max_m_is_k11_shared_memory_limit():
    """`CIN_MAX_M` is the widest x0 whose block fits the card's 232,448
    bytes in the wide K11 kernel's sizing (`cin_smem_words`,
    csrc/cin_fuse.cu): 3 * 2 * 32 * 208 W words + 2 * 2 * 32 * 64 A words
    + 64 * M x0 words + 3 * 64 * hs x1 words + 2 * 64 offset words, hs =
    31 // M + 2. Only wide calls split; the narrow kernel (csrc/
    cin_narrow.cu) stages no x0 and takes any M in one call."""
    def words(M):
        hs = min((32 - 1) // M + 2, 32)
        return 3 * 2 * 32 * 208 + 2 * 2 * 32 * 64 + 64 * M + 3 * 64 * hs \
            + 2 * 64
    assert 4 * words(t_cin.CIN_MAX_M) <= 232448 < 4 * words(
        t_cin.CIN_MAX_M + 1)
    assert 4 * words(39) == 204544 and 4 * words(200) == 245760
    assert t_cin.cin_m_parts(200) == [(0, 100), (100, 200)]
    assert t_cin.cin_m_parts(39) == [(0, 39)]
    assert t_cin.cin_m_parts(148) == [(0, 148)]
    assert t_cin.cin_m_parts(149) == [(0, 74), (74, 149)]
    assert t_cin.cin_m_parts(200, narrow=True) == [(0, 200)]


@pytest.mark.parametrize("max_m", [3, 5, 148])
def test_cin_split_matches_one_call(monkeypatch, max_m):
    """The x0 split of a wide call in parts of at most ``max_m`` channels
    equals one call over all of them, within fp32 reordering; the calls go
    as planned (K = 7 is made wide here by setting `CIN_NARROW_MAX_K` to
    0: narrow calls never split)."""
    x1, x0, w, _ = _cin_inputs(np.random.default_rng(max_m), 6, 9, 11, 4, 7)
    x1, x0, w = (torch.from_numpy(a) for a in (x1, x0, w))
    exp = t_cin.cin_layer_plain(x1, x0, w)
    monkeypatch.setattr(t_cin, "CIN_MAX_M", max_m)
    monkeypatch.setattr(t_cin, "CIN_NARROW_MAX_K", 0)
    widths = []
    real = t_ops._cin_forward
    monkeypatch.setattr(t_ops, "_cin_forward", lambda a, b, c: (
        widths.append(b.shape[1]), real(a, b, c))[1])
    got = t_ops.cin_layer_split(x1, x0, w)
    assert widths == [b - a for a, b in t_cin.cin_m_parts(11)]
    assert max(widths) <= max_m and sum(widths) == 11
    assert_leaf_rel(got.numpy(), exp.numpy(), rel=1e-6)


@pytest.mark.parametrize("chunk", [1 << 30, 4096])
def test_cin_weight_grad_plain_matches_einsum(monkeypatch, chunk):
    """K12's plain version against `einsum` in float64, in one chunk and
    chunked over B (the chunks added in order)."""
    monkeypatch.setattr(t_cin, "CIN_CHUNK_BYTES", chunk)
    rng = np.random.default_rng(2)
    x1, x0, _, g = _cin_inputs(rng, 13, 9, 7, 5, 6)
    exp = np.einsum("bkd,bhd,bmd->khm", g.astype(np.float64),
                    x1.astype(np.float64), x0.astype(np.float64))
    t64 = [torch.from_numpy(a.astype(np.float64)) for a in (g, x1, x0)]
    got64 = t_cin.cin_weight_grad_plain(*t64)
    assert got64.dtype == torch.float64 and got64.shape == (6, 9, 7)
    np.testing.assert_allclose(got64.numpy(), exp, rtol=1e-12, atol=1e-12)
    got = t_cin.cin_weight_grad_plain(*(torch.from_numpy(a)
                                        for a in (g, x1, x0)))
    assert got.dtype == torch.float32
    assert_leaf_rel(got.numpy(), exp, rel=1e-6)
    with pytest.raises(ValueError):
        t_cin.cin_weight_grad_plain(torch.from_numpy(g),
                                    torch.from_numpy(x1[:5]),
                                    torch.from_numpy(x0))


def test_cin_grad_splits_cover_the_contraction():
    """K12's slices: whole stages of `CIN_GRAD_STAGE_N` n, none empty,
    together the whole contraction, as the launcher checks them; at the
    model's widths on 132 SMs, 11 slices of the 12 r-tiles of H = 39 (one
    full wave) and 54 of the 61 of H = 200 (3,294 blocks, 24.95
    waves)."""
    assert t_cin.cin_grad_splits(65536, 39, 39, 10, 200, 132) == 11
    assert t_cin.cin_grad_splits(65536, 200, 39, 10, 200, 132) == 54
    assert t_cin.cin_grad_splits(1, 200, 39, 10, 200, 132) == 1
    assert t_cin.cin_grad_splits(0, 200, 39, 10, 200, 132) == 1
    for B, H, sms in [(65536, 39, 132), (2048, 200, 132), (700, 39, 7),
                      (5, 13, 1), (37, 200, 132)]:
        S = t_cin.cin_grad_splits(B, H, 39, 10, 200, sms)
        stages = max(1, -(-(B * 10) // t_cin.CIN_GRAD_STAGE_N))
        per = -(-stages // S)
        assert 1 <= S <= t_cin.CIN_GRAD_MAX_SPLITS
        assert (S - 1) * per < stages <= S * per


def test_cin_backward_makes_one_dx0_call_per_layer(monkeypatch):
    """At the model's CIN widths (200-200-200 over 39 fields) one step's
    gradient makes 9 K11 calls, 3 forward and, per layer, dx1 and one dx0
    (K' = 39: the narrow kernel, whose M' = the layer's input width, 200
    at layers 1-2, is not split), and 3 K12 calls: 5 wide and 4 narrow,
    as `chip_smoke.train_launches_per_step` counts them."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from chip_smoke import train_launches_per_step
    calls, dws = [], []
    fwd, wgrad = t_ops._cin_forward, t_ops.cin_weight_grad
    monkeypatch.setattr(t_ops, "_cin_forward", lambda a, b, c: (
        calls.append((c.shape[0], b.shape[1])), fwd(a, b, c))[1])
    monkeypatch.setattr(t_ops, "cin_weight_grad", lambda *a: (
        dws.append(a[1].shape[1]), wgrad(*a))[1])
    cfg = tx.XDeepFMConfig("xdeepfm-narrow-vocab", big_vocab=64,
                           small_vocab=16)
    assert cfg.cin_layers == (200, 200, 200) and cfg.n_sparse == 39
    params = tx.param_tree(tx.XDeepFM(cfg, device="cpu", seed=0))
    batch = TStream(cfg.field_vocabs, cfg.field_offsets, 4,
                    seed=0).next_batch()
    value_and_grad(lambda p, b: tx.loss_fn(p, cfg, b))(params, batch)
    narrow = sorted(c for c in calls if t_cin.cin_narrow(c[0],
                                                         torch.float32))
    assert len(calls) == 9 and sorted(dws) == [39, 200, 200]
    assert narrow == [(39, 39), (39, 39), (39, 200), (39, 200)]
    assert train_launches_per_step(cfg) == {
        "cin_layer": 5, "cin_layer_narrow": 4, "cin_weight_grad": 3}


@pytest.mark.parametrize("K,dtype,parts", [(65, torch.float32, 2),
                                           (64, torch.float32, 1),
                                           (8, torch.bfloat16, 2)])
def test_wide_cin_calls_past_cin_max_m_still_split(monkeypatch, K, dtype,
                                                   parts):
    """A wide call (K' > 64, or bfloat16 at any K') whose x0' has more than
    `CIN_MAX_M` = 148 channels is still cut into two K11 calls; a narrow
    one (float32, K' <= 64) of the same width is one call. Either way the
    result is one plain call's, within fp32 reordering."""
    x1, x0, w, _ = _cin_inputs(np.random.default_rng(K), 3, 5, 149, 2, K)
    x1, x0, w = (torch.from_numpy(a).to(dtype) for a in (x1, x0, w))
    widths = []
    real = t_ops._cin_forward
    monkeypatch.setattr(t_ops, "_cin_forward", lambda a, b, c: (
        widths.append(b.shape[1]), real(a, b, c))[1])
    got = t_ops.cin_layer_split(x1, x0, w)
    assert widths == ([149] if parts == 1 else [74, 75])
    assert_leaf_rel(got.numpy(), t_cin.cin_layer_plain(x1, x0, w).numpy(),
                    rel=1e-6)


# ------------------------------------------------------ loss and gradients
def _batch(jc, B, seed=3):
    return JStream(jc.field_vocabs, jc.field_offsets, B,
                   seed=seed).next_batch()


@pytest.mark.parametrize("name", ["smoke", "narrow_vocab"])
def test_loss_and_gradients_match_reference(xdf, name):
    """`value_and_grad` of the port's functional `loss_fn` against
    `jax.value_and_grad` of the reference's, on the reference's own
    `init_params`, B = 16: the loss and every gradient leaf (the
    embedding gradient through the sort-based segment sum)."""
    jc, tc, params, tp = xdf(name)
    batch = _batch(jc, 16)
    jl, jg = jax.value_and_grad(jx.loss_fn)(params, jc, batch)
    tl, tg = value_and_grad(lambda p, b: tx.loss_fn(p, tc, b))(tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    exp, got = j_leaves(jg), np_leaves(tg)
    assert sorted(got) == sorted(exp)
    for k in exp:
        assert_leaf_rel(got[k], exp[k], what=k)
    # a module's weights through `param_tree` give the same loss
    model = tx.params_from_numpy(tc, tx.params_to_numpy(tp), device="cpu")
    np.testing.assert_allclose(
        float(tx.loss_fn(tx.param_tree(model), tc, batch)), float(tl),
        rtol=1e-6)


def test_flatten_with_paths_frees_leaves_without_the_collector():
    """A tree's leaves die when the last reference to them goes, not at
    the garbage collector's next run: flattening makes no reference
    cycle (a recursive closure over its result did, and held a
    training step's gradients on the card into the next step)."""
    import gc
    import weakref
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        flat = flatten_with_paths({"a": [leaf, {"b": None}], "c": (leaf,)})
        assert list(flat) == ["a/0", "c/0"]
        del flat, leaf
        assert ref() is None
    finally:
        gc.enable()


def test_param_tree_and_params_to_numpy_round_trip():
    cfg = t_arch.smoke_config()
    model = tx.XDeepFM(cfg, device="cpu", seed=4)
    tree = tx.param_tree(model)
    assert sorted(flatten_with_paths(tree)) == sorted(
        p.replace(".", "/") for p in tx.param_defs(cfg))
    assert all(not v.requires_grad for v in flatten_with_paths(tree).values())
    assert tree["embed"].data_ptr() == model.embed.data_ptr()  # no copy
    back = tx.params_from_numpy(cfg, tx.params_to_numpy(model), device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n
        assert not b.requires_grad


VARIANTS = {
    "adamw": (dict(), dict()),
    "sgd": (dict(name="sgd"), dict()),
    "accum4": (dict(), dict(accum_steps=4)),
    "compress": (dict(), dict(compress_grads=True)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_trajectory_matches_reference(xdf, variant):
    """5 steps of `make_train_step` at the smoke config, B = 64, from the
    reference's `init_params` and the same stream: the loss of every
    step, and the last step's grad norm and learning rate."""
    ocfg, kw = VARIANTS[variant]
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, **ocfg)
    jc, tc, params, tp = xdf("smoke")
    jcfg, tcfg = JO.OptimizerConfig(**ocfg), TO.OptimizerConfig(**ocfg)
    jstep = jax.jit(j_make_train_step(lambda p, b: jx.loss_fn(p, jc, b),
                                      jcfg, **kw))
    tstep = make_train_step(lambda p, b: tx.loss_fn(p, tc, b), tcfg, **kw)
    jo, to = JO.init_opt_state(jcfg, params), TO.init_opt_state(tcfg, tp)
    stream = JStream(jc.field_vocabs, jc.field_offsets, 64, seed=5)
    jp = params
    for _ in range(5):
        batch = stream.next_batch()
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(to.step) == int(jo.step) == 5


def test_xdeepfm_learns_at_smoke_config():
    """The reference's learning check (`tests/test_models.py`): the loss
    falls over 20 steps of AdamW at the smoke config, B = 256."""
    cfg = t_arch.smoke_config()
    stream = TStream(cfg.field_vocabs, cfg.field_offsets, batch=256, seed=0)
    params = tx.param_tree(tx.XDeepFM(cfg, device="cpu", seed=0))
    ocfg = TO.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=50)
    opt = TO.init_opt_state(ocfg, params)
    step = t_arch.make_train_step_for(cfg, ocfg)
    losses = []
    for _ in range(20):
        params, opt, m = step(params, opt, stream.next_batch())
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_train_arch_helpers():
    cfg = t_arch.get_config()
    assert t_arch.TRAIN_OPT.lr == 1e-3 and t_arch.TRAIN_OPT.weight_decay == 0
    assert t_arch.train_flops(cfg, 65536) == 3 * t_arch.flops_fwd(cfg, 65536)
    jcell = j_arch._flops_fwd(j_arch.get_config(), 65536)
    assert t_arch.flops_fwd(cfg, 65536) == jcell


# -------------------------------------------------------------- checkpoint
def _states(name, seed=0):
    """The same {"params", "opt_state"} in both packages, after two
    updates (so every moment is non-zero)."""
    params, grads = _opt_case(seed)
    jc, tc = JO.OptimizerConfig(name=name), TO.OptimizerConfig(name=name)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), t_tree(params)
    js, ts = JO.init_opt_state(jc, jp), TO.init_opt_state(tc, tp)
    for g in grads[:2]:
        jp, js, _ = JO.apply_updates(jc, jp, jax.tree_util.tree_map(
            jnp.asarray, g), js)
        tp, ts, _ = TO.apply_updates(tc, tp, t_tree(g), ts)
    return {"params": jp, "opt_state": js}, {"params": tp, "opt_state": ts}


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_checkpoint_written_by_each_package_restores_in_the_other(name):
    jstate, tstate = _states(name)
    with tempfile.TemporaryDirectory() as d:
        jd, td = os.path.join(d, "j"), os.path.join(d, "t")
        JCkpt(jd).save(3, jstate, extra={"cursor": 3})
        TCkpt(td).save(3, tstate, extra={"cursor": 3})
        jz = np.load(os.path.join(jd, "step_00000003", "state.npz"))
        tz = np.load(os.path.join(td, "step_00000003", "state.npz"))
        assert sorted(jz.files) == sorted(tz.files)
        assert "opt_state/.step" in tz.files
        assert JCkpt(jd).manifest(3) == TCkpt(td).manifest(3)
        # the reference's checkpoint into the port's structure
        got, step = TCkpt(jd).restore(tstate)
        assert step == 3 and type(got["opt_state"]) is type(
            tstate["opt_state"])
        for k, v in flatten_with_paths(got).items():
            assert torch.is_tensor(v), k
            np.testing.assert_array_equal(v.numpy(), jz[k], err_msg=k)
            assert v.dtype == flatten_with_paths(tstate)[k].dtype, k
        # the port's checkpoint into the reference's structure
        back, step = JCkpt(td).restore(jstate)
        assert step == 3
        exp = j_leaves(jstate)
        for k, v in j_leaves(back).items():
            np.testing.assert_array_equal(v, tz[k], err_msg=k)
            # the two packages' own updates, apart from the files
            assert_leaf_rel(v, exp[k], rel=1e-6, what=k)


def test_checkpoint_gc_manifest_and_shape_check():
    """The reference's `test_checkpoint_roundtrip_and_gc`, in the port."""
    _, tstate = _states("adamw", seed=1)
    with tempfile.TemporaryDirectory() as d:
        cm = TCkpt(d, keep=2)
        for s in (1, 2, 3, 4):
            cm.save(s, tstate)
        assert cm.latest_step() == 4
        assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
        state, step = cm.restore(tstate)
        assert step == 4
        for k, v in flatten_with_paths(tstate).items():
            assert torch.equal(flatten_with_paths(state)[k], v), k
        man = cm.manifest(4)
        assert man["step"] == 4 and "params/g/w0" in man["leaves"]
        assert man["leaves"]["opt_state/.step"] == {"shape": [],
                                                    "dtype": "int32"}
        bad = dict(tstate, params=dict(tstate["params"],
                                       a=torch.zeros(2, 2)))
        with pytest.raises(ValueError, match="shape mismatch"):
            cm.restore(bad)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            TCkpt(d).restore(tstate)


# ------------------------------------------------------------------ runner
def _toy():
    """The reference's toy regression (`tests/test_substrate.py`)."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((6, 1)).astype(
        np.float32)), "b": torch.zeros((1,))}

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    def batch(s):
        r = np.random.default_rng(s)
        x = r.standard_normal((32, 6)).astype(np.float32)
        y = x @ np.arange(1.0, 7.0, dtype=np.float32)[:, None]
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    return params, loss_fn, batch


def test_fault_tolerant_restart_replays_batches():
    params, loss_fn, batch = _toy()
    ocfg = TO.OptimizerConfig(lr=0.02)
    opt = TO.init_opt_state(ocfg, params)
    step = make_train_step(loss_fn, ocfg)
    with tempfile.TemporaryDirectory() as d:
        runner = FaultTolerantRunner(
            step, params, opt, TCkpt(d), ckpt_every=4,
            failure_schedule={6: RuntimeError("chip down"),
                              9: RuntimeError("again")})
        log = runner.run(None, max_steps=15, batch_for_step=batch)
        events = [rec["event"] for rec in log]
        assert events.count("failure") == 2
        assert runner.step == 15 and runner.restarts == 2
        steps_run = [rec["step"] for rec in log if rec["event"] == "step"]
        assert sorted(set(steps_run)) == list(range(15))
        assert steps_run.count(4) == 2 and steps_run.count(8) == 2


def test_heartbeat_and_elastic_remesh():
    params, loss_fn, batch = _toy()
    ocfg = TO.OptimizerConfig()
    opt = TO.init_opt_state(ocfg, params)
    step = make_train_step(loss_fn, ocfg)
    hb = Heartbeat(n_workers=4, timeout_s=0.0)  # everyone instantly dead
    hb.beat(0)
    remeshed = []

    def remesh(n_alive):
        remeshed.append(n_alive)
        return step, params, opt

    with tempfile.TemporaryDirectory() as d:
        runner = FaultTolerantRunner(step, params, opt, TCkpt(d),
                                     heartbeat=hb, remesh_fn=remesh)
        runner.run(None, max_steps=2, batch_for_step=batch)
    assert remeshed and remeshed[0] < 4
    hb = Heartbeat(n_workers=3, timeout_s=5.0)
    for w in range(3):
        hb.beat(w, t=100.0)
    assert hb.dead_workers(now=104.0) == []
    hb.beat(1, t=103.0)
    assert hb.dead_workers(now=106.0) == [0, 2]


def test_restart_budget_is_enforced():
    params, loss_fn, batch = _toy()
    ocfg = TO.OptimizerConfig()
    with tempfile.TemporaryDirectory() as d:
        runner = FaultTolerantRunner(
            make_train_step(loss_fn, ocfg), params,
            TO.init_opt_state(ocfg, params), TCkpt(d), max_restarts=1,
            failure_schedule={1: RuntimeError("a"), 2: RuntimeError("b")},
            ckpt_every=1)
        with pytest.raises(RuntimeError, match="restart budget"):
            runner.run(None, max_steps=4, batch_for_step=batch)


def test_straggler_monitor():
    m = StepTimeMonitor(alpha=0.3, z=2.0)
    flags = [m.observe(0.1) for _ in range(10)]
    assert not any(flags)
    assert m.observe(10.0) is True
    assert m.stragglers == 1


def test_restarted_xdeepfm_run_equals_uninterrupted_bit_for_bit():
    """The smoke config: a `Trainer` over 8 steps, and a
    `FaultTolerantRunner` over the same steps with a failure injected at
    step 5 (restored from the step-4 checkpoint, steps 4 and 5 replayed
    from the stream's cursor): every final parameter and moment is
    bit-identical."""
    cfg = t_arch.smoke_config()
    params = tx.param_tree(tx.XDeepFM(cfg, device="cpu", seed=0))
    opt = TO.init_opt_state(t_arch.TRAIN_OPT, params)
    step = t_arch.make_train_step_for(cfg)

    def batch_for_step(s):
        st = TStream(cfg.field_vocabs, cfg.field_offsets, 64, seed=0)
        st.set_cursor(s)
        return st.next_batch()

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(step, params, opt,
                     checkpoint_manager=TCkpt(os.path.join(d, "a")),
                     ckpt_every=4)
        hist = tr.run((batch_for_step(s) for s in range(8)))
        assert len(hist) == 8 and tr.step == 8
        assert sorted(os.listdir(os.path.join(d, "a"))) == [
            "step_00000004", "step_00000008"]
        runner = FaultTolerantRunner(
            step, params, opt, TCkpt(os.path.join(d, "b")), ckpt_every=4,
            failure_schedule={5: RuntimeError("injected")})
        log = runner.run(None, max_steps=8, batch_for_step=batch_for_step)
    assert runner.restarts == 1 and runner.step == 8
    losses = [rec["loss"] for rec in log if rec["event"] == "step"]
    assert losses[:5] == [h["loss"] for h in hist[:5]]
    assert losses[-4:] == [h["loss"] for h in hist[-4:]]
    a = flatten_with_paths({"p": tr.params, "o": tr.opt_state})
    b = flatten_with_paths({"p": runner.params, "o": runner.opt_state})
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --------------------------------------------- K12's launcher, serving path
def test_cin_weight_grad_launcher_refuses_what_it_cannot_take():
    """K12's launcher raises on CPU tensors, other dtypes and disagreeing
    shapes, before any build or launch (the card runs it, the CPU its
    plain version through `ops.cin_weight_grad`)."""
    g, x1, x0 = torch.zeros((4, 6, 2)), torch.zeros((4, 3, 2)), \
        torch.zeros((4, 5, 2))
    with pytest.raises(ValueError, match="CUDA"):
        t_cin.cin_weight_grad_cuda(g, x1, x0)
    with pytest.raises(ValueError, match="disagree"):
        t_cin.cin_weight_grad_cuda(g, x1[:3], x0)
    with pytest.raises(ValueError, match="expected g"):
        t_cin.cin_weight_grad_cuda(g[0], x1, x0)
    got = t_ops.cin_weight_grad(g, x1, x0)
    assert got.shape == (6, 3, 5) and not bool(got.any())


def test_cin_layer_goes_through_its_gradient_only_when_asked():
    """Serving (no grad, or no input that requires one) runs the forward
    alone; training records `CinLayer` for the backward."""
    x1, x0, w, _ = _cin_inputs(np.random.default_rng(0), 4, 3, 5, 2, 6)
    x1, x0 = torch.from_numpy(x1), torch.from_numpy(x0)
    w = torch.from_numpy(w).requires_grad_()
    assert t_ops.cin_layer(x1, x0, w.detach()).grad_fn is None
    with torch.no_grad():
        assert t_ops.cin_layer(x1, x0, w).grad_fn is None
    with torch.inference_mode():
        assert t_ops.cin_layer(x1, x0, w).grad_fn is None
    assert "CinLayer" in type(t_ops.cin_layer(x1, x0, w).grad_fn).__name__
