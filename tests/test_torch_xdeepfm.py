"""The xDeepFM serving path of the port against the reference package:
`CTRStream`, `embedding_bag`, the CIN layer's plain version (K11's, the
one the CPU runs) against the Pallas kernel in interpret mode and the jnp
oracle, and the model (`cin_feat`, logits, `loss_fn`,
`retrieval_scores`) against `repro.models.xdeepfm` with the reference's
own parameters carried across by `params_from_numpy`. Sizes: the smoke
config, and the full CIN and MLP widths (39 fields x 10, CIN
200-200-200, MLP 400-400) with a cut vocabulary at B = 8.

Tolerances. Unit-normal CIN inputs take the reference test's own
(`tests/test_kernels.py`: rtol 1e-4, atol 1e-5*H*sqrt(M), for fp32 sums
of H*M terms in another order; bf16 inputs rtol 5e-2, atol 0.5). At the
model's init scale the CIN activations are tiny (max |out| ~1e-3 to 1e-5
by layer), where that atol would pass an all-zero output, so every
model-scale CIN comparison is relative to the layer's own max |ref|:
1e-4, against a typical fp32 reordering error of sqrt(H*M)*2^-24 ~ 5e-6.
Logits, whose CIN share is ~1e-4, are checked beside `cin_feat`, never
instead of it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import xdeepfm_arch as j_arch
from repro.data.recsys import CTRStream as JStream
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import common as j_common
from repro.models import xdeepfm as jx
from repro_torch.configs import get_arch
from repro_torch.configs import xdeepfm_arch as t_arch
from repro_torch.data.recsys import CTRStream as TStream
from repro_torch.kernels import _cuda
from repro_torch.kernels import cin_fuse as t_cin
from repro_torch.kernels import ops as t_ops
from repro_torch.models import xdeepfm as tx
from repro_torch.models.common import trunc_normal

CIN_REL = 1e-4      # model-scale CIN values, relative to the layer's max
LOGIT_REL = 1e-5    # logits and scores, relative to their max |ref|


def narrow_vocab():
    return jx.XDeepFMConfig("xdeepfm-narrow-vocab", big_vocab=64,
                            small_vocab=16)


CONFIGS = {"smoke": (j_arch.smoke_config, t_arch.smoke_config, 16),
           "narrow_vocab": (narrow_vocab, lambda: tx.XDeepFMConfig(
               "xdeepfm-narrow-vocab", big_vocab=64, small_vocab=16), 8)}


def assert_rel(got, exp, rel, what=""):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    scale = np.abs(exp).max()
    assert scale > 0, what
    err = np.abs(got - exp).max() / scale
    assert err <= rel, (what, err, rel)


@pytest.fixture(scope="module")
def world():
    """Per config: the reference's params and one stream batch, and the
    port's model loaded from those params."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg_fn, tcfg_fn, B = CONFIGS[name]
            jcfg, tcfg = jcfg_fn(), tcfg_fn()
            params = jx.init_params(jcfg, jax.random.PRNGKey(0))
            tree = jax.tree_util.tree_map(np.asarray, params)
            model = tx.params_from_numpy(tcfg, tree, device="cpu")
            batch = JStream(jcfg.field_vocabs, jcfg.field_offsets, B,
                            seed=3).next_batch()
            cache[name] = (jcfg, params, model, batch)
        return cache[name]

    return get


# ------------------------------------------------------------------ stream
@pytest.mark.parametrize("name", ["smoke", "full"])
def test_ctr_stream_identical(name):
    cfg = j_arch.smoke_config() if name == "smoke" else j_arch.get_config()
    for seed in (0, 7):
        a = JStream(cfg.field_vocabs, cfg.field_offsets, 64, seed=seed)
        b = TStream(cfg.field_vocabs, cfg.field_offsets, 64, seed=seed)
        a.set_cursor(5)
        b.set_cursor(5)
        for _ in range(3):
            x, y = a.next_batch(), b.next_batch()
            for key in ("ids", "labels"):
                assert x[key].dtype == y[key].dtype
                np.testing.assert_array_equal(x[key], y[key])


# ----------------------------------------------------------- embedding bag
def _bag_case(case):
    if case == "reference":       # tests/test_models.py's own case
        rng = np.random.default_rng(1)
        table = rng.standard_normal((30, 6)).astype(np.float32)
        return (table, np.array([3, 4, 5, 9, 9], np.int32),
                np.array([0, 0, 1, 1, 1], np.int32), 2, None)
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    bags = rng.choice([0, 1, 2, 4, 5, 6], 40).astype(np.int32)  # 3 empty
    return table, ids, bags, 7, rng.random(40).astype(np.float32)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case", ["reference", "random"])
def test_embedding_bag_matches_reference(case, mode):
    """fp32 sums of a few rows in another order: rtol 1e-6."""
    table, ids, bags, n, wts = _bag_case(case)
    exp = jx.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                           jnp.asarray(bags), n, mode=mode,
                           weights=None if wts is None else jnp.asarray(wts))
    got = tx.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(bags), n, mode=mode,
                           weights=None if wts is None
                           else torch.from_numpy(wts))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                               atol=1e-6)
    if case == "random":
        assert (got[3] == 0).all()


# -------------------------------------------------------------- CIN layer
@pytest.mark.parametrize("B,H,M,D,K", [(8, 16, 8, 4, 8), (20, 13, 7, 6, 11),
                                       (4, 200, 39, 10, 200)])
def test_cin_plain_matches_reference(B, H, M, D, K):
    """`ops.cin_layer` on CPU tensors (the plain version) against the
    Pallas kernel (interpret mode) and `cin_layer_ref`, at the reference
    test's shapes, unit-normal inputs and its tolerance."""
    rng = np.random.default_rng(B)
    x1 = rng.standard_normal((B, H, D)).astype(np.float32)
    x0 = rng.standard_normal((B, M, D)).astype(np.float32)
    w = rng.standard_normal((K, H, M)).astype(np.float32)
    _cuda.reset_launch_counts()
    got = t_ops.cin_layer(*(torch.from_numpy(a) for a in (x1, x0, w)))
    assert got.dtype == torch.float32 and got.shape == (B, K, D)
    assert sum(_cuda.LAUNCHES.values()) == 0
    j = [jnp.asarray(a) for a in (x1, x0, w)]
    tol = dict(rtol=1e-4, atol=1e-5 * H * M ** 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ops.cin_layer(*j)),
                               **tol)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_ref.cin_layer_ref(*j)), **tol)


def test_cin_plain_bf16_matches_reference():
    """bf16 inputs, fp32 out, at `test_cin_kernel_bf16`'s shapes and
    tolerance (the reference kernel forms z in bf16, the port in fp32)."""
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((8, 16, 8)).astype(np.float32)
    x0 = rng.standard_normal((8, 8, 8)).astype(np.float32)
    w = rng.standard_normal((16, 16, 8)).astype(np.float32)
    got = t_ops.cin_layer(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in (x1, x0, w)))
    assert got.dtype == torch.float32
    exp_k = j_ops.cin_layer(*(jnp.asarray(a, jnp.bfloat16)
                              for a in (x1, x0, w)))
    exp_r = j_ref.cin_layer_ref(*(jnp.asarray(a) for a in (x1, x0, w)))
    for exp in (exp_k, exp_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=5e-2,
                                   atol=0.5)


def test_cin_plain_chunks_over_batch(monkeypatch):
    """Chunked over B (a ragged last chunk) as one chunk: the same rows
    through the same product, in float64 within 1e-12 of the whole.
    (In float32 the BLAS picks its blocking by the row count, so chunks
    of 3 rows and one of 20 round apart by up to ~1e-5 relative.)"""
    rng = np.random.default_rng(2)
    x1, x0, w = (torch.from_numpy(rng.standard_normal(s))
                 for s in ((20, 13, 6), (20, 7, 6), (11, 13, 7)))
    whole = t_cin.cin_layer_plain(x1, x0, w)
    assert whole.dtype == torch.float64
    monkeypatch.setattr(t_cin, "CIN_CHUNK_BYTES", 3 * 13 * 7 * 6 * 8)
    assert t_cin.cin_chunk_rows(13, 7, 6, 8) == 3
    np.testing.assert_allclose(t_cin.cin_layer_plain(x1, x0, w).numpy(),
                               whole.numpy(), rtol=1e-12,
                               atol=1e-12 * float(whole.abs().max()))


def test_cin_plain_float64_is_exact():
    """float64 inputs stay float64 (the smoke run's CPU anchor): equal to
    numpy's float64 einsum to 1e-12."""
    rng = np.random.default_rng(3)
    x1, x0, w = (rng.standard_normal(s) for s in ((5, 9, 4), (5, 6, 4),
                                                  (7, 9, 6)))
    got = t_cin.cin_layer_plain(*(torch.from_numpy(a) for a in (x1, x0, w)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.einsum(
        "bhd,bmd,khm->bkd", x1, x0, w), rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("name", ["smoke", "narrow_vocab"])
def test_forward_matches_reference(world, name):
    """`cin_feat` per layer (relative to the layer's max) and the logits
    against the reference's `_cin` and `forward`; one K11-equivalent
    plain layer per CIN layer."""
    cfg, params, model, batch = world(name)
    ids = jnp.asarray(batch["ids"])
    emb = jnp.take(params["embed"], ids.reshape(-1), axis=0).reshape(
        ids.shape[0], cfg.n_sparse, cfg.embed_dim)
    exp_cin = np.asarray(jx._cin(emb, params["cin"], cfg))
    exp_logits = np.asarray(jx.forward(params, cfg, batch))
    logits, cin_feat = model(torch.from_numpy(batch["ids"]), return_cin=True)
    a = 0
    for i, k in enumerate(cfg.cin_layers):
        assert_rel(cin_feat[:, a:a + k].numpy(), exp_cin[:, a:a + k],
                   CIN_REL, f"cin layer {i}")
        a += k
    assert_rel(logits.numpy(), exp_logits, LOGIT_REL, "logits")


@pytest.mark.parametrize("name", ["smoke", "narrow_vocab"])
def test_loss_matches_reference(world, name):
    cfg, params, model, batch = world(name)
    exp = float(jx.loss_fn(params, cfg, batch))
    got = float(tx.loss_fn(tx.param_tree(model), model.cfg,
                           {"ids": torch.from_numpy(batch["ids"]),
                            "labels": batch["labels"]}))
    assert abs(got - exp) <= 1e-6 * abs(exp), (got, exp)


@pytest.mark.parametrize("name", ["smoke", "narrow_vocab"])
def test_retrieval_matches_reference(world, name):
    cfg, params, model, batch = world(name)
    cand = np.random.default_rng(0).standard_normal(
        (1000, cfg.embed_dim)).astype(np.float32)
    qids = batch["ids"][:1]
    scores, (tv, ti) = jx.retrieval_scores(params, cfg, jnp.asarray(qids),
                                           jnp.asarray(cand))
    s, (v, i) = tx.retrieval_scores(model, torch.from_numpy(qids),
                                    torch.from_numpy(cand))
    assert_rel(s.numpy(), np.asarray(scores), LOGIT_REL, "scores")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ti))
    assert_rel(v.numpy(), np.asarray(tv), LOGIT_REL, "top values")


def test_forward_wants_int32_ids_of_every_field(world):
    cfg, _, model, batch = world("smoke")
    with pytest.raises(TypeError, match="int32"):
        model(torch.from_numpy(batch["ids"].astype(np.int64)))
    with pytest.raises(ValueError, match=r"\[B, 6\]"):
        model(torch.from_numpy(batch["ids"][:, :5].copy()))
    np.testing.assert_array_equal(model(batch["ids"]).numpy(),
                                  model(torch.from_numpy(
                                      batch["ids"])).numpy())


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_params_from_numpy_refuses_a_wrong_tree(fault):
    cfg = j_arch.smoke_config()
    tree = jax.tree_util.tree_map(np.asarray, jx.init_params(
        cfg, jax.random.PRNGKey(1)))
    if fault == "missing":
        del tree["mlp"]["b0"]
    elif fault == "extra":
        tree["cin"]["w9"] = np.zeros((8, 8, 6), np.float32)
    else:
        tree["cin"]["w1"] = np.zeros((8, 6, 6), np.float32)
    err = KeyError if fault != "shape" else ValueError
    with pytest.raises(err):
        tx.params_from_numpy(t_arch.smoke_config(), tree, device="cpu")


def test_init_follows_reference_rules():
    """Names and shapes equal the reference's `param_defs`; biases zero,
    ``embed`` 0.01 * normal, the rest `trunc_normal` (|x| < 2 / sqrt
    (shape[0])); a seed gives one model."""
    cfg = narrow_vocab()
    model = tx.XDeepFM(CONFIGS["narrow_vocab"][1](), device="cpu", seed=0)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {p: s for p, (s, _) in jx.param_defs(cfg).items()}
    for n, p in model.named_parameters():
        assert not p.requires_grad
        if n.endswith("bias") or ".b" in n:
            assert (p == 0).all(), n
        elif n == "embed":
            assert abs(float(p.std()) - 0.01) < 0.001
        else:
            assert float(p.abs().max()) < 2.0 / np.sqrt(p.shape[0]), n
    again = tx.XDeepFM(CONFIGS["narrow_vocab"][1](), device="cpu", seed=0)
    other = tx.XDeepFM(CONFIGS["narrow_vocab"][1](), device="cpu", seed=1)
    assert torch.equal(model.cin.w1, again.cin.w1)
    assert not torch.equal(model.cin.w1, other.cin.w1)


def test_trunc_normal_matches_reference_distribution():
    """Same distribution as the reference's (not the same numbers: the
    generators differ): fan_in = shape[0], +-2 std, std 0.8796 / sqrt
    (fan_in), matching deciles to 0.01 std."""
    shape = (200, 200, 39)
    std = 1 / np.sqrt(200)
    gen = torch.Generator()
    gen.manual_seed(0)
    t = trunc_normal(shape, gen).numpy().ravel() / std
    j = np.asarray(j_common.trunc_normal(jax.random.PRNGKey(0),
                                         shape)).ravel() / std
    for x in (t, j):
        assert np.abs(x).max() < 2.0
        assert abs(x.mean()) < 0.01 and abs(x.std() - 0.8796) < 0.005
    q = np.linspace(0.1, 0.9, 9)
    np.testing.assert_allclose(np.quantile(t, q), np.quantile(j, q),
                               atol=0.01)


def test_configs_match_reference():
    mod = get_arch("xdeepfm")
    assert mod is t_arch
    assert mod.SHAPES == j_arch.SHAPES
    assert mod._SHAPE_SPECS == j_arch._SHAPE_SPECS
    for t, j in ((mod.get_config(), j_arch.get_config()),
                 (mod.smoke_config(), j_arch.smoke_config())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.field_vocabs == j.field_vocabs
        assert t.total_rows == j.total_rows
        np.testing.assert_array_equal(t.field_offsets, j.field_offsets)
    assert mod.get_config().total_rows == 8_031_232
    # an unknown arch raises (the LM archs, once unknown here, resolve
    # since the LM family was ported)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_flops_match_reference():
    for cfg_t, cfg_j in ((t_arch.get_config(), j_arch.get_config()),
                         (t_arch.smoke_config(), j_arch.smoke_config())):
        for spec in t_arch._SHAPE_SPECS.values():
            B = spec["batch"]
            assert t_arch.flops_fwd(cfg_t, B) == j_arch._flops_fwd(cfg_j, B)
    # 68.5 MFLOP of CIN per sample at full width, 99% of the forward
    cin = sum(t_arch.cin_flops(t_arch.get_config(), 1))
    assert cin == 2 * 10 * 39 * (200 * 39 + 2 * 200 * 200)
    assert cin / t_arch.flops_fwd(t_arch.get_config(), 1) > 0.99
