"""CPU parity of the GNN family of the port (`repro_torch.models.gnn`,
`models.common`'s segment backend, `data.graphs`, `configs.gnn_common`)
against the reference package: the same numpy inputs through both, the
reference's parameters carried across with `params_from_numpy`.

Tolerances: fp32 outputs within 1e-5 of max |ref|, gradients within 1e-4
of each leaf's max |ref|; bf16 forwards within 5e-2 of max |ref|. The
sampler, `pad_block`, the synthetic data and the distance encodings are
held exactly."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_arch
from repro.configs import gnn_common as ref_common
from repro.core import build_wc_index as ref_build
from repro.core.generators import erdos_renyi as ref_erdos
from repro.core.generators import scale_free as ref_scale_free
from repro.data import graphs as ref_graphs
from repro.models import common as ref_mc
from repro.models import gnn as ref_gnn
from repro.train import optim as ref_optim
from repro.train.loop import make_train_step as ref_make_train_step

from repro_torch.configs import get_arch
from repro_torch.configs import gnn_common as tcommon
from repro_torch.core import build_wc_index
from repro_torch.core.generators import erdos_renyi, scale_free
from repro_torch.data import graphs as tgraphs
from repro_torch.models import common as C
from repro_torch.models import gnn as tg
from repro_torch.train import optim as topt
from repro_torch.train.loop import make_train_step

GNN_ARCHS = ["gin-tu", "pna", "gatedgcn"]
OUT_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 5e-2


def rel_err(got, exp) -> float:
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


def to_np(t):
    return t.detach().cpu().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def ref_params(mod, cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  mod.init_params(cfg, jax.random.key(seed)))


def torch_params(model):
    return C.param_tree(model)


def torch_value_and_grad(loss_fn, params, batch):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flat(params).items()}
    loss = loss_fn(C.nest_params(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {
        k: (torch.zeros_like(leaves[k]) if g is None else g)
        for k, g in zip(leaves, grads)}


# ------------------------------------------------------------ segment ops
SEG_CASES = {
    # ids (unsorted), num_segments: segment 3 and 5 empty, ties in values
    "unsorted": (np.array([4, 0, 2, 0, 4, 1, 2, 0, 6, 1], np.int32), 7),
    "ties_and_empty": (np.array([0, 0, 0, 2, 2, 4, 4, 4, 4, 0], np.int32), 6),
    "one_long": (np.array([1] * 150 + [0, 3] * 5, np.int32), 5),
}


def _seg_values(n, ties: bool, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    if ties:   # repeated values inside segments
        x = np.round(x * 2) / 2
    return x


def _jax_op(op):
    return {"sum": jax.ops.segment_sum, "max": jax.ops.segment_max,
            "min": jax.ops.segment_min}[op]


def _torch_op(op):
    return {"sum": C.segment_sum, "max": C.segment_max,
            "min": C.segment_min}[op]


@pytest.mark.parametrize("case", list(SEG_CASES))
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_segment_ops_values_and_two_derivatives(case, op):
    ids, S = SEG_CASES[case]
    x = _seg_values(len(ids), ties=(case != "unsorted"))
    rng = np.random.default_rng(1)
    c = rng.standard_normal((S, 3)).astype(np.float32)
    v = rng.standard_normal(x.shape).astype(np.float32)
    jop, top = _jax_op(op), _torch_op(op)

    def jf(x):
        y = jop(x, jnp.asarray(ids), num_segments=S)
        y = jnp.where(jnp.isfinite(y), y, 0.0)
        return (c * y * y).sum()

    def jg(x):
        return (jax.grad(jf)(x) * v).sum()

    ref_y = np.asarray(jop(jnp.asarray(x), jnp.asarray(ids), num_segments=S))
    ref_g = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    ref_h = np.asarray(jax.grad(jg)(jnp.asarray(x)))

    plan = C.SegmentPlan(torch.from_numpy(ids), S)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = top(xt, plan)
    np.testing.assert_array_equal(np.isfinite(to_np(y)), np.isfinite(ref_y))
    fin = np.isfinite(ref_y)
    assert rel_err(to_np(y)[fin], ref_y[fin]) <= OUT_TOL
    if op != "sum":   # empty segments at -inf / +inf, as JAX leaves them
        assert (to_np(y)[~fin] == ref_y[~fin]).all()
    yy = torch.where(torch.isfinite(y), y, 0.0)
    f = (torch.from_numpy(c) * yy * yy).sum()
    (g,) = torch.autograd.grad(f, xt, create_graph=True)
    assert rel_err(to_np(g), ref_g) <= GRAD_TOL
    (h,) = torch.autograd.grad((g * torch.from_numpy(v)).sum(), xt)
    assert rel_err(to_np(h), ref_h) <= GRAD_TOL


def test_segment_max_splits_ties_evenly():
    xt = torch.tensor([1.0, 1.0, 0.0], requires_grad=True)
    C.segment_max(xt, torch.tensor([0, 0, 0]), 1).sum().backward()
    ref = jax.grad(lambda x: jax.ops.segment_max(
        x, jnp.zeros(3, jnp.int32), num_segments=1).sum())(
        jnp.array([1.0, 1.0, 0.0]))
    np.testing.assert_array_equal(to_np(xt.grad), np.asarray(ref))
    np.testing.assert_array_equal(to_np(xt.grad), [0.5, 0.5, 0.0])


def test_segment_gather_and_sum_are_each_others_transpose():
    """The gather's gradient is the segment sum over the same plan and
    back, to the second derivative, against ``x[ids]`` in JAX."""
    rng = np.random.default_rng(3)
    ids = np.array([3, 1, 1, 0, 3, 3, 2], np.int32)
    x = rng.standard_normal((5, 2)).astype(np.float32)
    w = rng.standard_normal((7, 2)).astype(np.float32)

    def jf(x):
        y = x[jnp.asarray(ids)]
        return (w * jnp.sin(y) * y).sum()

    ref_g = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    ref_h = np.asarray(jax.grad(lambda x: jax.grad(jf)(x).sum())(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = C.segment_gather(xt, torch.from_numpy(ids))
    f = (torch.from_numpy(w) * torch.sin(y) * y).sum()
    (g,) = torch.autograd.grad(f, xt, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), xt)
    assert rel_err(to_np(g), ref_g) <= GRAD_TOL
    assert rel_err(to_np(h), ref_h) <= GRAD_TOL


def test_segment_sum_drops_out_of_range_ids():
    ids = np.array([0, 3, 1, 7, 3], np.int32)
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids),
                                         num_segments=4))
    got = C.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), 4)
    np.testing.assert_array_equal(to_np(got), ref)


@pytest.mark.parametrize("ids", [[2, 0, 2, 1], [2, -1, 0, 5]])
def test_segment_gather_zeros_out_of_range_ids_and_sorts_lazily(ids):
    """A gather is one `index_select` (the plan sorts nothing until a
    reduction asks); an id outside the table gives a zero row and no
    gradient."""
    ids = torch.tensor(ids)
    plan = C.SegmentPlan(ids, 3)
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    y = C.segment_gather(x, plan)
    assert "order" not in vars(plan) and "levels" not in vars(plan)
    ok = (ids >= 0) & (ids < 3)
    assert (plan.trashed is None) == bool(ok.all())
    exp = torch.where(ok[:, None], x.detach()[ids.clamp(0, 2)], 0.0)
    assert torch.equal(y.detach(), exp)
    (g,) = torch.autograd.grad((y * torch.arange(1.0, 5.0)[:, None]).sum(),
                               x)
    ref = np.zeros((3, 2), np.float32)
    for i, j in enumerate(ids.tolist()):
        if 0 <= j < 3:
            ref[j] += i + 1
    np.testing.assert_array_equal(to_np(g), ref)


def test_segment_sum_bf16_accumulates_in_fp32():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 8, 4000).astype(np.int32)
    x = rng.standard_normal((4000, 5)).astype(np.float32)
    exact = np.zeros((8, 5))
    np.add.at(exact, ids, x.astype(np.float64))
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(ids), 8), np.float32)
    got = C.segment_sum(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(ids), 8)
    assert got.dtype == torch.bfloat16
    assert rel_err(to_np(got), ref) <= BF16_TOL
    assert rel_err(to_np(got), exact) <= 1e-2


def test_segment_runs_give_the_same_bits_every_time():
    """A long segment is summed in runs of `SEGMENT_RUN` rows, then the
    runs, level by level: the result does not depend on the call."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(np.concatenate([np.full(5000, 2),
                                           rng.integers(0, 4, 300)]))
    x = torch.from_numpy(rng.standard_normal((5300, 3)).astype(np.float32))
    plan = C.SegmentPlan(ids, 4)
    assert len(plan.levels) == 3
    a = C.segment_sum(x, plan)
    b = C.segment_sum(x, C.SegmentPlan(ids, 4))
    assert torch.equal(a, b)
    exact = np.zeros((4, 3))
    np.add.at(exact, ids.numpy(), x.numpy().astype(np.float64))
    assert rel_err(to_np(a), exact) <= 1e-6


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_loss_equals_reference(z_loss):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 9, 5)).astype(np.float32)
    labels = rng.integers(-1, 5, (2, 9)).astype(np.int32)
    ref = float(ref_mc.cross_entropy_loss(jnp.asarray(logits),
                                          jnp.asarray(labels), z_loss))
    got = float(C.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels), z_loss))
    assert abs(got - ref) <= 1e-6 * max(abs(ref), 1.0)


# ------------------------------------------------------------------ layers
def _graph_batch(n=60, avg=4.0, seed=1, d_feat=8, n_classes=3):
    g = ref_erdos(n, avg, num_levels=3, seed=seed)
    return ref_graphs.synthetic_node_task(g, d_feat, n_classes)


def _layer_params(cfg, seed=0):
    p = ref_params(ref_gnn, cfg, seed)
    rng = np.random.default_rng(seed + 10)
    # biases, eps and LayerNorm shifts are zero at init: draw them, so the
    # layers' every term is seen
    lp = {k: np.asarray(v[0] + 0.1 * rng.standard_normal(v[0].shape),
                        np.float32) for k, v in p["layers"].items()}
    return lp


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_layer_equals_reference_with_gradients(arch):
    cfg = get_arch(arch).smoke_config()
    b = _graph_batch(d_feat=cfg.d_hidden)
    N = b["feat"].shape[0]
    h = b["feat"]
    rng = np.random.default_rng(7)
    e = rng.standard_normal((len(b["edges_src"]), cfg.d_hidden)).astype(
        np.float32)
    lp = _layer_params(cfg)
    src, dst = b["edges_src"], b["edges_dst"]
    dlm = float(max(np.log1p(np.bincount(dst, minlength=N)).mean(), 1e-2))

    def jlayer(h, e, lp):
        if arch == "gin-tu":
            return (ref_gnn.gin_layer(h, lp, src, dst, N) ** 2).sum()
        if arch == "pna":
            return (ref_gnn.pna_layer(h, lp, src, dst, N, dlm) ** 2).sum()
        ho, eo = ref_gnn.gatedgcn_layer(h, e, lp, src, dst, N)
        return (ho ** 2).sum() + (eo ** 2).sum()

    ref_v, (ref_gh, ref_ge, ref_gl) = jax.jit(jax.value_and_grad(
        jlayer, argnums=(0, 1, 2)))(jnp.asarray(h), jnp.asarray(e),
                                   jax.tree_util.tree_map(jnp.asarray, lp))
    ht = torch.from_numpy(h).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True)
    lt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lp.items()}
    st, dt = torch.from_numpy(src), torch.from_numpy(dst)
    if arch == "gin-tu":
        v = (tg.gin_layer(ht, lt, st, dt, N) ** 2).sum()
    elif arch == "pna":
        v = (tg.pna_layer(ht, lt, st, dt, N, torch.tensor(dlm)) ** 2).sum()
    else:
        ho, eo = tg.gatedgcn_layer(ht, et, lt, st, dt, N)
        v = (ho ** 2).sum() + (eo ** 2).sum()
    assert abs(float(v.detach()) - float(ref_v)) <= OUT_TOL * abs(
        float(ref_v))
    leaves = [ht, et] + list(lt.values())
    grads = torch.autograd.grad(v, leaves, allow_unused=True)
    exp = [ref_gh, ref_ge] + [ref_gl[k] for k in lt]
    for name, g, r in zip(["h", "e"] + list(lt), grads, exp):
        r = np.asarray(r)
        if g is None:
            assert not np.abs(r).any(), name
            continue
        assert rel_err(to_np(g), r) <= GRAD_TOL, name


def test_segment_softmax_and_degree_equal_reference():
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 9, 40).astype(np.int32)
    ids[ids == 4] = 5                         # an empty segment
    sc = rng.standard_normal(40).astype(np.float32)
    ref = np.asarray(ref_gnn.segment_softmax(jnp.asarray(sc),
                                             jnp.asarray(ids), 9))
    got = tg.segment_softmax(torch.from_numpy(sc), torch.from_numpy(ids), 9)
    assert rel_err(to_np(got), ref) <= OUT_TOL
    np.testing.assert_array_equal(
        to_np(tg.degree(torch.from_numpy(ids), 9)),
        np.asarray(ref_gnn.degree(jnp.asarray(ids), 9)))


# ------------------------------------------------ forward, loss, gradients
def _task_batch(cfg, graph_level: bool):
    if graph_level:
        b = ref_graphs.synthetic_molecules(6, 9, 14, cfg.d_feat, seed=2)
        b["labels"] = np.random.default_rng(3).integers(
            0, cfg.n_classes, 6).astype(np.int32)
        return b, 6
    b = _graph_batch(d_feat=cfg.d_feat, n_classes=cfg.n_classes)
    b["labels"][::7] = -1                      # unlabelled nodes
    return b, None


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, graph_level: bool, dtype: str,
                   jit: bool = True):
    """(batch, n_graphs, params, logits, loss, grads) of the reference at
    smoke_config in ``dtype`` (float64 under `jax.enable_x64`), jitted
    or op by op."""
    cfg = dataclasses.replace(ref_arch(arch).smoke_config(),
                              graph_level=graph_level, compute_dtype=dtype)
    batch, ng = _task_batch(cfg, graph_level)
    p = ref_params(ref_gnn, cfg)
    wrap = jax.jit if jit else (lambda f: f)
    with jax.enable_x64(dtype == "float64"):
        cast = lambda a: jnp.asarray(a, dtype) if a.dtype.kind == "f" \
            else jnp.asarray(a)
        jp = jax.tree_util.tree_map(cast, p)
        jb = {k: cast(v) for k, v in batch.items()}
        logits = np.asarray(wrap(
            lambda q, b: ref_gnn.forward(q, cfg, b, n_graphs=ng))(jp, jb))
        loss, grads = wrap(jax.value_and_grad(
            lambda q, b: ref_gnn.loss_fn(q, cfg, b, n_graphs=ng)))(jp, jb)
        grads = flat(jax.tree_util.tree_map(np.asarray, grads))
    return batch, ng, p, logits, float(loss), grads


def _values(run) -> dict:
    return {"logits": run[3], "loss": run[4], **run[5]}


# The float32 leaves of PNA's graph-level task that miss both of the
# reference's answers by more than `GRAD_TOL`; `python
# tests/test_torch_gnn.py` prints their errors. The reference's own
# float32 gradients miss its float64 ones by as much.
PNA_FP32_NOISY = {("pna", True): {"enc_b", "enc_w", "layers.b_out",
                                  "layers.w_msg", "layers.w_out"}}


def _port_run(arch: str, graph_level: bool, dtype: str) -> dict:
    """The port's logits, loss and gradient leaves at smoke_config in
    ``dtype``, on the reference's batch and parameters."""
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              graph_level=graph_level, compute_dtype=dtype)
    run = _reference_run(arch, graph_level, dtype)
    batch, ng, p = run[:3]
    tdt = tg.DTYPES[dtype]
    params = C.nest_params({k: torch.tensor(v, dtype=tdt)
                            for k, v in flat(p).items()})
    tb = {k: (torch.tensor(v, dtype=tdt) if v.dtype.kind == "f"
              else torch.from_numpy(v)) for k, v in batch.items()}
    logits = tg.forward(params, cfg, tb, n_graphs=ng)
    assert logits.dtype == tdt and logits.shape == run[3].shape
    loss, grads = torch_value_and_grad(
        lambda q, b: tg.loss_fn(q, cfg, b, n_graphs=ng), params, tb)
    return {"logits": to_np(logits), "loss": float(loss),
            **{k: to_np(g) for k, g in grads.items()}}


def _fp32_errors(arch: str, graph_level: bool, k: str, got) -> tuple:
    """(err against the reference's float32, err against its float64,
    the reference's own float32 error: the worse of its jitted and
    op-by-op runs against its float64) of leaf ``k``."""
    r32 = _values(_reference_run(arch, graph_level, "float32"))[k]
    r64 = _values(_reference_run(arch, graph_level, "float64"))[k]
    eager = _values(_reference_run(arch, graph_level, "float32", False))[k]
    return (rel_err(got, r32), rel_err(got, r64),
            max(rel_err(r32, r64), rel_err(eager, r64)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("graph_level", [False, True])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_loss_and_gradients_equal_reference(arch, graph_level,
                                                    dtype):
    """Logits, loss and every gradient leaf against `jax.value_and_grad`,
    both packages in ``dtype``, within `OUT_TOL` / `GRAD_TOL` of the
    reference. GIN and GatedGCN are held against the reference in the
    same dtype. PNA in float32 is held against the reference's float32 or
    its float64 answer; the leaves of `PNA_FP32_NOISY` alone, where it is
    within neither, must be within twice the reference's own float32
    error of the float64 answer. Its std aggregator's ``sq/d - mean^2``
    cancels, and ``sqrt(var + 1e-5)`` and the 1e-5-floored attenuation
    amplify the rounding, so the reference's own float32 gradients miss
    its float64 ones by more than `GRAD_TOL`."""
    got = _port_run(arch, graph_level, dtype)
    ref = _values(_reference_run(arch, graph_level, dtype))
    assert set(got) == set(ref)
    noisy = PNA_FP32_NOISY.get((arch, graph_level), set())
    for k, r in ref.items():
        tol = OUT_TOL if k in ("logits", "loss") else GRAD_TOL
        err = rel_err(got[k], r)
        if dtype == "float64" or arch != "pna" or err <= tol:
            assert err <= tol, (k, err)
            continue
        _, err64, own = _fp32_errors(arch, graph_level, k, got[k])
        if err64 <= tol:
            continue
        assert k in noisy, (k, err, err64)
        assert err64 <= 2 * own, (k, err, err64, own)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_bf16_forward_on_a_padded_block_equals_reference(arch):
    """The minibatch_lg configuration (bf16, a sampled block padded with
    a sink node) at smoke depth and width."""
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              compute_dtype="bfloat16")
    rcfg = dataclasses.replace(ref_arch(arch).smoke_config(),
                               compute_dtype="bfloat16")
    g = ref_scale_free(300, 3, num_levels=3, seed=9)
    block = ref_graphs.NeighborSampler(g, seed=0).sample(
        np.arange(16, dtype=np.int32), [5, 3])
    pb = ref_graphs.pad_block(block, 512, 1024)
    rng = np.random.default_rng(10)
    batch = {"feat": rng.standard_normal((512, cfg.d_feat)).astype(
        np.float32), "edges_src": pb["edges_src"],
        "edges_dst": pb["edges_dst"]}
    p = ref_params(ref_gnn, rcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = np.asarray(jax.jit(lambda q, b: ref_gnn.forward(q, rcfg, b))(
        p, jb), np.float32)
    r32 = dataclasses.replace(rcfg, compute_dtype="float32")
    ref32 = np.asarray(jax.jit(lambda q, b: ref_gnn.forward(q, r32, b))(
        p, jb))
    got = tg.params_from_numpy(cfg, p, device="cpu")(batch)
    assert got.dtype == torch.bfloat16
    got = to_np(got)
    # the real nodes against the reference's bf16 forward; the sink node
    # (row 511: every padding edge, ~500 a layer) against its fp32 one:
    # the reference's bf16 scatter adds those edges in bf16, which puts
    # its sink row past the tolerance from its own fp32 forward; the port
    # sums in fp32
    assert rel_err(ref[-1], ref32[-1]) > BF16_TOL
    assert rel_err(got[:-1], ref[:-1]) <= BF16_TOL
    assert rel_err(got, ref32) <= BF16_TOL


@pytest.mark.parametrize("arch", ["gin-tu", "gatedgcn"])
def test_big_graph_branch_equals_the_plain_layer_loop(arch, monkeypatch):
    """Above `BIG_GRAPH` nodes a depth-4 model recomputes its block of 4
    layers in the backward: the logits and every gradient leaf equal the
    plain loop's, bit for bit."""
    cfg = tg.GNNConfig("big", get_arch(arch).smoke_config().kind,
                       n_layers=4, d_hidden=4, d_feat=3, n_classes=2,
                       d_edge=1)
    N = tg.BIG_GRAPH + 1
    rng = np.random.default_rng(11)
    batch = {"feat": rng.standard_normal((N, 3)).astype(np.float32),
             "edges_src": rng.integers(0, N, 64).astype(np.int32),
             "edges_dst": rng.integers(0, 32, 64).astype(np.int32),
             "labels": np.where(np.arange(N) < 32, rng.integers(0, 2, N),
                                -1).astype(np.int32)}
    model = tg.GNN(cfg, device="cpu", seed=0)

    def run():
        return torch_value_and_grad(lambda q, b: tg.loss_fn(q, cfg, b),
                                    torch_params(model), batch)

    calls = []
    orig = tg.checkpoint
    monkeypatch.setattr(tg, "checkpoint",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    loss_big, g_big = run()
    assert calls == [1]                     # one block of 4 layers
    monkeypatch.setattr(tg, "BIG_GRAPH", N + 1)
    loss_plain, g_plain = run()
    assert calls == [1]
    assert torch.equal(loss_big, loss_plain)
    for k in g_plain:
        assert torch.equal(g_big[k], g_plain[k]), k


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_ten_step_trajectory_equals_reference(arch):
    """The reference's `test_gnn_smoke`: 10 AdamW steps on a fixed
    graph, the loss trajectory equal to JAX's and falling."""
    cfg = get_arch(arch).smoke_config()
    rcfg = ref_arch(arch).smoke_config()
    g = ref_erdos(60, 4.0, num_levels=3, seed=1)
    batch = ref_graphs.synthetic_node_task(g, cfg.d_feat, cfg.n_classes)
    p = ref_params(ref_gnn, rcfg)
    rocfg = ref_optim.OptimizerConfig(lr=1e-2, warmup_steps=1,
                                      total_steps=30)
    jstep = jax.jit(ref_make_train_step(
        lambda p, b: ref_gnn.loss_fn(p, rcfg, b), rocfg))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jo = ref_optim.init_opt_state(rocfg, jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ocfg = topt.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=30)
    step = make_train_step(lambda q, b: tg.loss_fn(q, cfg, b), ocfg)
    tp = torch_params(tg.params_from_numpy(cfg, p, device="cpu"))
    to = topt.init_opt_state(ocfg, tp)
    ref_losses, losses = [], []
    for _ in range(10):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, m = step(tp, to, batch)
        ref_losses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


# ---------------------------------------------------------- data pipeline
def test_sampler_and_pad_block_are_byte_identical():
    g_ref = ref_scale_free(500, 3, num_levels=3, seed=12)
    g = scale_free(500, 3, num_levels=3, seed=12)
    seeds = np.arange(0, 400, 13, dtype=np.int32)
    for fanouts in ([5, 3], [4], [2, 2, 2]):
        a = ref_graphs.NeighborSampler(g_ref, seed=4).sample(seeds, fanouts)
        b = tgraphs.NeighborSampler(g, seed=4).sample(seeds, fanouts)
        assert a["num_seeds"] == b["num_seeds"]
        for k in ("nodes", "edges_src", "edges_dst"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        for n_nodes, n_edges in ((4096, 8192), (len(a["nodes"]) - 5, 40)):
            pa = ref_graphs.pad_block(a, n_nodes, n_edges)
            pb = tgraphs.pad_block(b, n_nodes, n_edges)
            for k in ("nodes", "edges_src", "edges_dst"):
                assert pa[k].dtype == pb[k].dtype
                assert np.array_equal(pa[k], pb[k]), k


def test_synthetic_data_is_byte_identical():
    g_ref = ref_erdos(70, 4.0, num_levels=3, seed=13)
    g = erdos_renyi(70, 4.0, num_levels=3, seed=13)
    for a, b in ((ref_graphs.synthetic_node_task(g_ref, 5, 4, seed=3),
                  tgraphs.synthetic_node_task(g, 5, 4, seed=3)),
                 (ref_graphs.synthetic_molecules(4, 7, 11, 6, seed=5),
                  tgraphs.synthetic_molecules(4, 7, 11, 6, seed=5))):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_distance_encoding_equals_reference_exactly():
    g_ref = ref_scale_free(100, 3, num_levels=3, seed=35)
    g = scale_free(100, 3, num_levels=3, seed=35)
    idx_ref, idx = ref_build(g_ref), build_wc_index(g)
    nodes = np.arange(100)
    lms = np.array([0, 50, 7])
    for levels, clip in (([0, 2], 32), ([0, 1, 2, 3], 3)):
        ref = ref_graphs.distance_encoding(idx_ref, nodes, lms, levels,
                                           clip=clip)
        got = tgraphs.distance_encoding(idx, nodes, lms, levels, clip=clip,
                                        device="cpu")
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_distance_encoding_flushes(monkeypatch):
    """Queries go to the engine in flushes of `ENCODING_FLUSH`."""
    g = scale_free(80, 3, num_levels=3, seed=35)
    idx = build_wc_index(g)
    from repro_torch.core.query import DeviceQueryEngine
    eng = DeviceQueryEngine(idx, device="cpu")
    sizes = []
    orig = eng.query_async
    eng.query_async = lambda s, t, w: sizes.append(len(s)) or orig(s, t, w)
    monkeypatch.setattr(tgraphs, "ENCODING_FLUSH", 100)
    got = tgraphs.distance_encoding(idx, np.arange(80), np.array([1, 2]),
                                    [0, 1], engine=eng)
    assert sizes == [100, 100, 100, 20]
    ref = tgraphs.distance_encoding(idx, np.arange(80), np.array([1, 2]),
                                    [0, 1], device="cpu")
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_shapes_configs_and_flops_equal_the_reference_cells(arch):
    for shape in tcommon.GNN_SHAPES:
        meta = ref_common.make_gnn_cell(ref_arch(arch).get_config(),
                                        shape).meta
        N, E = tcommon.padded_sizes(shape)
        assert (N, E) == (meta["n_nodes"], meta["n_edges"])
        cfg = tcommon.shape_config(get_arch(arch).get_config(), shape)
        assert tcommon.model_flops(cfg, E, N) == meta["model_flops"]
        assert sum(int(np.prod(s)) for s in tg.param_defs(cfg).values()) \
            == meta["params"]
        spec = tcommon.GNN_SHAPES[shape]
        assert cfg.compute_dtype == ("bfloat16" if spec["shard_nodes"]
                                     else "float32")


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule",
                                   "minibatch_lg"])
def test_cell_batches_have_the_padded_sizes(shape):
    g = scale_free(3000, 4, num_levels=3, seed=0)
    b = tcommon.cell_batch(shape, seed=1, graph=g)
    N, E = tcommon.padded_sizes(shape)
    spec = tcommon.GNN_SHAPES[shape]
    assert b["feat"].shape == (N, spec["d_feat"])
    assert b["edges_src"].shape == b["edges_dst"].shape == (E,)
    assert b["edges_src"].max() < N and b["edges_dst"].max() < N
    if E > 2 * spec["n_edges_raw"]:           # padding edges at the sink
        assert (b["edges_src"][-1], b["edges_dst"][-1]) == (N - 1, N - 1)
    if spec["graph_level"]:
        assert b["labels"].shape == (spec["n_graphs"],)
        assert b["graph_id"][-1] == spec["n_graphs"]        # dropped
    else:
        assert b["labels"].shape == (N,) and b["labels"][-1] == -1


def test_train_step_for_a_shape_trains():
    cfg = tcommon.shape_config(get_arch("gin-tu").smoke_config(),
                               "molecule")
    b = tcommon.cell_batch("molecule", seed=2)
    model = tg.GNN(cfg, device="cpu", seed=0)
    step = tcommon.make_train_step_for(cfg, "molecule")
    p = torch_params(model)
    o = topt.init_opt_state(tcommon.TRAIN_OPT, p)
    losses = []
    for _ in range(3):
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    a1 = tg.forward(p, cfg, b, n_graphs=128)
    assert a1.shape == (128, 2)


def test_params_round_trip_and_registry():
    for arch in GNN_ARCHS + ["nequip"]:
        assert get_arch(arch).SHAPES == list(tcommon.GNN_SHAPES)
    cfg = get_arch("gatedgcn").smoke_config()
    model = tg.GNN(cfg, device="cpu", seed=3)
    tree = tg.params_to_numpy(model)
    back = tg.params_to_numpy(tg.params_from_numpy(cfg, tree, device="cpu"))
    for k, v in flat(tree).items():
        np.testing.assert_array_equal(flat(back)[k], v)
    lay = tree["layers"]
    assert (lay["ln_h_g"] == 1).all() and (lay["ln_e_b"] == 0).all()
    assert (tree["enc_b"] == 0).all() and np.abs(lay["A"]).max() > 0
    bad = dict(tree, extra=np.zeros(1, np.float32))
    with pytest.raises(KeyError):
        tg.params_from_numpy(cfg, bad, device="cpu")


if __name__ == "__main__":
    # The float32 leaves that miss both reference answers by more than
    # their tolerance, with the errors the fallback above holds.
    for arch in GNN_ARCHS:
        for graph_level in (False, True):
            got = _port_run(arch, graph_level, "float32")
            for k, v in got.items():
                tol = OUT_TOL if k in ("logits", "loss") else GRAD_TOL
                err, err64, own = _fp32_errors(arch, graph_level, k, v)
                if min(err, err64) > tol:
                    print(f"{arch} graph_level={graph_level} {k}: err "
                          f"{err:.2e}, err64 {err64:.2e}, reference's own "
                          f"{own:.2e}")
