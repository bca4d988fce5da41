"""CPU parity of the port's NequIP (`repro_torch.models.nequip`) against
the reference's `models/nequip.py`: the SH and Gaunt tables, energies,
forces (``-autograd.grad`` against ``-jax.grad``), the force loss and
every gradient leaf against `jax.value_and_grad` (a second derivative
through the segment backend), the chunked aggregation, the big-graph
branch, rotation invariance, and the configs.

Tolerances: energies within 1e-5 of max |ref|; forces and gradient
leaves within 1e-4 of each one's max |ref|."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_arch
from repro.configs import gnn_common as ref_common
from repro.data.graphs import synthetic_molecules
from repro.models import nequip as ref_nq

from repro_torch.configs import get_arch
from repro_torch.configs import gnn_common as tcommon
from repro_torch.models import common as C
from repro_torch.models import nequip as tnq
from repro_torch.train import optim as topt

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def rel_err(got, exp) -> float:
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


def to_np(t):
    return t.detach().cpu().numpy()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def ref_params(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, ref_nq.init_params(cfg, jax.random.key(seed)))


def torch_tree(p, dtype=torch.float32):
    return C.nest_params({k: torch.tensor(v, dtype=dtype)
                          for k, v in flat(p).items()})


def molecules(seed=2, graphs=8, nodes=10, edges=20, d_feat=4):
    return synthetic_molecules(graphs, nodes, edges, d_feat, seed=seed)


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def leaf_grads(loss_fn, params, batch):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flat(params).items()}
    loss = loss_fn(C.nest_params(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {
        k: (torch.zeros_like(leaves[k]) if g is None else g)
        for k, g in zip(leaves, grads)}


# ------------------------------------------------------------ the tables
def test_sh_and_gaunt_tables_equal_reference():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((50, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    a, b = ref_nq._real_sh_np(v), tnq._real_sh_np(v)
    for l in ref_nq.LS:
        assert np.abs(a[l] - b[l]).max() <= 1e-12
    ra, ta = ref_nq._gaunt_tables(), tnq._gaunt_tables()
    assert sorted(ra) == sorted(ta) == ref_nq._paths() == tnq._paths()
    assert len(ta) == 11
    for k in ra:
        assert ta[k].dtype == ra[k].dtype
        assert np.abs(ta[k] - ra[k]).max() <= 1e-12


def test_sph_harm_and_bessel_basis_equal_reference():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((40, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    a = ref_nq.sph_harm(jnp.asarray(v))
    b = tnq.sph_harm(torch.from_numpy(v))
    for l in tnq.LS:
        assert rel_err(to_np(b[l]), np.asarray(a[l])) <= OUT_TOL
    r = np.concatenate([[0.0, 1e-7], rng.uniform(0, 6, 30)]).astype(
        np.float32)
    assert rel_err(to_np(tnq.bessel_basis(torch.from_numpy(r), 8, 5.0)),
                   np.asarray(ref_nq.bessel_basis(jnp.asarray(r), 8, 5.0))) \
        <= OUT_TOL


# ---------------------------------------------- energies, forces, the loss
def _cfg():
    return get_arch("nequip").smoke_config(), \
        ref_arch("nequip").smoke_config()


def test_energy_and_forces_equal_reference():
    cfg, rcfg = _cfg()
    b = molecules()
    b["edges_src"][:3] = b["edges_dst"][:3]          # degenerate edges
    p = ref_params(rcfg)
    jb = jbatch(b)
    ref_e, ref_f = jax.jit(jax.value_and_grad(
        lambda pos: ref_nq.energy_fn(p, rcfg, dict(jb, pos=pos),
                                     n_graphs=8).sum()))(jb["pos"])
    ref_e = np.asarray(jax.jit(lambda bb: ref_nq.energy_fn(
        p, rcfg, bb, n_graphs=8))(jb))
    ref_f = -np.asarray(ref_f)
    params = torch_tree(p)
    pos = torch.from_numpy(b["pos"]).requires_grad_(True)
    e = tnq.energy_fn(params, cfg, dict(b, pos=pos), n_graphs=8)
    f = -torch.autograd.grad(e.sum(), pos)[0]
    assert e.shape == (8,)
    assert rel_err(to_np(e), ref_e) <= OUT_TOL
    assert rel_err(to_np(f), ref_f) <= GRAD_TOL


_REF_FORCE_LOSS = {}


def _ref_force_loss(rcfg):
    """The reference's jitted ``value_and_grad`` of its force loss, the
    force weight traced (one compile for every weight)."""
    if rcfg not in _REF_FORCE_LOSS:
        _REF_FORCE_LOSS[rcfg] = jax.jit(jax.value_and_grad(
            lambda q, bb, fw: ref_nq.loss_fn(q, rcfg, bb, n_graphs=8,
                                             force_weight=fw)))
    return _REF_FORCE_LOSS[rcfg]


@pytest.mark.parametrize("force_weight", [0.1, 1.0])
def test_force_loss_and_every_gradient_leaf_equal_reference(force_weight):
    """The NequIP objective's gradient with respect to the parameters:
    a second derivative through every gather and segment sum."""
    cfg, rcfg = _cfg()
    b = molecules(seed=3)
    p = ref_params(rcfg, seed=1)
    ref_loss, ref_g = _ref_force_loss(rcfg)(
        jax.tree_util.tree_map(jnp.asarray, p), jbatch(b),
        jnp.float32(force_weight))
    ref_g = flat(jax.tree_util.tree_map(np.asarray, ref_g))
    loss, g = leaf_grads(lambda q, bb: tnq.loss_fn(
        q, cfg, bb, n_graphs=8, force_weight=force_weight),
        torch_tree(p), b)
    assert abs(float(loss) - float(ref_loss)) <= OUT_TOL * abs(
        float(ref_loss))
    assert set(g) == set(ref_g)
    for k in ref_g:
        assert rel_err(to_np(g[k]), ref_g[k]) <= GRAD_TOL, k


def _energy_loss(mod, cfg, chunk):
    def loss(q, b):
        e = mod.energy_fn(q, cfg, b, n_graphs=8, edge_chunk=chunk)
        return ((e - b["energy"]) ** 2).mean()
    return loss


def test_chunked_aggregation_equals_the_whole():
    """Edges in 4 chunks (nothing saved per chunk, each recomputed in the
    backward): the energies and every gradient leaf equal the unchunked
    path's and the reference's chunked path's; no gradient reaches the
    positions through it."""
    cfg, rcfg = _cfg()
    b = molecules(seed=4)
    E = len(b["edges_src"])
    p = ref_params(rcfg, seed=2)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    ref_g = flat(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda q: _energy_loss(ref_nq, rcfg, E // 4)(q, jbatch(b)))(jp)))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    whole_loss, whole = leaf_grads(_energy_loss(tnq, cfg, None),
                                   torch_tree(p), tb)
    calls = []
    orig = tnq._ChunkedMessages.forward
    tnq._ChunkedMessages.forward = staticmethod(
        lambda ctx, *a: calls.append(len(a[1])) or orig(ctx, *a))
    try:
        chunk_loss, chunked = leaf_grads(_energy_loss(tnq, cfg, E // 4),
                                         torch_tree(p), tb)
    finally:
        tnq._ChunkedMessages.forward = staticmethod(orig)
    assert calls == [4] * cfg.n_layers
    assert abs(float(chunk_loss) - float(whole_loss)) <= OUT_TOL * abs(
        float(whole_loss))
    for k in ref_g:
        assert rel_err(to_np(chunked[k]), to_np(whole[k])) <= OUT_TOL, k
        assert rel_err(to_np(chunked[k]), ref_g[k]) <= GRAD_TOL, k
    pos = tb["pos"].clone().requires_grad_(True)
    e = tnq.energy_fn(torch_tree(p), cfg, dict(tb, pos=pos), n_graphs=8,
                      edge_chunk=E // 4)
    # the energies reach pos only through the chunked messages
    assert not e.requires_grad


def test_energies_are_rotation_invariant():
    from scipy.spatial.transform import Rotation
    cfg, _ = _cfg()
    b = molecules(seed=3, graphs=4, nodes=8, edges=16)
    model = tnq.NequIP(cfg, device="cpu", seed=0)
    e1 = model(b, n_graphs=4)
    R = Rotation.random(random_state=7).as_matrix().astype(np.float32)
    e2 = model(dict(b, pos=b["pos"] @ R.T), n_graphs=4)
    assert rel_err(to_np(e2), to_np(e1)) <= 1e-4


def test_big_graph_branch_equals_the_plain_layer_loop(monkeypatch):
    """Above `BIG_GRAPH` nodes each layer recomputes in the backward:
    energies and every gradient leaf of the force loss equal the plain
    loop's, bit for bit."""
    cfg = tnq.NequIPConfig("big", n_layers=2, channels=2, n_rbf=2,
                           d_feat=2, radial_hidden=4)
    N = tnq.BIG_GRAPH + 1
    rng = np.random.default_rng(5)
    b = {"feat": rng.standard_normal((N, 2)).astype(np.float32),
         "pos": rng.standard_normal((N, 3)).astype(np.float32),
         "edges_src": rng.integers(0, 40, 96).astype(np.int32),
         "edges_dst": rng.integers(0, 40, 96).astype(np.int32),
         "graph_id": (np.arange(N) >= 20).astype(np.int32),
         "energy": np.array([0.5, -1.0], np.float32),
         "forces": np.zeros((N, 3), np.float32)}
    params = C.param_tree(tnq.NequIP(cfg, device="cpu", seed=1))
    calls = []
    orig = tnq.checkpoint
    monkeypatch.setattr(tnq, "checkpoint",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))

    def run():
        return leaf_grads(lambda q, bb: tnq.loss_fn(q, cfg, bb, n_graphs=2),
                          params, b)

    big_loss, big = run()
    assert len(calls) == cfg.n_layers
    monkeypatch.setattr(tnq, "BIG_GRAPH", N + 1)
    plain_loss, plain = run()
    assert len(calls) == cfg.n_layers
    assert torch.equal(big_loss, plain_loss)
    for k in plain:
        assert torch.equal(big[k], plain[k]), k


# ----------------------------------------------------------------- configs
def test_configs_flops_and_rules_equal_the_reference_cells():
    for shape in tcommon.GNN_SHAPES:
        meta = ref_common.make_nequip_cell(ref_arch("nequip").get_config(),
                                           shape).meta
        N, E = tcommon.padded_sizes(shape)
        cfg = tcommon.shape_config(get_arch("nequip").get_config(), shape)
        assert (N, E) == (meta["n_nodes"], meta["n_edges"])
        assert tcommon.nequip_model_flops(cfg, E, N) == meta["model_flops"]
        assert tcommon.nequip_edge_chunk(E) == meta["edge_chunk"]
        assert sum(int(np.prod(s)) for s in tnq.param_defs(cfg).values()) \
            == meta["params"]
        assert tcommon.nequip_force_weight(shape) == (
            0.1 if shape == "molecule" else 0.0)


def test_train_steps_at_the_molecule_shape_with_forces():
    """`make_train_step_for(nequip, "molecule")`: the force loss at the
    cell's padded sizes (smoke width), 3 AdamW steps, the loss falling."""
    cfg = tcommon.shape_config(get_arch("nequip").smoke_config(), "molecule")
    b = tcommon.cell_batch("molecule", seed=1)
    step = tcommon.make_train_step_for(cfg, "molecule")
    p = C.param_tree(tnq.NequIP(cfg, device="cpu", seed=0))
    o = topt.init_opt_state(tcommon.TRAIN_OPT, p)
    losses = []
    for _ in range(3):
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_params_round_trip():
    cfg, rcfg = _cfg()
    p = ref_params(rcfg)
    model = tnq.params_from_numpy(cfg, p, device="cpu")
    back = tnq.params_to_numpy(model)
    for k, v in flat(p).items():
        np.testing.assert_array_equal(flat(back)[k], v)
    fresh = tnq.params_to_numpy(tnq.NequIP(cfg, device="cpu", seed=0))
    assert (fresh["readout_b1"] == 0).all()
    assert (fresh["layers"]["radial_b1"] == 0).all()
    with pytest.raises(ValueError):
        tnq.params_from_numpy(
            dataclasses.replace(cfg, channels=4), p, device="cpu")
