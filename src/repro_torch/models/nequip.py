"""NequIP-style E(3)-equivariant interatomic potential (arXiv:2101.03164),
l_max = 2, the port of the reference's `models/nequip.py`:

  - real spherical harmonics l in {0, 1, 2} as explicit polynomials;
  - coupling tensors = Gaunt coefficients from Gauss-Legendre x
    uniform-phi quadrature (exact for these polynomial degrees), a numpy
    copy of the reference's tables: 11 paths (l1, l2, l3);
  - interaction layer: radial-Bessel-weighted tensor-product messages
    (h_j^{l1} (x) Y^{l2}(r_hat))_{l3}, segment-sum aggregation, per-l
    self-interaction, scalar-gated nonlinearity;
  - readout: per-atom scalar energy -> graph sum; forces are
    ``-autograd.grad(E, pos, create_graph=True)``, so a training step on
    the force loss differentiates twice through the segment backend
    (`models/common.py`: every gather and segment sum of `edge_messages`
    is its differentiable pair, deterministic on the card).

The reference's model has no Pallas kernel; the einsums are
`torch.einsum`. Parameters are the reference's nested dict
(`params_from_numpy` carries its `init_params` across; `param_specs` /
`param_shardings` and `abstract_params` are its dry-run forms).
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.collectives import all_gather, all_reduce, reduce_sum
from ..kernels._cuda import resolve_device
from ..launch.mesh import data_shards, place_batch
from ..launch.mesh import Spec as P
from .common import (SegmentPlan, abstract_tree, flatten_params,
                     load_numpy_tree, nest_params, param_tree, register_params,
                     segment_gather, segment_sum, tree_to_numpy,
                     trunc_normal)
from .remat import recompute
from .segment_mesh import edge_specs, shard_trees, stored_mesh

LS = (0, 1, 2)
BIG_GRAPH = 500_000   # above this many nodes, each layer recomputes


# ----------------------------------------------------- real SH + Gaunt setup
def _real_sh_np(vec: np.ndarray) -> dict[int, np.ndarray]:
    """Orthonormal real spherical harmonics on unit vectors [*, 3]."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    c0 = 0.5 / np.sqrt(np.pi)
    c1 = np.sqrt(3.0 / (4 * np.pi))
    out = {
        0: np.stack([np.full_like(x, c0)], -1),
        1: c1 * np.stack([x, y, z], -1),
        2: np.stack([
            0.5 * np.sqrt(15 / np.pi) * x * y,
            0.5 * np.sqrt(15 / np.pi) * y * z,
            0.25 * np.sqrt(5 / np.pi) * (3 * z * z - 1.0),
            0.5 * np.sqrt(15 / np.pi) * x * z,
            0.25 * np.sqrt(15 / np.pi) * (x * x - y * y),
        ], -1),
    }
    return out


@lru_cache(maxsize=None)
def _gaunt_tables() -> dict[tuple[int, int, int], np.ndarray]:
    """G[l1,l2,l3][m1,m2,m3] = Int Y_l1m1 Y_l2m2 Y_l3m3 dOmega, exactly."""
    nt, nphi = 16, 32  # exact for polynomial degree <= 2*16-1 in cos(theta)
    ct, wt = np.polynomial.legendre.leggauss(nt)
    phi = (np.arange(nphi) + 0.5) * (2 * np.pi / nphi)
    wphi = 2 * np.pi / nphi
    st = np.sqrt(1 - ct ** 2)
    grid = np.stack([
        (st[:, None] * np.cos(phi)[None, :]).ravel(),
        (st[:, None] * np.sin(phi)[None, :]).ravel(),
        np.broadcast_to(ct[:, None], (nt, nphi)).ravel(),
    ], -1)
    w = (wt[:, None] * wphi * np.ones(nphi)[None, :]).ravel()
    sh = _real_sh_np(grid)
    tables = {}
    for l1 in LS:
        for l2 in LS:
            for l3 in LS:
                g = np.einsum("g,ga,gb,gc->abc", w, sh[l1], sh[l2], sh[l3])
                g[np.abs(g) < 1e-12] = 0.0
                if np.abs(g).max() > 1e-12:
                    tables[(l1, l2, l3)] = g.astype(np.float32)
    return tables


def _paths():
    """All (l1, l2, l3) tensor-product paths with nonzero Gaunt coupling."""
    return sorted(_gaunt_tables().keys())


@lru_cache(maxsize=None)
def _shared_couplings() -> tuple:
    """Per path, the path whose ``Y x Gaunt`` product it reads: paths
    whose table, as an [2l2+1, (2l1+1)(2l3+1)] matrix, is the same (the
    (0, l, l) and (l, l, 0) pairs) share one product, as XLA's
    common-subexpression pass shares it in the reference."""
    first: dict = {}
    out = []
    for pi, path in enumerate(_paths()):
        g = _gaunt_tables()[path]
        key = (path[1], g.transpose(1, 0, 2).reshape(g.shape[1], -1)
               .tobytes())
        out.append(first.setdefault(key, pi))
    return tuple(out)


@lru_cache(maxsize=None)
def _gaunt_on(device: torch.device, dtype=torch.float32) -> dict:
    """The Gaunt tables (float32) as ``dtype`` tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device, dtype)
            for k, v in _gaunt_tables().items()}


def sph_harm(vec: torch.Tensor) -> dict:
    """Real SH of unit vectors [E, 3] -> {l: [E, 2l+1]}."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    c0 = float(0.5 / np.sqrt(np.pi))
    c1 = float(np.sqrt(3.0 / (4 * np.pi)))
    a = float(0.5 * np.sqrt(15 / np.pi))
    b = float(0.25 * np.sqrt(5 / np.pi))
    c = float(0.25 * np.sqrt(15 / np.pi))
    return {
        0: torch.full_like(x, c0)[..., None],
        1: c1 * torch.stack([x, y, z], -1),
        2: torch.stack([a * x * y, a * y * z, b * (3 * z * z - 1.0),
                        a * x * z, c * (x * x - y * y)], -1),
    }


def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float):
    """Bessel radial basis with smooth polynomial cutoff envelope."""
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rs = torch.maximum(r, _const(1e-6, r))[:, None]
    b = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rs / cutoff) / rs
    u = r / cutoff
    env = 1 - 10 * u ** 3 + 15 * u ** 4 - 6 * u ** 5   # p=3 smooth cutoff
    env = torch.where(u < 1.0, env, 0.0)
    return b * env[:, None]


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    channels: int = 32          # multiplicity per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 16            # species / input feature width
    radial_hidden: int = 64


# --------------------------------------------------------------- param defs
def param_defs(cfg: NequIPConfig) -> dict:
    """Parameter path -> shape (the reference's, without shardings)."""
    L, C = cfg.n_layers, cfg.channels
    defs = {"embed_w": (cfg.d_feat, C), "readout_w1": (C, C),
            "readout_b1": (C,), "readout_w2": (C, 1),
            "layers.radial_w1": (L, cfg.n_rbf, cfg.radial_hidden),
            "layers.radial_b1": (L, cfg.radial_hidden),
            "layers.radial_w2": (L, cfg.radial_hidden, len(_paths()) * C)}
    for l in LS:
        defs[f"layers.self_w{l}"] = (L, C, C)
        if l > 0:
            defs[f"layers.gate_w{l}"] = (L, C, C)
    return defs


def param_specs(cfg) -> dict:
    """{path: Spec}: every leaf replicated, as in the reference."""
    return {p: P(*([None] * len(s))) for p, s in param_defs(cfg).items()}


def abstract_params(cfg) -> dict:
    return abstract_tree(param_defs(cfg))


def param_shardings(cfg) -> dict:
    return nest_params(param_specs(cfg))


def init_params(cfg: NequIPConfig, generator: torch.Generator) -> dict:
    """The reference's `init_params`: `trunc_normal` from ``generator``
    in sorted path order, the ``_b1`` biases zero."""
    flat = {}
    for path, shape in sorted(param_defs(cfg).items()):
        flat[path] = (torch.zeros(shape, device=generator.device)
                      if path.endswith("_b1") else
                      trunc_normal(shape, generator))
    return nest_params(flat)


# ------------------------------------------------------------------ forward
def edge_geometry(pos: torch.Tensor, src: SegmentPlan, dst: SegmentPlan,
                  cfg: NequIPConfig) -> dict:
    """The layer-invariant geometry of the edges (src, dst): the radial
    basis ``rbf`` [e, n_rbf], the mask of non-degenerate edges (r ~ 0,
    e.g. self loops: Y_l>=2 of the zero vector does not rotate), and per
    path (l1, l2, l3) the product ``Y[l2] x Gaunt(l1, l2, l3)`` [e, 2l1+1,
    2l3+1]. Computed once a forward and read by every layer, as XLA
    hoists it out of the reference's layer scan; a cotangent to ``pos``
    flows through it."""
    gaunt = _gaunt_on(pos.device, pos.dtype)
    rel = segment_gather(pos, src) - segment_gather(pos, dst)
    r = torch.linalg.norm(rel + 1e-12, dim=-1)
    unit = rel / torch.maximum(r, _const(1e-6, r))[:, None]
    Y = sph_harm(unit)
    paths = _paths()
    prods, yg = {}, []
    for (l1, _, l3), src in zip(paths, _shared_couplings()):
        if src not in prods:
            prods[src] = torch.einsum("en,mnp->emp", Y[paths[src][1]],
                                      gaunt[paths[src]])
        yg.append(prods[src].reshape(-1, 2 * l1 + 1, 2 * l3 + 1))
    return {"rbf": bessel_basis(r, cfg.n_rbf, cfg.cutoff),
            "live": (r > 1e-6).to(r.dtype)[:, None], "yg": yg}


def edge_messages(h: dict, lp: dict, cfg: NequIPConfig, src: SegmentPlan,
                  dst: SegmentPlan, geo: dict) -> dict:
    """Messages of the edges (src, dst) of geometry ``geo``
    (`edge_geometry`) and their per-l segment sums into the destination
    nodes: {l: [N, C, 2l+1]}."""
    C = cfg.channels
    paths = _paths()
    rad = F.silu(geo["rbf"] @ lp["radial_w1"] + lp["radial_b1"])
    rad = rad @ lp["radial_w2"]                                # [e, P*C]
    rad = (rad * geo["live"]).reshape(-1, len(paths), C)
    hj = {l: segment_gather(h[l], src) for l in LS}            # [e, C, 2l+1]
    msg = {l: 0.0 for l in LS}
    for pi, (l1, l2, l3) in enumerate(paths):
        m = torch.einsum("ecm,emp->ecp", hj[l1], geo["yg"][pi])
        msg[l3] = msg[l3] + m * rad[:, pi, :, None]
    return {l: segment_sum(msg[l], dst) for l in LS}


class _ChunkedMessages(torch.autograd.Function):
    """The aggregation over edge chunks with O(N + chunk) memory: the
    forward saves nothing per chunk, the backward recomputes each chunk
    (its geometry once, then its messages) and takes its vector-Jacobian
    product with respect to (h, lp). No cotangent flows to ``pos``
    (energy-only training; the force loss never takes this path), as in
    the reference."""

    @staticmethod
    def forward(ctx, cfg, chunks, pos, lp_keys, *tensors):
        h = dict(zip(LS, tensors[:3]))
        lp = dict(zip(lp_keys, tensors[3:]))
        ctx.cfg, ctx.chunks, ctx.pos, ctx.lp_keys = cfg, chunks, pos, lp_keys
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            acc = None
            for src, dst in chunks:
                a = edge_messages(h, lp, cfg, src, dst,
                                  edge_geometry(pos, src, dst, cfg))
                acc = a if acc is None else {l: acc[l] + a[l] for l in LS}
        return tuple(acc[l] for l in LS)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *dagg):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        h = dict(zip(LS, leaves[:3]))
        lp = dict(zip(ctx.lp_keys, leaves[3:]))
        total = [torch.zeros_like(t) for t in leaves]
        for src, dst in ctx.chunks:
            geo = edge_geometry(ctx.pos, src, dst, ctx.cfg)
            with torch.enable_grad():
                out = edge_messages(h, lp, ctx.cfg, src, dst, geo)
                grads = torch.autograd.grad(
                    [out[l] for l in LS], leaves, grad_outputs=list(dagg),
                    allow_unused=True)
            total = [t if g is None else t + g for t, g in zip(total, grads)]
        return (None, None, None, None) + tuple(total)


def _messages(h: dict, lp: dict, cfg: NequIPConfig, plans, pos, geo) -> dict:
    """A layer's per-l aggregates over the edges of ``plans``: whole
    (a (src, dst) pair, over the forward's geometry ``geo``) or chunked
    (a list of pairs, each chunk's geometry computed in the chunk)."""
    if isinstance(plans, list):
        keys = tuple(sorted(lp))
        return dict(zip(LS, _ChunkedMessages.apply(
            cfg, plans, pos.detach(), keys, *(h[l] for l in LS),
            *(lp[k] for k in keys))))
    return edge_messages(h, lp, cfg, plans[0], plans[1], geo)


def _update(h: dict, agg: dict, lp: dict) -> dict:
    """The per-l self-interaction with its residual, then the gated
    nonlinearity."""
    new_h = {l: h[l] + torch.einsum("ncm,cd->ndm", agg[l], lp[f"self_w{l}"])
             for l in LS}
    s = new_h[0][:, :, 0]
    out = {0: F.silu(s)[:, :, None]}
    for l in (1, 2):
        gate = torch.sigmoid(s @ lp[f"gate_w{l}"])             # [N, C]
        out[l] = new_h[l] * gate[:, :, None]
    return out


def _layer(h: dict, lp: dict, cfg: NequIPConfig, plans, pos, geo) -> dict:
    """One interaction layer: `_messages`, then `_update`."""
    return _update(h, _messages(h, lp, cfg, plans, pos, geo), lp)


def _on(x, device):
    return torch.as_tensor(x, device=device)


def _plans(src_ids, dst_ids, N: int, edge_chunk):
    """The edges' plans: chunks of ``edge_chunk`` (a list of (src, dst)
    pairs) where the edges are more than one chunk and a whole number of
    them, else one (src, dst) pair."""
    E = src_ids.shape[0]
    if edge_chunk and E > edge_chunk and E % edge_chunk == 0:
        return [(SegmentPlan(src_ids[i:i + edge_chunk], N),
                 SegmentPlan(dst_ids[i:i + edge_chunk], N))
                for i in range(0, E, edge_chunk)]
    return (SegmentPlan(src_ids, N), SegmentPlan(dst_ids, N))


def energy_fn(params, cfg: NequIPConfig, batch, n_graphs: int | None = None,
              edge_chunk: int | None = None) -> torch.Tensor:
    """batch: feat [N, d_feat], pos [N, 3], edges_src/dst [E], graph_id
    [N]. Returns per-graph energies [G].

    edge_chunk: aggregate edges in chunks of this size (where E > chunk
    and E % chunk == 0) through `_ChunkedMessages`, so the [E, C, 2l+1]
    message tensors never materialize at full E (each chunk's geometry
    is computed in the chunk); otherwise the edges' geometry
    (`edge_geometry`) is computed once and read by every layer. A graph
    of more than `BIG_GRAPH` nodes recomputes each layer in the
    backward.

    Over `Sharded` parameters (`configs.gnn_common.shard_params`), on
    their mesh, see `_energy_mesh`; the energies are on data shard 0's
    device."""
    mesh = stored_mesh(params["embed_w"])
    if mesh is not None:
        return _energy_mesh(params, cfg, batch, n_graphs, edge_chunk, mesh)
    dev = params["embed_w"].device
    feat = _on(batch["feat"], dev)
    pos = _on(batch["pos"], dev)
    N, C = feat.shape[0], cfg.channels
    plans = _plans(_on(batch["edges_src"], dev), _on(batch["edges_dst"], dev),
                   N, edge_chunk)
    geo = None if isinstance(plans, list) else \
        edge_geometry(pos, *plans, cfg)
    h0 = (feat @ params["embed_w"])[:, :, None]
    h = {0: h0, 1: h0.new_zeros((N, C, 3)), 2: h0.new_zeros((N, C, 5))}

    def run_layer(i, *hs):
        lp = {k: v[i] for k, v in params["layers"].items()}
        out = _layer(dict(zip(LS, hs)), lp, cfg, plans, pos, geo)
        return tuple(out[l] for l in LS)

    big = N > BIG_GRAPH
    for i in range(cfg.n_layers):
        hs = tuple(h[l] for l in LS)
        hs = (checkpoint(run_layer, i, *hs, use_reentrant=False) if big
              else run_layer(i, *hs))
        h = dict(zip(LS, hs))
    e_atom = F.silu(h[0][:, :, 0] @ params["readout_w1"]
                    + params["readout_b1"]) @ params["readout_w2"]
    ng = n_graphs if n_graphs is not None else 1
    gid = batch.get("graph_id")
    gid = (torch.zeros(N, dtype=torch.long, device=dev) if gid is None
           else _on(gid, dev))
    return segment_sum(e_atom[:, 0], SegmentPlan(gid, ng))


def _energy_mesh(params, cfg: NequIPConfig, batch, n_graphs, edge_chunk,
                 mesh, pos=None) -> torch.Tensor:
    """`energy_fn` with the edges split over the mesh's data shards and
    every node array replicated (the reference's NequIP cells): each
    shard runs its edges (in chunks of ``edge_chunk`` where its block is
    a whole number of them above one) into partial aggregates, the three
    per-l aggregates of a layer meet in one all-reduce
    (`collectives.all_reduce`, differentiable twice), and each shard
    updates its own copy of the node irreps. ``pos`` is each shard's
    positions (the force loss's leaves), else the batch's. Data shard 0
    reads the energies out."""
    ks = data_shards(mesh)
    devs = [mesh.devices[k] for k in ks]
    b = place_batch(batch, mesh, edge_specs(mesh))
    ps = shard_trees(params, mesh)
    feats = all_gather(b["feat"], devs)
    pos = pos or all_gather(b["pos"], devs)
    N, C = feats[0].shape[0], cfg.channels
    plans = [_plans(b["edges_src"][k].long(), b["edges_dst"][k].long(), N,
                    edge_chunk) for k in ks]
    geos = [None if isinstance(pl, list) else edge_geometry(x, *pl, cfg)
            for pl, x in zip(plans, pos)]
    hs = [(f @ p["embed_w"])[:, :, None] for f, p in zip(feats, ps)]
    hs = [{0: h, 1: h.new_zeros((N, C, 3)), 2: h.new_zeros((N, C, 5))}
          for h in hs]
    n = len(ks)
    keys = sorted(ps[0]["layers"])

    def run_layer(*flat):
        hs = [dict(zip(LS, flat[3 * k:3 * k + 3])) for k in range(n)]
        rest = iter(flat[3 * n:])
        lps = [{k: next(rest) for k in keys} for _ in range(n)]
        parts = [[a[l] for l in LS] for a in (
            _messages(h, lp, cfg, pl, x, g)
            for h, lp, pl, x, g in zip(hs, lps, plans, pos, geos))]
        aggs = all_reduce(parts)
        out = [_update(h, dict(zip(LS, a)), lp)
               for h, a, lp in zip(hs, aggs, lps)]
        return tuple(o[l] for o in out for l in LS)

    flat = tuple(h[l] for h in hs for l in LS)
    for i in range(cfg.n_layers):
        lps = [p["layers"][k][i] for p in ps for k in keys]
        # past BIG_GRAPH each layer recomputes in the backward (over every
        # card: `remat.recompute`)
        flat = (recompute(run_layer, *flat, *lps) if N > BIG_GRAPH
                else run_layer(*flat, *lps))
    p0 = ps[0]
    e_atom = F.silu(flat[0][:, :, 0] @ p0["readout_w1"]
                    + p0["readout_b1"]) @ p0["readout_w2"]
    gid = b.get("graph_id")
    gid = (torch.zeros(N, dtype=torch.long, device=devs[0]) if gid is None
           else gid[ks[0]].long())
    ng = n_graphs if n_graphs is not None else 1
    return segment_sum(e_atom[:, 0], SegmentPlan(gid, ng))


def loss_fn(params, cfg: NequIPConfig, batch, n_graphs: int | None = None,
            force_weight: float = 0.1) -> torch.Tensor:
    """Energy MSE + force MSE, forces = -dE/dpos taken with
    ``create_graph=True`` (the NequIP objective): its gradient with
    respect to the parameters is a second derivative. Over `Sharded`
    parameters each data shard's positions are a leaf of their own and the forces are
    their gradients summed in linear shard order (through the twice
    differentiable all-reduce of `_energy_mesh`)."""
    mesh = stored_mesh(params["embed_w"])
    if mesh is not None:
        return _loss_mesh(params, cfg, batch, n_graphs, force_weight, mesh)
    dev = params["embed_w"].device
    pos = _on(batch["pos"], dev).detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy_fn(params, cfg, dict(batch, pos=pos), n_graphs=n_graphs)
        f = -torch.autograd.grad(e.sum(), pos, create_graph=True)[0]
    le = torch.mean((e - _on(batch["energy"], dev)) ** 2)
    lf = torch.mean((f - _on(batch["forces"], dev)) ** 2)
    return le + force_weight * lf


def _loss_mesh(params, cfg, batch, n_graphs, force_weight, mesh):
    ks = data_shards(mesh)
    b = place_batch(batch, mesh, edge_specs(mesh))
    pos = [x.detach().requires_grad_(True)
           for x in all_gather(b["pos"], [mesh.devices[k] for k in ks])]
    with torch.enable_grad():
        e = _energy_mesh(params, cfg, b, n_graphs, None, mesh, pos=pos)
        grads = torch.autograd.grad(e.sum(), pos, create_graph=True)
    f = -reduce_sum(list(grads), e.device)
    k0 = ks[0]
    le = torch.mean((e - b["energy"][k0].to(e.device)) ** 2)
    lf = torch.mean((f - b["forces"][k0].to(e.device)) ** 2)
    return le + force_weight * lf


# -------------------------------------------------------------- the module
class NequIP(nn.Module):
    """NequIP on one device. ``device=None`` means the card (it raises
    where there is none); weights from `init_params` with a generator on
    the device seeded with ``seed``; calls return `energy_fn` over
    `param_tree(self)`."""

    def __init__(self, cfg: NequIPConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        register_params(self, param_defs(cfg), dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        with torch.no_grad():
            for path, v in flatten_params(init_params(cfg, gen)).items():
                self.get_parameter(path).copy_(v)

    def forward(self, batch, n_graphs: int | None = None,
                edge_chunk: int | None = None):
        return energy_fn(param_tree(self), self.cfg, batch,
                         n_graphs=n_graphs, edge_chunk=edge_chunk)


def params_to_numpy(params) -> dict:
    """The reference's nested dict of numpy float32 arrays."""
    return tree_to_numpy(params)


def params_from_numpy(cfg: NequIPConfig, tree: dict, device=None) -> NequIP:
    """A `NequIP` holding the weights of ``tree`` (the reference's
    nested `init_params` dict of numpy arrays)."""
    return load_numpy_tree(NequIP(cfg, device=device), param_defs(cfg), tree)
