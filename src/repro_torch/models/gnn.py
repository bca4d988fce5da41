"""GNN architectures over flat edge lists: GIN, PNA, GatedGCN, the port
of the reference's `models/gnn.py`.

Message passing is the segment backend of `models/common.py`: one
`SegmentPlan` per id array a forward (``edges_src``, ``edges_dst``,
``graph_id``), the gathers ``h[src]`` / ``h[dst]`` through
`segment_gather` and the aggregations through `segment_sum` /
`segment_max` / `segment_min`, so every gradient is a deterministic
segment sum (no float atomics) and the same bits come back on every
run. The reference's message passing is `jax.ops.segment_*` outside any
Pallas kernel, so no kernel of this family is hand-written; the dense
products are `torch.matmul`.

Input format (a dict of numpy arrays or tensors, moved to the
parameters' device): feat [N, F], edges_src / edges_dst [E], optional
edge_feat [E, Fe] (GatedGCN), labels [N] (-1 unlabeled) or [G], graph_id
[N] (graph-level tasks; an id outside [0, G) is dropped, as JAX drops
it). Parameters are the reference's nested dict (``enc_w``, ...,
``layers: {w1: [L, d, d], ...}``); `params_from_numpy` carries the
reference's `init_params` across; `param_specs` / `param_shardings`
and `abstract_params` are the reference's dry-run forms of them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.collectives import all_gather, cross_entropy_blocks
from ..kernels._cuda import resolve_device
from ..launch.mesh import data_shards, place_batch
from ..launch.mesh import Spec as P
from .common import (SegmentPlan, abstract_tree, as_plan,
                     cross_entropy_loss, flatten_params, load_numpy_tree,
                     nest_params, param_tree, register_params, segment_gather,
                     segment_max, segment_min, segment_sum, tree_to_numpy,
                     trunc_normal)
from .remat import recompute
from .segment_mesh import (edge_chunks, edge_pass, edge_specs, fork,
                           mesh_degree, shard_trees, stored_mesh)

BIG_GRAPH = 500_000   # above this many nodes, blocks of layers recompute


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                 # gin | pna | gatedgcn
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int
    graph_level: bool = False     # graph classification (molecule shape)
    d_edge: int = 0
    learnable_eps: bool = True    # GIN-eps
    compute_dtype: str = "float32"


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as JAX promotes a bf16 x f32
    product to f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# --------------------------------------------------------------- primitives
def segment_softmax(scores, seg, num_segments=None):
    plan = as_plan(seg, num_segments)
    m = segment_max(scores, plan)
    e = torch.exp(scores - segment_gather(m, plan))
    z = segment_sum(e, plan)
    return e / (segment_gather(z, plan) + 1e-9)


def degree(edges_dst, num_nodes=None):
    plan = as_plan(edges_dst, num_nodes)
    return segment_sum(torch.ones(len(plan), dtype=torch.float32,
                                  device=plan.ids.device), plan)


# ------------------------------------------------------------------- layers
# Each layer is its edge work, per-edge values that a reduction by
# destination ("sum" / "max" / "min") or the edge state ("edge") takes,
# and its node update over those reductions: one device runs the first
# through `_aggregate`, a mesh through `segment_mesh.edge_pass`.
def _gin_messages(h, e, lp, src, dst):
    return [segment_gather(h, src)]


def _gin_update(h, aggs, lp, d, deg_log_mean):
    z = (1.0 + lp["eps"]) * h + aggs[0]
    z = torch.relu(mm(z, lp["w1"]) + lp["b1"])
    return mm(z, lp["w2"]) + lp["b2"]


def _pna_messages(h, e, lp, src, dst):
    msg = mm(segment_gather(h, src), lp["w_msg"])
    return [msg, msg * msg, msg, msg]


def _pna_update(h, aggs, lp, d, deg_log_mean):
    s, sq, mx, mn = aggs
    has = d[:, None] > 0
    mean = s / torch.clamp_min(d, 1.0)[:, None]
    mx = torch.where(has, mx, 0.0)
    mn = torch.where(has, mn, 0.0)
    var = torch.maximum(sq / torch.clamp_min(d, 1.0)[:, None] - mean * mean,
                        torch.zeros((), device=h.device))
    std = torch.sqrt(var + 1e-5)
    aggs = torch.cat([mean, mx, mn, std], dim=-1)              # [N, 4d]
    logd = torch.log1p(d)[:, None]
    amp = logd / deg_log_mean
    att = deg_log_mean / torch.clamp_min(logd, 1e-5)
    scaled = torch.cat([aggs, aggs * amp, aggs * att], -1)     # [N, 12d]
    return torch.relu(mm(torch.cat([h, scaled], -1), lp["w_out"])
                      + lp["b_out"])


def _layer_norm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    v = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(v + 1e-5) * g + b


def _gatedgcn_messages(h, e, lp, src, dst):
    hi, hj = segment_gather(h, dst), segment_gather(h, src)
    e_new = mm(hi, lp["A"]) + mm(hj, lp["B"]) + mm(e, lp["C"])
    eta = torch.sigmoid(e_new)
    msg = eta * mm(hj, lp["V"])
    e_out = e + torch.relu(_layer_norm(e_new, lp["ln_e_g"], lp["ln_e_b"]))
    return [eta, msg, e_out]


def _gatedgcn_update(h, aggs, lp, d, deg_log_mean):
    agg = aggs[1] / (aggs[0] + 1e-6)
    h_new = mm(h, lp["U"]) + agg
    return h + torch.relu(_layer_norm(h_new, lp["ln_h_g"], lp["ln_h_b"]))


@dataclasses.dataclass(frozen=True)
class _Layer:
    messages: object          # (h, e, lp, src, dst) -> [per-edge values]
    kinds: tuple              # what becomes of each value
    edge_keys: tuple          # the layer parameters `messages` reads
    update: object            # (h, aggs, lp, degree, deg_log_mean) -> h


LAYERS = {
    "gin": _Layer(_gin_messages, ("sum",), (), _gin_update),
    "pna": _Layer(_pna_messages, ("sum", "sum", "max", "min"), ("w_msg",),
                  _pna_update),
    "gatedgcn": _Layer(_gatedgcn_messages, ("sum", "sum", "edge"),
                       ("A", "B", "C", "V", "ln_e_g", "ln_e_b"),
                       _gatedgcn_update),
}
_REDUCE = {"sum": segment_sum, "max": segment_max, "min": segment_min}


def _aggregate(kind: str, h, e, lp, src, dst) -> list:
    """A layer's edge work on one device: its per-edge values, each
    reduced by destination or kept per edge."""
    layer = LAYERS[kind]
    vals = layer.messages(h, e, lp, src, dst)
    return [v if k == "edge" else _REDUCE[k](v, dst)
            for v, k in zip(vals, layer.kinds)]


def gin_layer(h, lp, src, dst, N):
    src, dst = as_plan(src, N), as_plan(dst, N)
    return _gin_update(h, _aggregate("gin", h, None, lp, src, dst), lp,
                       None, None)


def pna_layer(h, lp, src, dst, N, deg_log_mean):
    src, dst = as_plan(src, N), as_plan(dst, N)
    return _pna_update(h, _aggregate("pna", h, None, lp, src, dst), lp,
                       degree(dst), deg_log_mean)


def gatedgcn_layer(h, e, lp, src, dst, N):
    src, dst = as_plan(src, N), as_plan(dst, N)
    aggs = _aggregate("gatedgcn", h, e, lp, src, dst)
    return _gatedgcn_update(h, aggs, lp, None, None), aggs[2]


# --------------------------------------------------------------- param defs
def param_defs(cfg: GNNConfig) -> dict:
    """Parameter path -> shape, the reference's `param_defs` without its
    `PartitionSpec`s."""
    L, d = cfg.n_layers, cfg.d_hidden
    defs = {"enc_w": (cfg.d_feat, d), "enc_b": (d,),
            "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,)}
    if cfg.kind == "gin":
        defs.update({"layers.eps": (L,), "layers.w1": (L, d, d),
                     "layers.b1": (L, d), "layers.w2": (L, d, d),
                     "layers.b2": (L, d)})
    elif cfg.kind == "pna":
        defs.update({"layers.w_msg": (L, d, d),
                     "layers.w_out": (L, 13 * d, d),
                     "layers.b_out": (L, d)})
    elif cfg.kind == "gatedgcn":
        for m in ("A", "B", "C", "U", "V"):
            defs[f"layers.{m}"] = (L, d, d)
        for m in ("ln_h_g", "ln_h_b", "ln_e_g", "ln_e_b"):
            defs[f"layers.{m}"] = (L, d)
        defs["edge_enc_w"] = (max(cfg.d_edge, 1), d)
        defs["edge_enc_b"] = (d,)
    else:
        raise ValueError(cfg.kind)
    return defs


def param_specs(cfg) -> dict:
    """{path: Spec}: every leaf replicated, as in the reference."""
    return {p: P(*([None] * len(s))) for p, s in param_defs(cfg).items()}


def abstract_params(cfg) -> dict:
    return abstract_tree(param_defs(cfg))


def param_shardings(cfg) -> dict:
    return nest_params(param_specs(cfg))


def _constant_init(path: str):
    """1.0 for LayerNorm gains, 0.0 for biases, eps and LayerNorm shifts,
    None for a weight drawn from `trunc_normal` (the reference's rule)."""
    if path.endswith(("_b", ".eps", "b1", "b2", "b_out")) or "ln_" in path:
        return 1.0 if path.endswith("_g") else 0.0
    return None


def init_params(cfg: GNNConfig, generator: torch.Generator) -> dict:
    """The reference's `init_params`: weights from `trunc_normal` drawn
    from ``generator`` (on its device) in sorted path order, biases zero,
    LayerNorm gains one. Returns the nested dict of tensors."""
    flat = {}
    for path, shape in sorted(param_defs(cfg).items()):
        c = _constant_init(path)
        flat[path] = (trunc_normal(shape, generator) if c is None else
                      torch.full(shape, c, device=generator.device))
    return nest_params(flat)


# ------------------------------------------------------------------ forward
def _on(x, device):
    return torch.as_tensor(x, device=device)


def forward(params, cfg: GNNConfig, batch, n_graphs: int | None = None):
    """Logits [N, n_classes] (node tasks) or [G, n_classes] (graph
    tasks) in the compute dtype. A graph of more than `BIG_GRAPH` nodes
    whose depth is a multiple of 4 recomputes each block of 4 layers in
    the backward (`torch.utils.checkpoint`), as the reference's
    ``jax.checkpoint`` over layer blocks.

    Over `Sharded` parameters (`configs.gnn_common.shard_params`), on
    their mesh, see `_forward_mesh`: it returns the list of the data
    shards' logits blocks."""
    mesh = stored_mesh(params["enc_w"])
    if mesh is not None:
        return _forward_mesh(params, cfg, batch, n_graphs, mesh)[0]
    dt = DTYPES[cfg.compute_dtype]
    dev = params["enc_w"].device
    feat = _on(batch["feat"], dev)
    N = feat.shape[0]
    src = SegmentPlan(_on(batch["edges_src"], dev), N)
    dst = SegmentPlan(_on(batch["edges_dst"], dev), N)
    h = mm(feat.to(dt), params["enc_w"].to(dt)) + params["enc_b"].to(dt)
    e = None
    if cfg.kind == "gatedgcn":
        ef = batch.get("edge_feat")
        ef = (torch.ones((len(src), 1), dtype=dt, device=dev) if ef is None
              else _on(ef, dev))
        e = mm(ef.to(dt), params["edge_enc_w"].to(dt)) \
            + params["edge_enc_b"].to(dt)
    deg_log_mean = torch.clamp_min(torch.log1p(degree(dst)).mean(), 1e-2)

    def apply_layer(h, e, i):
        lp = {k: v[i].to(dt) for k, v in params["layers"].items()}
        if cfg.kind == "gin":
            h2, e2 = gin_layer(h, lp, src, dst, N), e
        elif cfg.kind == "pna":
            h2, e2 = pna_layer(h, lp, src, dst, N, deg_log_mean), e
        else:
            h2, e2 = gatedgcn_layer(h, e, lp, src, dst, N)
        return h2.to(dt), (e2.to(dt) if e2 is not None else e2)

    big = N > BIG_GRAPH
    block = 4 if (big and cfg.n_layers % 4 == 0) else 1
    if big and block > 1:
        # recompute over layer blocks: only block boundaries are saved
        def run_block(h, e, b):
            for i in range(b * block, (b + 1) * block):
                h, e = apply_layer(h, e, i)
            return h, e

        for b in range(cfg.n_layers // block):
            h, e = checkpoint(run_block, h, e, b, use_reentrant=False)
    else:
        for i in range(cfg.n_layers):
            h, e = apply_layer(h, e, i)
    if cfg.graph_level:
        gid = SegmentPlan(_on(batch["graph_id"], dev), n_graphs)
        h = segment_sum(h, gid)
    return mm(h, params["head_w"].to(dt)) + params["head_b"].to(dt)


def loss_fn(params, cfg: GNNConfig, batch, n_graphs: int | None = None):
    """The mean cross-entropy over the labels >= 0; over `Sharded`
    parameters the global one (`collectives.cross_entropy_blocks`: the
    data shards' masked sums over the global count, on the first shard's
    device)."""
    mesh = stored_mesh(params["enc_w"])
    if mesh is None:
        logits = forward(params, cfg, batch, n_graphs=n_graphs)
        return cross_entropy_loss(logits, batch["labels"])
    logits, labels = _forward_mesh(params, cfg, batch, n_graphs, mesh)
    return cross_entropy_blocks(logits, labels)


# -------------------------------------------------------- over a mesh
EDGE_CHUNK = 1 << 22   # edges a chunk of a shard's edge work, past BIG_GRAPH


def _block_fn(apply_layer, n: int, keys: list, has_e: bool):
    """A block of 4 layers over flat tensors (each shard's node state,
    its edge state where ``has_e``, then each layer's each shard's
    parameters by ``keys``), for `remat.recompute`."""

    def run(*xs):
        hs, es = list(xs[:n]), list(xs[n:2 * n]) if has_e else [None] * n
        rest = iter(xs[n * (1 + has_e):])
        for _ in range(4):
            lps = [{k: next(rest) for k in keys} for _ in range(n)]
            hs, es = apply_layer(hs, es, lps)
        return tuple(hs) + (tuple(es) if has_e else ())
    return run


def _forward_mesh(params, cfg: GNNConfig, batch, n_graphs, mesh):
    """The forward with the edges split over the mesh's data shards and
    the node state replicated, the reference's sharded step.

    ``batch`` is placed by `launch.mesh.place_batch` (its `Sharded`
    keys kept; raw keys by `edge_specs`). Each data shard gathers the
    whole ``feat`` onto its device (no gradient crosses the cards there)
    and runs the encoder on it; each layer's edge work runs each shard's
    edges (`segment_mesh.edge_pass`, in chunks of `EDGE_CHUNK` edges
    above `BIG_GRAPH` nodes) and all-reduces the partial aggregates once;
    each shard then updates its own copy of the node state. The layers
    recompute in blocks of 4 above `BIG_GRAPH`, as on one device.
    Returns (the logits blocks, the labels blocks): with ``labels`` split
    over the data shards each shard takes its row block, else (graph
    tasks, replicated labels) data shard 0 takes every row."""
    dt = DTYPES[cfg.compute_dtype]
    ks = data_shards(mesh)
    devs = [mesh.devices[k] for k in ks]
    b = place_batch(batch, mesh, edge_specs(mesh))
    ps = shard_trees(params, mesh)
    N = b["feat"].shape[0]
    chunk = EDGE_CHUNK if N > BIG_GRAPH else None
    chunks = [edge_chunks(b["edges_src"][k].long(), b["edges_dst"][k].long(),
                          N, chunk) for k in ks]
    deg = mesh_degree(chunks)
    dlm = [torch.clamp_min(torch.log1p(d).mean(), 1e-2) for d in deg]
    hs = [mm(f.to(dt), p["enc_w"].to(dt)) + p["enc_b"].to(dt)
          for f, p in zip(all_gather(b["feat"], devs), ps)]
    es = [None] * len(ks)
    if cfg.kind == "gatedgcn":
        ef = b.get("edge_feat")
        es = [mm((torch.ones((c[-1].hi, 1), dtype=dt, device=dev)
                  if ef is None else ef[k]).to(dt), p["edge_enc_w"].to(dt))
              + p["edge_enc_b"].to(dt)
              for k, c, dev, p in zip(ks, chunks, devs, ps)]
    layer = LAYERS[cfg.kind]
    keys = sorted(ps[0]["layers"])

    def layer_params(i) -> list:
        return [{k: p["layers"][k][i].to(dt) for k in keys} for p in ps]

    def apply_layer(hs, es, lps):
        forks = [fork(h) for h in hs]
        outs = edge_pass(layer.messages, layer.kinds, [f[0] for f in forks],
                         es, [{k: lp[k] for k in layer.edge_keys}
                              for lp in lps], chunks)
        hs = [layer.update(f[1], o, lp, d, m).to(dt)
              for f, o, lp, d, m in zip(forks, outs, lps, deg, dlm)]
        if cfg.kind == "gatedgcn":
            es = [o[2].to(dt) for o in outs]
        return hs, es

    n = len(ks)
    if N > BIG_GRAPH and cfg.n_layers % 4 == 0:
        # recompute over blocks of 4 layers, as on one device: only block
        # boundaries are saved (`remat.recompute`, since a block
        # spans every card)
        for b_ in range(cfg.n_layers // 4):
            lps = [layer_params(i) for i in range(4 * b_, 4 * b_ + 4)]
            xs = recompute(_block_fn(apply_layer, n, keys, es[0] is not None),
                           *hs, *(e for e in es if e is not None),
                           *(lp[k] for lpl in lps for lp in lpl for k in keys))
            hs, es = list(xs[:n]), list(xs[n:]) or [None] * n
    else:
        for i in range(cfg.n_layers):
            hs, es = apply_layer(hs, es, layer_params(i))
    labels = b.get("labels")
    split = labels is not None and any(x.shape[0] != labels.shape[0]
                                       for x in labels)
    if cfg.graph_level:
        gid = SegmentPlan(b["graph_id"][ks[0]].long(), n_graphs)
        rows = [segment_sum(hs[0], gid)]
    elif split:
        rows = [h[slice(*labels.region(k)[0])] for h, k in zip(hs, ks)]
    else:
        rows = [hs[0]]
    logits = [mm(r, p["head_w"].to(dt)) + p["head_b"].to(dt)
              for r, p in zip(rows, ps)]
    if labels is None:
        return logits, None
    return logits, [labels[k] for k in ks[:len(logits)]]


# -------------------------------------------------------------- the module
class GNN(nn.Module):
    """A GNN on one device. ``device=None`` means the card (it raises
    where there is none); tests pass ``device="cpu"``. Weights come from
    `init_params` with a `torch.Generator` on the device seeded with
    ``seed``; calls run the functional `forward` over `param_tree(self)`
    (the parameters do not require gradients: training runs the
    functional path, `configs.gnn_common.make_train_step_for`)."""

    def __init__(self, cfg: GNNConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        register_params(self, param_defs(cfg), dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        with torch.no_grad():
            for path, v in flatten_params(init_params(cfg, gen)).items():
                self.get_parameter(path).copy_(v)

    def forward(self, batch, n_graphs: int | None = None):
        return forward(param_tree(self), self.cfg, batch, n_graphs=n_graphs)


def params_to_numpy(params) -> dict:
    """The reference's nested dict of numpy float32 arrays, from a `GNN`
    or a nested dict of tensors."""
    return tree_to_numpy(params)


def params_from_numpy(cfg: GNNConfig, tree: dict, device=None) -> GNN:
    """A `GNN` holding the weights of ``tree`` (the reference's nested
    `init_params` dict of numpy arrays); a missing or extra key or a
    shape that differs raises."""
    return load_numpy_tree(GNN(cfg, device=device), param_defs(cfg), tree)
