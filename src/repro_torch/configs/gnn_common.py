"""Shared shapes, train steps and dry-run cells of the GNN-family
architectures (GIN, PNA, GatedGCN, NequIP), the port of the reference's
`configs/gnn_common.py`.

Shapes (assigned):
  full_graph_sm  Cora-like full batch: 2,708 nodes / 10,556 edges / d=1433
  minibatch_lg   Reddit-like sampled training: 1,024 seeds, fanout 15-10
                 (the sampler is `data.graphs.NeighborSampler`; the shape
                 is the padded block it produces)
  ogb_products   2,449,029 nodes / 61,859,140 edges / d=100, full batch
  molecule       128 graphs x 30 nodes x 64 edges (graph classification)

`padded_sizes` gives a shape's padded N and E as the reference's
`make_gnn_cell` computes them (E = ceil(2 raw, 1024); one sink node,
N padded to 512 where the shape shards its nodes), `shape_config` the
configuration a shape runs (its d_feat, classes, task, bf16 where the
nodes shard), `cell_batch` a synthetic batch at those sizes, and
`make_train_step_for` the train step (over a mesh too: `shard_params`
stores the replicated parameters, the batch is placed by
`batch_specs`), and `make_gnn_cell` / `make_nequip_cell` a shape's
dry-run `Cell` (edge arrays over ("pod", "data"), node arrays too where
the shape shards its nodes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.graphs import NeighborSampler, pad_block, synthetic_molecules
from ..models import gnn as G
from ..models import nequip as NQ
from ..launch.mesh import Sharded, shard_leaf
from ..launch.mesh import Spec as P
from ..train import optim as O
from ..train.loop import make_train_step
from ..train.optim import OptimizerConfig
from .cell import Cell, abstract, materialize, train_outs


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# symmetrized + padded static shapes per assigned cell
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges_raw=10556,
                          d_feat=1433, n_classes=7, graph_level=False,
                          shard_nodes=False),
    "minibatch_lg": dict(kind="train", n_nodes=184320, n_edges_raw=168960,
                         d_feat=602, n_classes=41, graph_level=False,
                         shard_nodes=True,
                         note="sampled block: 1024 seeds x fanout 15-10 on a"
                              " 232,965-node/115M-edge graph"),
    "ogb_products": dict(kind="train", n_nodes=2449029,
                         n_edges_raw=61859140, d_feat=100, n_classes=47,
                         graph_level=False, shard_nodes=True),
    "molecule": dict(kind="train", n_nodes=30 * 128, n_edges_raw=64 * 2 * 128,
                     d_feat=16, n_classes=2, graph_level=True, n_graphs=128,
                     shard_nodes=False),
}
MINIBATCH_SEEDS = 1024
MINIBATCH_FANOUTS = (15, 10)

# the cells' optimizer (the reference's `make_gnn_cell` / `make_nequip_cell`)
TRAIN_OPT = OptimizerConfig(lr=1e-3, weight_decay=0.0)


def _bd(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def padded_edges(spec: dict, multi_pod: bool) -> int:
    """The reference's padded edge count of a shape spec (symmetrized
    unless the spec says ``shape_sym=False``, rounded up to 1024)."""
    raw = spec["n_edges_raw"] * (2 if spec["shape_sym"] else 1) \
        if "shape_sym" in spec else spec["n_edges_raw"] * 2
    return _ceil_to(raw, 1024)


def padded_sizes(shape: str) -> tuple[int, int]:
    """(N, E) of a shape's padded batch: E = ceil(2 x raw edges, 1024);
    N = nodes + 1 (the sink that absorbs edge padding), rounded up to
    512 where the shape shards its nodes."""
    spec = GNN_SHAPES[shape]
    E = _ceil_to(spec["n_edges_raw"] * 2, 1024)
    N = _ceil_to(spec["n_nodes"] + 1, 512) if spec["shard_nodes"] \
        else spec["n_nodes"] + 1
    return N, E


def shape_config(cfg, shape: str):
    """``cfg`` sized for ``shape``: a `GNNConfig` takes the shape's d_feat,
    classes and task, in bf16 where the nodes shard; a `NequIPConfig`
    takes its d_feat."""
    spec = GNN_SHAPES[shape]
    if isinstance(cfg, NQ.NequIPConfig):
        return dataclasses.replace(cfg, d_feat=spec["d_feat"])
    return G.GNNConfig(cfg.name, cfg.kind, cfg.n_layers, cfg.d_hidden,
                       d_feat=spec["d_feat"], n_classes=spec["n_classes"],
                       graph_level=spec["graph_level"], d_edge=cfg.d_edge,
                       compute_dtype=("bfloat16" if spec["shard_nodes"]
                                      else "float32"))


def n_graphs_of(cfg, shape: str):
    """The n_graphs the loss takes at ``shape`` (None for a GNN's node
    task; NequIP sums one energy per graph, 1 where there is none)."""
    spec = GNN_SHAPES[shape]
    if isinstance(cfg, NQ.NequIPConfig):
        return spec.get("n_graphs", 1)
    return spec["n_graphs"] if spec["graph_level"] else None


def gnn_model_flops(cfg, E: int, N: int) -> float:
    """Analytic per-step fwd+bwd FLOPs (the reference's estimate)."""
    d = cfg.d_hidden
    if cfg.kind == "gin":
        per_layer = 2 * E * d + 2 * 2 * N * d * d
    elif cfg.kind == "pna":
        per_layer = 2 * E * d * d + 8 * E * d + 2 * N * 13 * d * d
    else:  # gatedgcn
        per_layer = 5 * 2 * E * d * d + 10 * E * d
    return 3.0 * cfg.n_layers * per_layer  # x3 for bwd


def nequip_model_flops(cfg: NQ.NequIPConfig, E: int, N: int) -> float:
    """Per-step fwd+bwd FLOPs of NequIP (the reference's
    `make_nequip_cell` meta): per edge the radial MLP and the paths'
    tensor products over C channels, per node the self-interaction."""
    n_paths, C = len(NQ._paths()), cfg.channels
    return 3.0 * cfg.n_layers * E * (
        2 * cfg.n_rbf * cfg.radial_hidden
        + 2 * cfg.radial_hidden * n_paths * C + n_paths * C * 45) \
        + 3.0 * cfg.n_layers * N * 2 * C * C * 9


def model_flops(cfg, E: int, N: int) -> float:
    return (nequip_model_flops(cfg, E, N) if isinstance(cfg, NQ.NequIPConfig)
            else gnn_model_flops(cfg, E, N))


def nequip_edge_chunk(E: int):
    """NequIP's edge chunk at E edges (the reference's rule): E // 64
    above 4M edges, E // 8 above 100k, else none."""
    if E > 4_000_000:
        return E // 64 if E % 64 == 0 else None
    if E > 100_000:
        return E // 8 if E % 8 == 0 else None
    return None


def nequip_force_weight(shape: str) -> float:
    """Forces only where the task is molecular (positions are physical)."""
    return 0.1 if shape == "molecule" else 0.0


def batch_specs(cfg, shape: str, multi_pod: bool = False) -> dict:
    """The cell's batch specs at ``shape`` (the reference's ``bspec``):
    the edge arrays over ("pod", "data"), the node arrays and node labels
    too where a GNN's shape shards its nodes; NequIP's node arrays
    replicated (every edge chunk gathers ``h[src]`` by arbitrary index),
    every other key replicated."""
    spec = GNN_SHAPES[shape]
    bd = _bd(multi_pod)
    if isinstance(cfg, NQ.NequIPConfig):
        nspec = P(None, None)
        return {"feat": nspec, "pos": nspec, "edges_src": P(bd),
                "edges_dst": P(bd), "graph_id": P(None),
                "energy": P(None), "forces": nspec}
    out = {"feat": P(bd, None) if spec["shard_nodes"] else P(None, None),
           "edges_src": P(bd), "edges_dst": P(bd)}
    if spec["graph_level"]:
        out.update(graph_id=P(None), labels=P(None))
    else:
        out["labels"] = P(bd) if spec["shard_nodes"] else P(None)
    return out


def shard_params(params, cfg, mesh) -> dict:
    """``params`` stored by their `param_specs` over ``mesh``: every leaf
    replicated, a `launch.mesh.Sharded` list of one block a shard (one
    tensor a device). `optim.init_opt_state` over them stores the
    moments the same way."""
    mod = NQ if isinstance(cfg, NQ.NequIPConfig) else G
    specs = mod.param_specs(cfg)
    return G.nest_params({p: shard_leaf(v, specs[p], mesh)
                          for p, v in G.flatten_params(params).items()})


def make_train_step_for(cfg, shape: str,
                        opt_cfg: OptimizerConfig = TRAIN_OPT, mesh=None,
                        **kw):
    """`make_train_step` over the loss ``cfg`` trains at ``shape`` (``cfg``
    as `shape_config` sizes it; ``kw``: ``accum_steps``,
    ``compress_grads``): a GNN's cross-entropy; NequIP's energy + force
    loss on `molecule`, its energy MSE through `nequip_edge_chunk`
    elsewhere. Over a ``mesh`` (parameters and state stored by
    `shard_params`), each batch is placed by the cell's `batch_specs`
    (multi-pod where the mesh has a "pod" axis), the losses run their
    mesh paths and the backward runs on one thread (`make_train_step`'s
    ``one_thread``)."""
    ng = n_graphs_of(cfg, shape)
    if mesh is not None:
        kw.update(mesh=mesh, one_thread=True, batch_specs=batch_specs(
            cfg, shape, multi_pod="pod" in mesh.axis_names))
    if not isinstance(cfg, NQ.NequIPConfig):
        return make_train_step(
            lambda p, b: G.loss_fn(p, cfg, b, n_graphs=ng), opt_cfg, **kw)
    fw = nequip_force_weight(shape)
    chunk = nequip_edge_chunk(padded_sizes(shape)[1])

    def loss(p, b):
        if fw:
            return NQ.loss_fn(p, cfg, b, n_graphs=ng, force_weight=fw)
        e = NQ.energy_fn(p, cfg, b, n_graphs=ng, edge_chunk=chunk)
        target = b["energy"]
        if isinstance(target, Sharded):
            target = target[0]
        return torch.mean((e - torch.as_tensor(target, device=e.device)) ** 2)

    return make_train_step(loss, opt_cfg, **kw)


def cell_batch(shape: str, seed: int = 0, graph=None) -> dict:
    """A synthetic batch of numpy arrays at ``shape``'s padded sizes, with
    NequIP's ``pos`` / ``energy`` / ``forces`` beside the GNN fields.
    ``minibatch_lg`` samples a real block from ``graph`` (a
    `core.graph.Graph`: `MINIBATCH_SEEDS` seeds, fanouts 15-10) and pads
    it with `pad_block`; the seeds carry labels, the rest -1.
    ``molecule`` is `synthetic_molecules` (128 graphs of 30 nodes, 128
    edges each, symmetrized) plus the sink node, whose graph id (128) is
    out of range and so dropped by the pooling. The other shapes are
    uniform random graphs of the shape's raw edge count, symmetrized and
    padded with sink self-edges; the sink is unlabelled."""
    spec = GNN_SHAPES[shape]
    N, E = padded_sizes(shape)
    rng = np.random.default_rng(seed)
    out: dict = {}
    if shape == "molecule":
        ng = spec["n_graphs"]
        m = synthetic_molecules(ng, spec["n_nodes"] // ng,
                                spec["n_edges_raw"] // ng, spec["d_feat"],
                                seed=seed)
        pad = N - spec["n_nodes"]
        for k in ("feat", "pos", "forces"):
            out[k] = np.concatenate([m[k], np.zeros((pad,) + m[k].shape[1:],
                                                    np.float32)])
        out["graph_id"] = np.concatenate([m["graph_id"],
                                          np.full(pad, ng, np.int32)])
        src = np.concatenate([m["edges_src"], m["edges_dst"]])
        dst = np.concatenate([m["edges_dst"], m["edges_src"]])
        out["labels"], out["energy"] = m["labels"], m["energy"]
    else:
        if shape == "minibatch_lg":
            if graph is None:
                raise ValueError("minibatch_lg samples its block from a graph")
            seeds = rng.choice(graph.num_nodes, MINIBATCH_SEEDS,
                               replace=False).astype(np.int32)
            block = pad_block(NeighborSampler(graph, seed=seed).sample(
                seeds, list(MINIBATCH_FANOUTS)), N, E)
            src, dst = block["edges_src"], block["edges_dst"]
            labels = np.full(N, -1, np.int32)
            labels[:MINIBATCH_SEEDS] = rng.integers(0, spec["n_classes"],
                                                    MINIBATCH_SEEDS)
        else:
            n, raw = spec["n_nodes"], spec["n_edges_raw"]
            u = rng.integers(0, n, raw).astype(np.int32)
            v = rng.integers(0, n, raw).astype(np.int32)
            src, dst = np.concatenate([u, v]), np.concatenate([v, u])
            labels = rng.integers(0, spec["n_classes"], N).astype(np.int32)
            labels[N - 1] = -1
        out["labels"] = labels
        out["feat"] = rng.standard_normal((N, spec["d_feat"])).astype(
            np.float32)
        out["pos"] = (rng.standard_normal((N, 3)) * 2).astype(np.float32)
        out["forces"] = np.zeros((N, 3), np.float32)
        out["energy"] = rng.standard_normal(1).astype(np.float32)
        out["graph_id"] = np.zeros(N, np.int32)
    pad_e = E - src.shape[0]
    out["edges_src"] = np.concatenate([src, np.full(pad_e, N - 1)]).astype(
        np.int32)
    out["edges_dst"] = np.concatenate([dst, np.full(pad_e, N - 1)]).astype(
        np.int32)
    return out


def _param_count(mod, cfg) -> int:
    return sum(int(np.prod(s)) for s in mod.param_defs(cfg).values())


def make_gnn_cell(cfg: G.GNNConfig, shape: str, multi_pod: bool = False,
                  arch_name: str | None = None) -> Cell:
    """The dry-run cell of a GIN / PNA / GatedGCN ``cfg`` at ``shape``:
    a train step over the padded batch (`padded_sizes`), ``cfg`` sized
    by `shape_config`."""
    spec = GNN_SHAPES[shape]
    N, E = padded_sizes(shape)
    cfg = shape_config(cfg, shape)
    ap = G.abstract_params(cfg)
    ps = G.param_shardings(cfg)
    batch = {"feat": abstract((N, spec["d_feat"])),
             "edges_src": abstract((E,), torch.int32),
             "edges_dst": abstract((E,), torch.int32)}
    if spec["graph_level"]:
        batch["graph_id"] = abstract((N,), torch.int32)
        batch["labels"] = abstract((spec["n_graphs"],), torch.int32)
    else:
        batch["labels"] = abstract((N,), torch.int32)
    bspec = batch_specs(cfg, shape, multi_pod)
    ao = O.abstract_opt_state(TRAIN_OPT, ap)
    osd = O.opt_state_shardings(TRAIN_OPT, ps)
    meta = {"family": "gnn", "scan_trips": 1,   # python-loop layers
            "model_flops": gnn_model_flops(cfg, E, N),
            "n_nodes": N, "n_edges": E, "params": _param_count(G, cfg)}
    if "note" in spec:
        meta["note"] = spec["note"]
    return Cell(arch_name or cfg.name, shape, "train",
                make_train_step_for(cfg, shape), (ap, ao, batch),
                (ps, osd, bspec), (ps, osd, None), (0, 1), meta,
                outs=train_outs(ap, ao))


def make_nequip_cell(cfg: NQ.NequIPConfig, shape: str,
                     multi_pod: bool = False) -> Cell:
    """NequIP's dry-run cell at ``shape``: node arrays replicated (every
    edge chunk gathers ``h[src]`` by arbitrary index), edge arrays over
    ("pod", "data"); the force loss on `molecule`, the energy MSE
    through `nequip_edge_chunk` elsewhere."""
    spec = GNN_SHAPES[shape]
    N, E = padded_sizes(shape)
    cfg = shape_config(cfg, shape)
    ap = NQ.abstract_params(cfg)
    ps = NQ.param_shardings(cfg)
    ng = n_graphs_of(cfg, shape)
    batch = {"feat": abstract((N, spec["d_feat"])), "pos": abstract((N, 3)),
             "edges_src": abstract((E,), torch.int32),
             "edges_dst": abstract((E,), torch.int32),
             "graph_id": abstract((N,), torch.int32),
             "energy": abstract((ng,)), "forces": abstract((N, 3))}
    bspec = batch_specs(cfg, shape, multi_pod)
    edge_chunk = nequip_edge_chunk(E)
    ao = O.abstract_opt_state(TRAIN_OPT, ap)
    osd = O.opt_state_shardings(TRAIN_OPT, ps)
    meta = {"family": "gnn",
            "scan_trips": (E // edge_chunk if edge_chunk else 1),
            "model_flops": nequip_model_flops(cfg, E, N),
            "n_nodes": N, "n_edges": E, "edge_chunk": edge_chunk,
            "params": _param_count(NQ, cfg),
            "note": "synthetic 3D coords for non-molecular graphs "
                    "(DESIGN.md)"}
    return Cell(cfg.name, shape, "train", make_train_step_for(cfg, shape),
                (ap, ao, batch), (ps, osd, bspec), (ps, osd, None), (0, 1),
                meta, outs=train_outs(ap, ao))


def concrete_args(cell: Cell, generator: torch.Generator) -> tuple:
    """A cell's arguments drawn on the generator's device: edges among
    the N nodes, labels among the classes, graph ids among the graphs,
    NequIP's positions spread as `cell_batch` spreads them."""
    params, _, batch = cell.args
    N = batch["feat"].shape[0]
    ng = (batch["energy"] if "energy" in batch else batch["labels"]).shape[0]
    classes = params["head_w"].shape[1] if "head_w" in params else 1

    def int_range(path, t):
        key = path.rsplit("/", 1)[-1]
        if key in ("edges_src", "edges_dst"):
            return 0, N
        if key == "graph_id":
            return 0, ng
        if key == "labels":
            return 0, classes
        return 0, 1                     # the optimizer's step

    args = materialize(cell.args, generator, int_range)
    if "pos" in batch:
        args[2]["pos"].normal_(0.0, 2.0, generator=generator)
    return args
