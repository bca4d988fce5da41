"""The segment backend over a mesh: the graph models' message passing
with the edges split over the data shards and the node state replicated,
the reference's "per-shard partial aggregates meet in one all-reduce per
layer" (`src/repro/models/gnn.py`'s note).

Each data shard holds its block of the edges as one or more
`EdgeChunk`s (`edge_chunks`: a `SegmentPlan` pair a chunk, over that
chunk's edges) and its own copy of the node state. `edge_pass` runs a
layer's edge work over every shard's chunks as one autograd node: per
chunk it computes the per-edge values of a ``messages`` function and
reduces each by destination ("sum", "max", "min"), or keeps it per edge
("edge": GatedGCN's new edge state); the sums add in float32 over
chunks, then over shards in linear shard order, and are cast once. It saves only its inputs: the backward recomputes
each chunk and takes its vector-Jacobian product, so a layer never holds
more than a chunk's edge tensors. A max or min splits a segment's
gradient evenly among the rows that reach the global extreme, over every
shard's edges, as JAX's scatter-extremal rule does; that takes a pass in
the backward that counts the hits of each shard before the products.

Every cross-shard sum is an explicit sum in linear shard order, in the
forward and in the backward, and no tensor that the cross-shard node
reads is also read by a shard's own ops without a `fork`: the autograd
engine runs one thread a card and adds a tensor's gradients in arrival
order, so a tensor read by both would sum in another order on other
cards. (The family's mesh steps also run their backward on one thread,
`train.loop.make_train_step(..., one_thread=True)`: the engine sends a
node whose gradients are all absent to the CPU's thread, which a second
derivative through the all-reduce, NequIP's force loss, meets.) A re-run, or the same shards on other
cards, gives the same bits.
"""
from __future__ import annotations

import dataclasses

import torch

from ..distributed.collectives import all_reduce, pmax, pmin, psum
from ..launch.mesh import Sharded, Spec, batch_axes, data_shards
from .common import (SegmentPlan, _reduce, _take, flatten_params,
                     nest_params)


def edge_specs(mesh) -> dict:
    """The batch specs a mesh forward places a raw batch by: the edge
    arrays' rows over the mesh's data axes, every other key
    replicated."""
    bd = tuple(a for a in batch_axes(True) if a in mesh.axis_names)
    return {k: Spec(bd) for k in ("edges_src", "edges_dst", "edge_feat")}


def stored_mesh(leaf):
    """The mesh a parameter leaf is stored over (a `Sharded` leaf's), or
    None."""
    return leaf.mesh if isinstance(leaf, Sharded) else None


def shard_trees(params, mesh) -> list:
    """Each data shard's parameter tree, in `data_shards` order: each
    `Sharded` leaf's block (one leaf a shard, so each shard's gradient
    stays its own until `collectives.sum_replicas` adds the replicas' in
    linear shard order). A whole leaf raises: one tensor read by every
    shard would sum their gradients in the order they arrive."""
    ks = data_shards(mesh)
    flat = flatten_params(params)
    whole = [p for p, v in flat.items() if not isinstance(v, Sharded)]
    if whole:
        raise ValueError(f"a mesh step takes every leaf stored over its mesh "
                         f"(`configs.gnn_common.shard_params`): {whole}")
    return [nest_params({p: v[k] for p, v in flat.items()}) for k in ks]


@dataclasses.dataclass(frozen=True)
class EdgeChunk:
    """Edges ``[lo, hi)`` of a shard's block, with their plans."""

    lo: int
    hi: int
    src: SegmentPlan
    dst: SegmentPlan


def edge_chunks(src, dst, num_nodes: int, chunk: int | None = None) -> list:
    """A shard's edges (int [e] ``src`` / ``dst`` on its device) as
    ``ceil(e / chunk)`` chunks of equal size (the last one short), or one
    chunk where ``chunk`` is None; each chunk's ids are planned once."""
    e = int(src.shape[0])
    n = max(1, -(-e // chunk)) if chunk else 1
    size = max(1, -(-e // n))
    bounds = [(lo, min(lo + size, e)) for lo in range(0, e, size)] or [(0, 0)]
    return [EdgeChunk(lo, hi, SegmentPlan(src[lo:hi], num_nodes),
                      SegmentPlan(dst[lo:hi], num_nodes))
            for lo, hi in bounds]


def mesh_degree(chunks: list) -> list:
    """Each shard's copy of the global in-degree (float32 [N]), from every
    shard's destination ids; no gradient."""
    with torch.no_grad():
        parts = []
        for cs in chunks:
            acc = None
            for c in cs:
                ones = torch.ones(len(c.dst), dtype=torch.float32,
                                  device=c.dst.ids.device)
                r = _reduce(ones, c.dst, "sum")
                acc = r if acc is None else acc + r
            parts.append([acc])
        return [p[0] for p in all_reduce(parts)]


class _Fork(torch.autograd.Function):
    """Two views of one tensor whose gradients add in a fixed order (the
    first's, then the second's), whenever each arrives."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x), x.view_as(x)

    @staticmethod
    def backward(ctx, a, b):
        if a is None or b is None:
            return b if a is None else a
        return a + b


def fork(x: torch.Tensor) -> tuple:
    """``x`` as two views, one for the cross-shard node and one for the
    shard's own ops: its gradient is their sum in that order."""
    return _Fork.apply(x)


class _EdgePass(torch.autograd.Function):
    """See `edge_pass`. The flat inputs are each shard's (h, e?, edge
    parameters...) in linear shard order."""

    @staticmethod
    def forward(ctx, work, *flat):
        fn, kinds, chunks, keys, has_e = work
        n = len(chunks)
        per = len(flat) // n
        ctx.work, ctx.per = work, per
        ctx.set_materialize_grads(False)
        parts, vtypes = [], None
        with torch.no_grad():
            for k in range(n):
                h, e, lp = _unpack(flat[k * per:(k + 1) * per], keys, has_e)
                acc = [None] * len(kinds)
                for c in chunks[k]:
                    vals = fn(h, None if e is None else e[c.lo:c.hi], lp,
                              c.src, c.dst)
                    vtypes = vtypes or [v.dtype for v in vals]
                    for j, (v, kind) in enumerate(zip(vals, kinds)):
                        acc[j] = _accumulate(acc[j], v, kind, c,
                                             chunks[k][-1].hi)
                parts.append(acc)
        ctx.vtypes = vtypes
        outs = [[None] * len(kinds) for _ in range(n)]
        for j, kind in enumerate(kinds):
            col = [p[j] for p in parts]
            if kind == "sum":
                col = psum(col, vtypes[j])
            elif kind in ("max", "min"):
                col = (pmax if kind == "max" else pmin)(col)
            for k in range(n):
                outs[k][j] = col[k]
        ctx.out_meta = [[(o.shape, {"dtype": o.dtype, "device": o.device})
                         for o in shard] for shard in outs]
        ext = [outs[k][j] for k in range(n) for j, kind in enumerate(kinds)
               if kind in ("max", "min")]
        ctx.save_for_backward(*flat, *ext)
        return tuple(o for shard in outs for o in shard)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        fn, kinds, chunks, keys, has_e = ctx.work
        n, per, m = len(chunks), ctx.per, len(kinds)
        saved = ctx.saved_tensors
        flat, ext_flat = saved[:n * per], saved[n * per:]
        ext_js = [j for j, kind in enumerate(kinds) if kind in ("max", "min")]
        ext = [dict(zip(ext_js, ext_flat[k * len(ext_js):
                                         (k + 1) * len(ext_js)]))
               for k in range(n)]
        gs = [list(grads[k * m:(k + 1) * m]) for k in range(n)]
        ins = [_unpack(flat[k * per:(k + 1) * per], keys, has_e)
               for k in range(n)]
        with torch.no_grad():
            G = {}
            for j, kind in enumerate(kinds):
                if kind == "edge" or all(g[j] is None for g in gs):
                    continue
                col = [g[j] if g[j] is not None else
                       torch.zeros(ctx.out_meta[k][j][0],
                                   **ctx.out_meta[k][j][1])
                       for k, g in enumerate(gs)]
                G[j] = psum(col, ctx.vtypes[j])
            scale = _extreme_scales(fn, kinds, chunks, ins, ext, G)
        out = []
        for k in range(n):
            out.extend(_vjp(fn, kinds, chunks[k], ins[k], gs[k], G, scale,
                            ext[k], k))
        return (None,) + tuple(out)


def _unpack(xs, keys, has_e):
    h = xs[0]
    e = xs[1] if has_e else None
    return h, e, dict(zip(keys, xs[1 + has_e:]))


def _accumulate(acc, v, kind, c: EdgeChunk, n_edges: int):
    """Add one chunk's values ``v`` into a shard's partial ``acc``."""
    if kind == "edge":
        if acc is None:
            acc = v.new_empty((n_edges,) + tuple(v.shape[1:]))
        acc[c.lo:c.hi] = v
        return acc
    r = _reduce(v, c.dst, kind, wide=kind == "sum")
    if acc is None:
        return r
    if kind == "sum":
        return acc + r
    return torch.maximum(acc, r) if kind == "max" else torch.minimum(acc, r)


def _extreme_scales(fn, kinds, chunks, ins, ext, G) -> dict:
    """{j: each shard's copy of G_j / (the global count of rows that
    reach extreme j)} for the max / min values with a gradient: every
    shard's chunks recomputed and their hits counted, the counts summed
    in linear shard order."""
    js = [j for j, kind in enumerate(kinds)
          if kind in ("max", "min") and j in G]
    if not js:
        return {}
    parts = []
    for k, (h, e, lp) in enumerate(ins):
        acc = {j: None for j in js}
        for c in chunks[k]:
            vals = fn(h, None if e is None else e[c.lo:c.hi], lp, c.src,
                      c.dst)
            for j in js:
                hit = (vals[j] == _take(ext[k][j], c.dst)).to(torch.float32)
                r = _reduce(hit, c.dst, "sum")
                acc[j] = r if acc[j] is None else acc[j] + r
        parts.append([acc[j] for j in js])
    counts = [psum([p[i] for p in parts]) for i in range(len(js))]
    return {j: [g / cnt.to(g.dtype).clamp_min(1)
                for g, cnt in zip(G[j], counts[i])]
            for i, j in enumerate(js)}


def _vjp(fn, kinds, chunks, inp, gs, G, scale, ext, k) -> list:
    """Shard k's input gradients (h, e?, edge parameters...): each chunk
    recomputed with gradient and its vector-Jacobian product added in
    chunk order, in float32 at least."""
    h, e, lp = inp
    hl = h.detach().requires_grad_(True)
    lpl = {key: v.detach().requires_grad_(True) for key, v in lp.items()}
    acc = [torch.zeros(t.shape, dtype=torch.promote_types(
        t.dtype, torch.float32), device=t.device) for t in [h, *lp.values()]]
    de = None if e is None else torch.zeros_like(e)
    for c in chunks:
        el = None if e is None else e[c.lo:c.hi].detach().requires_grad_(True)
        with torch.enable_grad():
            vals = fn(hl, el, lpl, c.src, c.dst)
        cots: dict = {}
        for j, kind in enumerate(kinds):
            if kind == "edge":
                if gs[j] is None:
                    continue
                cot = gs[j][c.lo:c.hi]
            elif j not in G:
                continue
            elif kind == "sum":
                cot = _take(G[j][k], c.dst)
            else:
                hit = vals[j].detach() == _take(ext[j], c.dst)
                cot = _take(scale[j][k], c.dst) * hit
            # one value read by several reductions (PNA's msg): its
            # cotangents add in the order of ``kinds``
            key = id(vals[j])
            cots[key] = (vals[j], cot if key not in cots
                         else cots[key][1] + cot)
        if not cots:
            continue
        leaves = [hl, *lpl.values()] + ([el] if el is not None else [])
        outs, cot = zip(*cots.values())
        got = torch.autograd.grad(outs, leaves, cot, allow_unused=True)
        for i, g in enumerate(got[:len(acc)]):
            if g is not None:
                acc[i] += g
        if el is not None and got[-1] is not None:
            de[c.lo:c.hi] = got[-1]
    out = [acc[0].to(h.dtype)]
    if e is not None:
        out.append(de)
    return out + [a.to(v.dtype) for a, v in zip(acc[1:], lp.values())]


def edge_pass(messages, kinds: tuple, hs: list, es, lps: list,
              chunks: list) -> list:
    """One layer's edge work over every data shard's chunks, as one
    autograd node.

    ``messages(h, e, lp, src, dst) -> [values]`` gives a chunk's per-edge
    values (``e`` the chunk's rows of the edge state, or None; ``src`` /
    ``dst`` its plans), and ``kinds`` says what becomes of each: "sum",
    "max" or "min" by destination, or "edge" (kept per edge). ``hs`` is
    each shard's node state, ``es`` each shard's edge state (or None),
    ``lps`` each shard's dict of the parameters ``messages`` reads,
    ``chunks`` each shard's `edge_chunks`. Returns each shard's list of
    results: the global [N, ...] reductions (sums in float32 until the
    cross-shard sum, then cast once to the values' dtype) and the
    shard's own [e, ...] edge values."""
    keys = tuple(lps[0])
    has_e = es is not None and es[0] is not None
    flat = []
    for k, h in enumerate(hs):
        flat.append(h)
        if has_e:
            flat.append(es[k])
        flat.extend(lps[k][key] for key in keys)
    work = (messages, tuple(kinds), chunks, keys, has_e)
    out = _EdgePass.apply(work, *flat)
    m = len(kinds)
    return [list(out[k * m:(k + 1) * m]) for k in range(len(hs))]
