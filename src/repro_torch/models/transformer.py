"""Decoder-only LM (dense and MoE), the LLaMA / Qwen / DBRX family: the
reference's `models/transformer.py` in PyTorch.

Parameters are the reference's nested dict (``embed``, ``final_norm``,
``lm_head``, ``layers: {ln1, wq, ...}``), the layer weights stacked on a
leading ``n_layers`` axis and run by a Python loop over it. Masters are
float32 and the forward casts each float32 leaf to
``cfg.compute_dtype``, as the reference does before its layer scan; so
`forward` (and `prefill_step`, `loss_fn`) routes MoE tokens with a
bfloat16-rounded router, while `decode_step`, like the reference's,
reads the layer leaves as they are (its router and shared output gate
stay float32). A served copy (`init_params(..., dtype=torch.bfloat16)`
or `LM(cfg, dtype=torch.bfloat16)`) holds every leaf in bfloat16 except
those two, which stay float32, and so gives the reference's numbers on
both paths at half the memory. For the dry run (`launch.dryrun`),
`param_specs` gives each leaf the reference's `PartitionSpec` (as a
`launch.mesh.Spec`), `param_shardings` nests them, and
`abstract_params` / `init_cache_abstract` are the reference's abstract
arguments as meta tensors.

Decode reads and writes the KV cache [L, B, S, Hkv, Dh] in place: a
step writes its keys and values at ``pos`` (clamped so the write fits,
as ``dynamic_update_slice`` clamps) and attends over the whole
preallocated cache, masking positions past ``pos``. Attention
(`attention.gqa_attention`) and the experts (`moe.moe_apply`) are
PyTorch tensor ops, as the reference's are jnp ops outside any Pallas
kernel.

On a mesh (`launch.mesh.ServingMesh`), `init_cache(..., mesh=m)` splits
the cache's sequence axis into contiguous blocks, one a shard in linear
order, each on its shard's device: the reference's `long_500k` sharding
(the sequence over every mesh axis). `decode_step` over such a cache
writes the step's row only into the block that owns the (clamped)
position, the clamp taken at the global S, and each shard attends over
its own block (`attention.gqa_attention_sharded`); the cache is never
gathered. ``decode_step(..., mesh=m)`` also routes the experts as the
reference does under its ambient mesh (`moe.moe_apply`: expert
parallelism where the mesh has a "model" axis).

Over a mesh the parameters may be stored by their `param_specs`
(`shard_params`, or `init_params(..., mesh=)`, which draws each
device's blocks on it): every leaf a `launch.mesh.Sharded` list of
blocks, the reference's storage under its train and serve cells.
`loss_fn` / `forward` then split the batch's rows over the mesh's data
axes, each data shard computing its rows on its device and gathering
each layer's leaves there inside the layer's recomputed region
(`distributed.collectives.gather_leaf`, whose backward sums each
block's gradient on its device): FSDP. A dense layer recomputes each
shard under its own `checkpoint`; an MoE layer, whose experts sit on
their own cards, is one region over every card (`remat.recompute`).
`prefill_step` runs the same layers with each layer's keys and values
written, as they come, into `init_cache(..., mesh=)`'s sequence
blocks, and computes the head at the last position only. `decode_step` runs on the mesh's first device,
gathering a layer's non-expert leaves as it comes, while the experts
stay on their shards.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.collectives import (cross_entropy_blocks, gather_leaf,
                                      gather_leaf_rows)
from ..kernels._cuda import resolve_device
from ..launch.mesh import (Sharded, block_region, data_shards, region_slices,
                           shard_leaf, split_rows)
from ..launch.mesh import Spec as P
from .attention import gqa_attention, gqa_attention_sharded
from .common import (abstract_tree, apply_rope, cross_entropy_loss,
                     flatten_params, gather_rows,
                     load_numpy_tree, nest_params, param_tree,
                     register_tensors, rms_norm, rope_angles, tree_to_numpy,
                     trunc_normal)
from .moe import EXPERT_LEAVES, MoEConfig, moe_apply
from .remat import leaf_blocks, recompute

# float64 is the port's own: a better-conditioned witness of a float32
# comparison (the attention still rounds q, k, p, v to bfloat16)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}
# leaves a served copy keeps in float32: decode routes with them uncast
FP32_LEAVES = ("router", "shared_out_gate")
NORM_LEAVES = ("ln1", "ln2", "final_norm")
# a layer's leaves the MoE FFN reads
MOE_LEAVES = ("router", "w_gate", "w_up", "w_down", "shared_gate_w",
              "shared_up", "shared_down", "shared_out_gate")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e6
    moe: Optional[MoEConfig] = None
    window: Optional[int] = None          # sliding-window attention (opt-in)
    compute_dtype: str = "bfloat16"
    remat: str = "full"                   # none | full
    # the reference's tensor-parallel plan; kept so the configs compare
    tp_size: int = 16

    @property
    def heads_shardable(self) -> bool:
        return self.n_heads % self.tp_size == 0

    def param_count(self) -> int:
        d, L = self.d_model, self.n_layers
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        o = self.n_heads * self.d_head * d
        if self.moe:
            m = self.moe
            ffn = 3 * d * m.d_ff_expert * m.num_experts
            if m.num_shared:
                ffn += 3 * d * m.d_ff_expert * m.num_shared
                if m.shared_gate:
                    ffn += d
            ffn += d * m.padded_experts  # router
        else:
            ffn = 3 * d * self.d_ff
        return L * (qkv + o + ffn + 2 * d) + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d, L, m = self.d_model, self.n_layers, self.moe
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        o = self.n_heads * self.d_head * d
        ffn = 3 * d * m.d_ff_expert * (m.top_k + m.num_shared)
        ffn += d * m.padded_experts
        return L * (qkv + o + ffn + 2 * d) + 2 * self.vocab * d + d


# --------------------------------------------------------------- params
def param_defs(cfg: LMConfig) -> dict:
    """{path: shape}, the reference's `param_defs` without its
    PartitionSpecs."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    hq = cfg.n_heads * cfg.d_head
    hkv = cfg.n_kv_heads * cfg.d_head
    defs = {
        "embed": (V, d),
        "final_norm": (d,),
        "lm_head": (d, V),
        "layers.ln1": (L, d),
        "layers.ln2": (L, d),
        "layers.wq": (L, d, hq),
        "layers.wk": (L, d, hkv),
        "layers.wv": (L, d, hkv),
        "layers.wo": (L, hq, d),
    }
    if cfg.qkv_bias:
        defs.update({"layers.bq": (L, hq), "layers.bk": (L, hkv),
                     "layers.bv": (L, hkv)})
    if cfg.moe:
        m = cfg.moe
        E, Fe = m.padded_experts, m.d_ff_expert
        defs.update({
            "layers.router": (L, d, E),
            "layers.w_gate": (L, E, d, Fe),
            "layers.w_up": (L, E, d, Fe),
            "layers.w_down": (L, E, Fe, d),
        })
        if m.num_shared:
            Fs = Fe * m.num_shared
            defs.update({
                "layers.shared_gate_w": (L, d, Fs),
                "layers.shared_up": (L, d, Fs),
                "layers.shared_down": (L, Fs, d),
            })
            if m.shared_gate:
                defs["layers.shared_out_gate"] = (L, d, 1)
    else:
        defs.update({
            "layers.w_gate": (L, d, cfg.d_ff),
            "layers.w_up": (L, d, cfg.d_ff),
            "layers.w_down": (L, cfg.d_ff, d),
        })
    return defs


def param_specs(cfg: LMConfig) -> dict:
    """{path: Spec}: the reference's partitioning of each leaf. Heads that
    divide the tensor-parallel axis shard column / row parallel over
    "model"; otherwise attention weights are split over "data" only (the
    reference's context-parallel plan)."""
    col = cfg.heads_shardable
    specs = {
        "embed": P("model", "data"),
        "final_norm": P(None),
        "lm_head": P("data", "model"),
        "layers.ln1": P(None, None),
        "layers.ln2": P(None, None),
        "layers.wq": (P(None, "data", "model") if col
                      else P(None, "data", None)),
        "layers.wk": P(None, "data", None),
        "layers.wv": P(None, "data", None),
        "layers.wo": (P(None, "model", "data") if col
                      else P(None, None, "data")),
    }
    if cfg.qkv_bias:
        specs.update({"layers.bq": P(None, "model") if col else P(None, None),
                      "layers.bk": P(None, None), "layers.bv": P(None, None)})
    if cfg.moe:
        specs.update({"layers.router": P(None, "data", None),
                      "layers.w_gate": P(None, "model", "data", None),
                      "layers.w_up": P(None, "model", "data", None),
                      "layers.w_down": P(None, "model", None, "data")})
        if cfg.moe.num_shared:
            specs.update({"layers.shared_gate_w": P(None, "data", "model"),
                          "layers.shared_up": P(None, "data", "model"),
                          "layers.shared_down": P(None, "model", "data")})
            if cfg.moe.shared_gate:
                specs["layers.shared_out_gate"] = P(None, "data", None)
    else:
        specs.update({"layers.w_gate": P(None, "data", "model"),
                      "layers.w_up": P(None, "data", "model"),
                      "layers.w_down": P(None, "model", "data")})
    return specs


def abstract_params(cfg: LMConfig) -> dict:
    """The parameter tree as float32 meta tensors (the reference's
    `abstract_params`: masters are float32)."""
    return abstract_tree(param_defs(cfg))


def param_shardings(cfg: LMConfig) -> dict:
    return nest_params(param_specs(cfg))


def leaf_dtype(path: str, dtype) -> torch.dtype:
    """The dtype a leaf is held in for a copy in ``dtype``: the router
    and the shared output gate stay float32."""
    return torch.float32 if path.endswith(FP32_LEAVES) else dtype


def init_params(cfg: LMConfig, generator: torch.Generator,
                dtype=torch.float32, mesh=None) -> dict:
    """The reference's `init_params` with a `torch.Generator` (on the
    device the weights go to): norms one, every other leaf
    `trunc_normal` with ``fan_in = shape[0]`` of the whole leaf (for a
    stacked layer leaf [L, ...] that is L, as in the reference). A
    stacked leaf is drawn a layer at a time and each slice cast to its
    dtype as it comes (`leaf_dtype`), so a bfloat16 copy of a
    full-width model never holds a whole leaf in float32. With a
    ``mesh``, each leaf is stored by its `Spec` (`shard_params`), each
    device drawing its own shards' blocks (`_init_sharded`)."""
    if mesh is not None:
        return _init_sharded(cfg, generator, dtype, mesh)
    dev = generator.device
    flat = {}
    for path, shape in sorted(param_defs(cfg).items()):
        dt = leaf_dtype(path, dtype)
        if path.endswith(NORM_LEAVES):
            flat[path] = torch.ones(shape, dtype=dt, device=dev)
        elif path.startswith("layers."):
            leaf = torch.empty(shape, dtype=dt, device=dev)
            for i in range(shape[0]):
                leaf[i] = trunc_normal(shape[1:], generator, fan_in=shape[0])
            flat[path] = leaf
        else:
            flat[path] = trunc_normal(shape, generator).to(dt)
    return nest_params(flat)


def _init_sharded(cfg: LMConfig, generator: torch.Generator, dtype,
                  mesh) -> dict:
    """`shard_params(init_params(cfg, generator, dtype), cfg, mesh)`,
    drawn shard by shard: each device of the mesh replays the whole draw
    with a generator of its own in ``generator``'s state (the same
    numbers: one device type), leaf by leaf and a layer slice at a time,
    and keeps only its shards' blocks. The largest transient is one
    layer slice of one leaf in float32. ``generator`` ends in the state
    the whole draw leaves it in."""
    defs, specs = param_defs(cfg), param_specs(cfg)
    start = generator.get_state()
    blocks = {path: [None] * mesh.size for path in defs}
    end = start
    for dev in mesh.physical_devices():
        if dev.type != generator.device.type:
            raise ValueError(f"a {generator.device.type} generator cannot "
                             f"replay its draw on {dev}")
        gen = torch.Generator(dev)
        gen.set_state(start)
        mine = [k for k in range(mesh.size) if mesh.devices[k] == dev]
        for path, shape in sorted(defs.items()):
            dt = leaf_dtype(path, dtype)
            regions: dict = {}
            for k in mine:
                regions.setdefault(block_region(shape, specs[path], mesh, k),
                                   []).append(k)
            made = {r: torch.empty(tuple(b - a for a, b in r), dtype=dt,
                                   device=dev) for r in regions}
            if path.endswith(NORM_LEAVES):
                for blk in made.values():
                    blk.fill_(1)
            elif path.startswith("layers."):
                for i in range(shape[0]):
                    sl = trunc_normal(shape[1:], gen, fan_in=shape[0])
                    for r, blk in made.items():
                        if r[0][0] <= i < r[0][1]:
                            blk[i - r[0][0]] = sl[region_slices(r[1:])]
                    del sl
            else:
                whole = trunc_normal(shape, gen).to(dt)
                for r, blk in made.items():
                    blk.copy_(whole[region_slices(r)])
                del whole
            for r, ks in regions.items():
                for k in ks:
                    blocks[path][k] = made[r]
        end = gen.get_state()
    generator.set_state(end)
    return nest_params({p: Sharded(b, specs[p], mesh, defs[p])
                        for p, b in blocks.items()})


# -------------------------------------------------------------- forward
def _write_rows(blocks, rows: torch.Tensor, at: int) -> None:
    """Write ``rows`` [B, T, ...] at global sequence position ``at`` of a
    cache split into contiguous ``blocks`` [B, S_local, ...]: each row
    goes only to the block that owns it."""
    off, T = 0, rows.shape[1]
    for blk in blocks:
        n = blk.shape[1]
        lo, hi = max(at, off), min(at + T, off + n)
        if lo < hi:
            blk[:, lo - off:hi - off] = rows[:, lo - at:hi - at].to(
                device=blk.device, dtype=blk.dtype)
        off += n


def _attend(cfg: LMConfig, x, lp: dict, sin, cos, cache=None, pos=None,
            kv_valid_len=None):
    """A decoder layer's attention half. x: [B, T, D]; cache: (k, v)
    [B, S, Hkv, Dh], or (k, v) lists of a sequence-sharded cache's
    blocks, written in place at ``pos``. Returns (x after the attention
    residual, its ``ln2`` norm, (k, v))."""
    B, T, d = x.shape
    dt = x.dtype
    h = rms_norm(x, lp["ln1"].to(dt))
    q = h @ lp["wq"].to(dt)
    k = h @ lp["wk"].to(dt)
    v = h @ lp["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(dt)
        k = k + lp["bk"].to(dt)
        v = v + lp["bv"].to(dt)
    q = q.reshape(B, T, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if cache is not None and isinstance(cache[0], (list, tuple)):
        ck, cv = cache
        S = sum(b.shape[1] for b in ck)
        at = min(max(int(pos), 0), S - T)
        _write_rows(ck, k, at)
        _write_rows(cv, v, at)
        new_cache = (ck, cv)
        attn = gqa_attention_sharded(q, ck, cv, q_offset=pos,
                                     kv_valid_len=kv_valid_len,
                                     window=cfg.window)
    elif cache is not None:
        ck, cv = cache
        at = min(max(int(pos), 0), ck.shape[1] - T)
        ck[:, at:at + T] = k.to(ck.dtype)
        cv[:, at:at + T] = v.to(cv.dtype)
        new_cache = (ck, cv)
        attn = gqa_attention(q, ck, cv, causal=False, q_offset=pos,
                             kv_valid_len=kv_valid_len, window=cfg.window)
    else:
        new_cache = (k, v)  # exposed for prefill cache collection
        attn = gqa_attention(q, k, v, causal=True, window=cfg.window)
    x = x + attn.reshape(B, T, -1) @ lp["wo"].to(dt)
    return x, rms_norm(x, lp["ln2"].to(dt)), new_cache


def _layer(cfg: LMConfig, x, lp: dict, sin, cos, cache=None, pos=None,
           kv_valid_len=None, mesh=None):
    """One decoder layer (`_attend`, then the FFN); ``mesh`` routes the
    experts (`moe.moe_apply`), whose leaves may be `Sharded` layer
    slices. Returns (x, (k, v), aux)."""
    x, h, new_cache = _attend(cfg, x, lp, sin, cos, cache, pos,
                              kv_valid_len)
    B, T, d = x.shape
    dt = x.dtype
    if cfg.moe:
        wp = {k2: lp[k2] for k2 in MOE_LEAVES if k2 in lp}
        y, aux = moe_apply(h.reshape(B * T, d), wp, cfg.moe, mesh=mesh)
        y = y.reshape(B, T, d)
    else:
        g = F.silu(h @ lp["w_gate"].to(dt))
        y = (g * (h @ lp["w_up"].to(dt))) @ lp["w_down"].to(dt)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, new_cache, aux


def _embed(params: dict, tokens, dt, device=None, shard=None
           ) -> torch.Tensor:
    """The token embeddings [..., D] in ``dt``; from a `Sharded` table,
    the rows gathered onto ``device`` block by block (for ``shard``,
    `gather_leaf_rows`)."""
    emb = params["embed"]
    if isinstance(emb, Sharded):
        tokens = torch.as_tensor(tokens, device=device)
        rows = gather_leaf_rows(emb, tokens.reshape(-1).long(), device,
                                shard)
    else:
        tokens = torch.as_tensor(tokens, device=emb.device)
        rows = gather_rows(emb, tokens.reshape(-1).long())
    return rows.reshape(tuple(tokens.shape) + (emb.shape[1],)).to(dt)


def forward(params: dict, cfg: LMConfig, tokens, collect_kv: bool = False,
            mesh=None):
    """tokens: [B, T] -> (logits [B, T, vocab] in the compute dtype, aux)
    and, with ``collect_kv``, the per-layer (k, v) lists. Each float32
    layer leaf is cast to the compute dtype first (the reference casts
    before its scan); with ``cfg.remat == "full"`` and a gradient
    wanted, each layer is recomputed in the backward. ``mesh`` is the
    reference's ambient mesh, which routes the experts
    (`moe.moe_apply`), as in `decode_step`. Over parameters stored by
    their `Spec`s (`Sharded` leaves), see `_forward_mesh`; ``mesh`` is
    then theirs, and the per-layer (k, v) are each layer's list of the
    data shards' blocks."""
    if isinstance(params["embed"], Sharded):
        if mesh not in (None, params["embed"].mesh):
            raise ValueError("a forward routes over the mesh its "
                             "parameters are stored on")
        if not collect_kv:
            return _forward_mesh(params, cfg, tokens)
        ks, vs = [], []

        def keep(i, kvs):
            ks.append([k for k, _ in kvs])
            vs.append([v for _, v in kvs])

        logits, aux = _forward_mesh(params, cfg, tokens, kv_sink=keep)
        return logits, aux, (ks, vs)
    dt = DTYPES[cfg.compute_dtype]
    x = _embed(params, tokens, dt)
    T = x.shape[1]
    sin, cos = rope_angles(torch.arange(T, device=x.device), cfg.d_head,
                           cfg.rope_theta, dt)
    layers = params["layers"]
    remat = (cfg.remat == "full" and not collect_kv
             and torch.is_grad_enabled())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = {k: (v[i].to(dt) if v.dtype == torch.float32 else v[i])
              for k, v in layers.items()}
        if remat:
            x, _, a = checkpoint(lambda x_, lp_: _layer(cfg, x_, lp_, sin,
                                                        cos, mesh=mesh),
                                 x, lp, use_reentrant=False)
        else:
            x, (k, v), a = _layer(cfg, x, lp, sin, cos, mesh=mesh)
            if collect_kv:
                ks.append(k)
                vs.append(v)
        aux = aux + a
    x = rms_norm(x, params["final_norm"].to(dt))
    logits = x @ params["lm_head"].to(dt)
    if collect_kv:
        return logits, aux / cfg.n_layers, (ks, vs)
    return logits, aux / cfg.n_layers


def _mesh_layer(cfg: LMConfig, xs: list, leaves: dict, rope: list,
                mesh, remat: bool):
    """Layer i over the data shards' activations ``xs`` (each on its
    device), its leaves ``leaves`` `Sharded` layer slices. Each shard
    gathers the leaves it reads onto its device in the compute dtype
    inside the recomputed region (its own replica of a block where it
    holds one: `gather_leaf`'s ``shard``), so the backward gathers them
    again and no device keeps every layer's. A dense layer runs each shard
    apart, each under its own `checkpoint`; an MoE layer runs the
    shards' attention, then one `moe.moe_apply` over all their tokens
    (its experts gathered only over the axes other than "model"), as
    one region over every card: `remat.recompute`, with every block of
    every leaf it reads among its inputs. Returns (xs, aux, each shard's
    (k, v))."""
    dt = xs[0].dtype
    ks = data_shards(mesh)

    if not cfg.moe:
        def one(x, sin, cos, k):
            lp = {n: gather_leaf(v, x.device, dt, shard=k)
                  for n, v in leaves.items()}
            return _layer(cfg, x, lp, sin, cos)[:2]

        out = [checkpoint(one, x, sin, cos, k, use_reentrant=False,
                          preserve_rng_state=False) if remat
               else one(x, sin, cos, k)
               for x, (sin, cos), k in zip(xs, rope, ks)]
        return [y for y, _ in out], torch.zeros(
            (), dtype=torch.float32, device=xs[0].device), \
            [kv for _, kv in out]

    def joint(xs_, ls):
        mids, hs, kvs = [], [], []
        for x, (sin, cos), k in zip(xs_, rope, ks):
            lp = {n: gather_leaf(v, x.device, dt, shard=k)
                  for n, v in ls.items() if n not in MOE_LEAVES}
            mid, h, kv = _attend(cfg, x, lp, sin, cos)
            mids.append(mid)
            hs.append(h.reshape(-1, h.shape[-1]))
            kvs.append(kv)
        ys, aux = moe_apply(hs, {k: ls[k] for k in MOE_LEAVES if k in ls},
                            cfg.moe, mesh=mesh, dtype=dt)
        return [m + y.reshape(m.shape) for m, y in zip(mids, ys)], aux, kvs

    if not remat:
        return joint(xs, leaves)
    n = len(xs)
    blocks, rebuild = leaf_blocks(leaves)

    def flat(*ts):
        ys, aux, kvs = joint(ts[:n], rebuild(ts[n:]))
        return (*ys, aux, *(t for kv in kvs for t in kv))

    out = recompute(flat, *xs, *blocks)
    return list(out[:n]), out[n], [tuple(out[n + 1 + 2 * d:n + 3 + 2 * d])
                                   for d in range(n)]


def _forward_mesh(params: dict, cfg: LMConfig, tokens, kv_sink=None,
                  last_only: bool = False):
    """`forward` over parameters stored by their `Spec`s over a mesh: the
    batch's rows split over the mesh's data axes (``tokens`` a list of
    row blocks, or an array split here), each data shard computing its
    rows on its own device (`launch.mesh.data_shards`), every leaf
    gathered where it is read (`_mesh_layer`; the embedding's rows from
    each block). ``kv_sink(i, kvs)`` is handed layer i's keys and values
    (each data shard's (k, v)) as the layer produces them, and turns the
    recompute off, as ``collect_kv`` does in `forward`; ``last_only``
    computes the head at the last position alone. Returns (the shards'
    logits, a list, aux on the first shard's device)."""
    mesh = params["embed"].mesh
    if cfg.moe and cfg.moe.ep_axis not in mesh.axis_names:
        raise NotImplementedError(
            f"an MoE step over a mesh without the {cfg.moe.ep_axis!r} axis "
            "(the reference's moe_ffn_chunked over the global batch) is "
            "not ported")
    dt = DTYPES[cfg.compute_dtype]
    ks = data_shards(mesh)
    devs = [mesh.devices[k] for k in ks]
    xs = [_embed(params, t, dt, dev, k)
          for t, dev, k in zip(split_rows(tokens, mesh), devs, ks)]
    T = xs[0].shape[1]
    rope = [rope_angles(torch.arange(T, device=dev), cfg.d_head,
                        cfg.rope_theta, dt) for dev in devs]
    layers = {k: v.unbind() for k, v in params["layers"].items()}
    remat = (cfg.remat == "full" and kv_sink is None
             and torch.is_grad_enabled())
    aux = torch.zeros((), dtype=torch.float32, device=devs[0])
    for i in range(cfg.n_layers):
        xs, a, kvs = _mesh_layer(cfg, xs, {k: v[i] for k, v in
                                           layers.items()},
                                 rope, mesh, remat)
        if kv_sink is not None:
            kv_sink(i, kvs)
        del kvs
        aux = aux + a
    if last_only:
        xs = [x[:, -1:] for x in xs]
    logits = [rms_norm(x, gather_leaf(params["final_norm"], dev, dt,
                                      shard=k))
              @ gather_leaf(params["lm_head"], dev, dt, shard=k)
              for x, dev, k in zip(xs, devs, ks)]
    return logits, aux / cfg.n_layers


def loss_fn(params: dict, cfg: LMConfig, batch: dict) -> torch.Tensor:
    """The reference's loss: the token-mean cross-entropy plus the MoE
    balance loss. Over `Sharded` parameters the batch's leaves may be
    the data shards' row blocks (`train.loop.make_train_step(...,
    mesh=)` splits them), and the mean is the global one
    (`collectives.cross_entropy_blocks`)."""
    logits, aux = forward(params, cfg, batch["tokens"])
    if isinstance(logits, list):
        labels = split_rows(batch["labels"], params["embed"].mesh)
        return cross_entropy_blocks(logits, labels) + aux
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    return cross_entropy_loss(logits, labels) + aux


def prefill_step(params: dict, cfg: LMConfig, tokens,
                 return_logits: bool = False, max_len: int | None = None):
    """Inference prefill: run the prompt [B, T]; returns (next tokens
    [B], the KV cache {"k", "v"} [L, B, max_len, Hkv, Dh] in bfloat16,
    positions from T on zero), the layout `decode_step` takes, and with
    ``return_logits`` the prompt's logits [B, T, vocab] after them.
    ``max_len`` defaults to T (the reference's cache); a caller that
    decodes after the prompt passes a longer one. Over parameters stored
    by their `Spec`s, see `_prefill_mesh`."""
    if isinstance(params["embed"], Sharded):
        return _prefill_mesh(params, cfg, tokens, return_logits, max_len)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    T = tokens.shape[1]
    max_len = _cache_len(T, max_len)
    logits, _, (ks, vs) = forward(params, cfg, tokens, collect_kv=True)
    nxt = torch.argmax(logits[:, -1, :], dim=-1).to(tokens.dtype)
    cache = {}
    for name, kv in (("k", ks), ("v", vs)):
        cache[name] = torch.zeros((cfg.n_layers, tokens.shape[0], max_len)
                                  + tuple(kv[0].shape[2:]),
                                  dtype=torch.bfloat16, device=tokens.device)
        for i, t in enumerate(kv):
            cache[name][i, :, :T] = t
    del ks, vs
    if return_logits:
        return nxt, cache, logits
    return nxt, cache


def _cache_len(T: int, max_len) -> int:
    if max_len is None:
        return T
    if max_len < T:
        raise ValueError(f"a cache of {max_len} positions does not hold a "
                         f"prompt of {T}")
    return int(max_len)


def _prefill_mesh(params: dict, cfg: LMConfig, tokens, return_logits,
                  max_len):
    """`prefill_step` over parameters stored by their `Spec`s: the
    prompt's rows split over the mesh's data axes, each data shard
    running its rows through every layer on its own device
    (`_forward_mesh`). The cache is `init_cache(..., mesh=)`'s: the
    sequence in blocks, one a shard on its device, each holding every
    row; each layer's keys and values are written into the blocks as the
    layer produces them (`_write_rows`), so no device holds every
    layer's. The head runs at the last position only (with
    ``return_logits``, at every position, joined on the mesh's first
    device). The next tokens are joined there too."""
    mesh = params["embed"].mesh
    rows = split_rows(tokens, mesh)
    B, T = sum(r.shape[0] for r in rows), rows[0].shape[1]
    cache = init_cache(cfg, B, _cache_len(T, max_len), mesh=mesh)
    starts = [sum(r.shape[0] for r in rows[:d]) for d in range(len(rows))]

    def write(i, kvs):
        for r0, kv in zip(starts, kvs):
            for name, t in zip(("k", "v"), kv):
                _write_rows([b[i, r0:r0 + t.shape[0]] for b in cache[name]],
                            t, 0)

    logits, _ = _forward_mesh(params, cfg, rows, kv_sink=write,
                              last_only=not return_logits)
    home = mesh.devices[0]
    nxt = torch.cat([torch.argmax(lg[:, -1, :], dim=-1).to(home)
                     for lg in logits]).to(rows[0].dtype)
    if return_logits:
        return nxt, cache, torch.cat([lg.to(home) for lg in logits])
    return nxt, cache


def init_cache_abstract(cfg: LMConfig, batch: int, max_len: int,
                        dtype=torch.bfloat16) -> dict:
    """`init_cache`'s tree as meta tensors."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None, mesh=None) -> dict:
    """A zeroed cache {"k", "v"} [L, batch, max_len, Hkv, Dh]. With a
    ``mesh`` (``device`` then unused), each of "k" and "v" is a list of
    the mesh's shards' sequence blocks [L, batch, max_len / n, Hkv, Dh],
    in linear order, each on its shard's device (the reference's
    `long_500k` cache sharding); ``max_len`` must divide by the shard
    count."""
    if mesh is not None:
        n = mesh.size
        if max_len % n:
            raise ValueError(f"a cache of {max_len} positions does not "
                             f"split over {n} shards")
        shape = (cfg.n_layers, batch, max_len // n, cfg.n_kv_heads,
                 cfg.d_head)
        return {kv: [torch.zeros(shape, dtype=dtype, device=d)
                     for d in mesh.devices] for kv in ("k", "v")}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def shard_params(params: dict, cfg: LMConfig, mesh) -> dict:
    """``params`` with every leaf stored by its `param_specs` `Spec` over
    ``mesh`` (`launch.mesh.shard_leaf`: a `Sharded` list, one block a
    shard on its device). An expert leaf [L, Ep, ...] splits its experts
    over "model" (the blocks `moe.moe_ffn_replicated_ep` reads) and its
    model dimension over "data". A block on the device its leaf is on is
    a view of it."""
    specs = param_specs(cfg)
    return nest_params({p: shard_leaf(v, specs[p], mesh)
                        for p, v in flatten_params(params).items()})


def _decode_leaves(cfg: LMConfig, layers: dict, i: int, device) -> dict:
    """Layer i's leaves for a decode step on ``device``: a stacked
    tensor's slice; a `Sharded` slice gathered onto ``device`` as
    stored, except the expert leaves, which stay on their shards
    (`moe.moe_ffn_replicated_ep` runs them there)."""
    out = {}
    for k, v in layers.items():
        if isinstance(v, list):
            out[k] = v[i] if (cfg.moe and k in EXPERT_LEAVES) \
                else gather_leaf(v[i], device)
        else:
            out[k] = v[i]
    return out


def decode_step(params: dict, cfg: LMConfig, cache: dict, tokens, pos,
                mesh=None):
    """One serving step: tokens [B] at position ``pos`` (an int or a 0-d
    tensor). Writes the step's keys and values into ``cache`` in place
    and returns (next tokens [B], logits [B, vocab], the cache). The
    layer leaves are read uncast, as the reference's decode scan reads
    them. A 0-d meta ``pos`` (a dry-run count) has no value to read; the
    step's shapes and work are the same at every position, so it runs
    as position 0. ``cache`` may be `init_cache`'s sequence-sharded
    cache; ``mesh`` is the reference's ambient mesh, which routes the
    experts (`moe.moe_apply`). Over parameters stored by their `Spec`s
    (`shard_params`, `init_params(..., mesh=)`), the step runs on the
    mesh's first device: each layer's non-expert leaves are gathered
    there as it comes, the embedding's rows from their blocks, and the
    experts run on their shards; ``mesh`` is then the parameters'
    mesh."""
    dt = DTYPES[cfg.compute_dtype]
    pos = 0 if torch.is_tensor(pos) and pos.is_meta else int(pos)
    layers = params["layers"]
    stored = isinstance(params["embed"], Sharded)
    if stored:
        if mesh not in (None, params["embed"].mesh):
            raise ValueError("decode routes over the mesh its parameters "
                             "are stored on")
        mesh = params["embed"].mesh
        home = mesh.devices[0]
        layers = {k: v.unbind() for k, v in layers.items()}
        x = _embed(params, tokens, dt, home)[:, None, :]
    else:
        x = _embed(params, tokens, dt)[:, None, :]              # [B, 1, D]
    sin, cos = rope_angles(torch.full((1,), pos, device=x.device),
                           cfg.d_head, cfg.rope_theta, dt)
    sin, cos = sin[None], cos[None]                             # [1, 1, Dh/2]
    sharded = isinstance(cache["k"], (list, tuple))
    for i in range(cfg.n_layers):
        kv = tuple([b[i] for b in cache[n]] if sharded else cache[n][i]
                   for n in ("k", "v"))
        x, _, _ = _layer(cfg, x, _decode_leaves(cfg, layers, i, x.device),
                         sin, cos, cache=kv, pos=pos, kv_valid_len=pos + 1,
                         mesh=mesh)
    norm, head = params["final_norm"], params["lm_head"]
    if stored:
        norm, head = gather_leaf(norm, home), gather_leaf(head, home)
    x = rms_norm(x, norm.to(dt))
    logits = (x @ head.to(dt))[:, 0, :]
    tokens = torch.as_tensor(tokens, device=logits.device)
    nxt = torch.argmax(logits, dim=-1).to(tokens.dtype)
    return nxt, logits, cache


# ------------------------------------------------------------ the module
class LM(nn.Module):
    """An LM on one device. ``device=None`` means the card (it raises
    where there is none); tests pass ``device="cpu"``. Weights come from
    `init_params` with a `torch.Generator` on the device seeded with
    ``seed``, held in ``dtype`` (float32 masters, or a bfloat16 served
    copy whose router and shared output gate stay float32); calls run
    the functional entry points over `param_tree(self)` (the parameters
    do not require gradients: training runs the functional path)."""

    def __init__(self, cfg: LMConfig, device=None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        with torch.no_grad():
            register_tensors(self, flatten_params(
                init_params(cfg, gen, dtype=dtype)))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens):
        return forward(param_tree(self), self.cfg, tokens)

    def prefill(self, tokens):
        return prefill_step(param_tree(self), self.cfg, tokens)

    def init_cache(self, batch: int, max_len: int, mesh=None) -> dict:
        return init_cache(self.cfg, batch, max_len, device=self.device,
                          mesh=mesh)

    def decode(self, cache: dict, tokens, pos, mesh=None):
        return decode_step(param_tree(self), self.cfg, cache, tokens, pos,
                           mesh=mesh)


def params_to_numpy(params) -> dict:
    """The reference's nested dict of numpy float32 arrays, from an `LM`
    or a nested dict of tensors."""
    return tree_to_numpy(params)


def params_from_numpy(cfg: LMConfig, tree: dict, device=None,
                      dtype=torch.float32) -> LM:
    """An `LM` holding the weights of ``tree`` (the reference's nested
    `init_params` dict of numpy arrays) in ``dtype`` (`leaf_dtype`); a
    missing or extra key or a shape that differs raises."""
    return load_numpy_tree(LM(cfg, device=device, dtype=dtype),
                           param_defs(cfg), tree)
