"""Mixture-of-Experts FFN of the LM family, the reference's
`models/moe.py`: top-k routing with capacity-based dispatch (GShard /
Switch style), SwiGLU experts, optional shared experts with a sigmoid
output gate, and the load-balance auxiliary loss.

Dispatch is the reference's, slot for slot. The tokens split into
``dispatch_shards`` (SD) equal shards; a token's slot in its expert's
buffer is its rank among the shard's tokens that chose that expert,
routing choice by routing choice (a one-hot cumsum per choice, counts
carried from the earlier choices). A shard holds ``capL = max(cap //
SD, 4)`` slots an expert; a token whose slot is past them is dropped
for that choice, so SD decides which tokens overflow and is part of the
semantics. Each kept token lands in its own slot (``index_put``, no
float atomic; dropped tokens land in a trash slot that is cut off, so
no step waits on the host), the experts run as one batched matmul
over [Ep, SD * capL, D], and the K choices are combined in order in the
activations' dtype.

The expert contractions keep the reference's float32 outputs from
bfloat16 operands (`attention.bf16_matmul_f32` where the operands are
bfloat16; a plain float32 matmul where they are float32).

`moe_apply` takes the route the reference's takes: without a mesh, or
on a mesh with no ``cfg.ep_axis`` ("model") axis, `moe_ffn_chunked`;
on one with it, `moe_ffn_replicated_ep`, replicated-token expert
parallelism over a `launch.mesh.ServingMesh`. There the tokens split
over the mesh's dispatch axes, and each "model" shard routes its tokens
itself, keeps those that chose one of its ``EL = Ep / MP`` experts in a
capacity buffer of its own (``capL = min(NL, max(int(NL * K / Ep *
cf), 8))``, so its answers are not `moe_ffn`'s), runs its experts on
its device and contributes a partial output; the partials are summed
over "model" (`distributed.collectives.reduce_sum`). Expert leaves may
come whole, and then each shard takes its slice, or stored by their
`Spec`s (`launch.mesh.Sharded`), and then each shard gathers its
experts' blocks (`distributed.collectives.gather_leaf`: nothing moves
where its "model" block is whole on its device). The tokens may come as
the data shards' row blocks of a sharded train step, each on its own
device; the route then gives the blocks back the same way.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.collectives import gather_leaf, reduce_sum
from ..launch.mesh import Sharded
from .attention import bf16_matmul_f32

CHUNK_MIN_TOKENS = 8192   # moe_ffn_chunked splits only above this a chunk


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    shared_gate: bool = False
    capacity_factor: float = 1.25
    pad_experts_to: int | None = None  # EP divisibility padding
    aux_loss_coef: float = 0.01
    # run the token stream through the experts in this many chunks (the
    # dispatch buffers shrink by the same factor); applied only when each
    # chunk keeps >= CHUNK_MIN_TOKENS tokens
    token_chunks: int = 1
    # per-shard capacity dispatch: slots are counted within each of this
    # many equal token shards (it must divide the token count, else 1)
    dispatch_shards: int = 1
    # the mesh axes `moe_ffn_replicated_ep` splits the tokens over (those
    # the mesh has) and shards the experts over
    dispatch_axes: tuple = ("data",)
    ep_axis: str = "model"

    @property
    def padded_experts(self) -> int:
        return self.pad_experts_to or self.num_experts


def expert_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, c, d] x [E, d, f] -> float32 [E, c, f]: bf16 products summed in
    float32 for bfloat16 operands, a float32 matmul otherwise."""
    if a.dtype == torch.bfloat16:
        return bf16_matmul_f32(a, w)
    return torch.matmul(a.to(torch.float32), w.to(torch.float32))


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Router probabilities [N, Ep] (float32; padded experts exactly 0)
    and the top-k (gates [N, K] renormalised, expert ids [N, K]). Ties
    go to the lower expert id first, as `jax.lax.top_k` orders them: a
    stable descending sort."""
    E, Ep, K = cfg.num_experts, cfg.padded_experts, cfg.top_k
    logits = x.to(torch.float32) @ router.to(torch.float32)
    if Ep != E:
        logits = torch.cat([logits[:, :E], torch.full_like(logits[:, E:],
                                                           -1e30)], dim=1)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices[:, :K]
    gates = torch.gather(probs, 1, order)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, order


def one_hot(e: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot of ids ``e`` over ``n`` classes (`F.one_hot` checks
    its ids' range on the host: a sync on the card)."""
    return (e[..., None] == torch.arange(n, device=e.device)).to(torch.int32)


def dispatch_plan(idx: torch.Tensor, cfg: MoEConfig):
    """The reference's capacity dispatch for expert ids ``idx`` [N, K]:
    (SD, capL, slots [K, SD, NL], keeps [K, SD, NL])."""
    N, K = idx.shape
    Ep = cfg.padded_experts
    SD = cfg.dispatch_shards if (cfg.dispatch_shards > 1
                                 and N % cfg.dispatch_shards == 0) else 1
    cap = max(int(N * K / Ep * cfg.capacity_factor), 4)
    capL = max(cap // SD, 4)
    NL = N // SD
    prev = torch.zeros((SD, Ep), dtype=torch.int32, device=idx.device)
    slots, keeps = [], []
    for j in range(K):
        e = idx[:, j].reshape(SD, NL)
        oh = one_hot(e, Ep)                                    # [SD, NL, Ep]
        pos = torch.cumsum(oh, dim=1, dtype=torch.int32)
        slot = torch.gather(pos, 2, e[..., None])[..., 0] - 1 \
            + torch.gather(prev, 1, e)
        slots.append(slot)
        keeps.append(slot < capL)
        prev = prev + oh.sum(1, dtype=torch.int32)
    return SD, capL, torch.stack(slots), torch.stack(keeps)


def moe_ffn(x: torch.Tensor, wp: dict, cfg: MoEConfig):
    """x: [N, D] tokens; wp: router / w_gate / w_up / w_down (+ shared).
    Returns (y [N, D] in x's dtype, aux loss, a float32 scalar). Expert
    weights carry the padded expert count; padded experts get no
    routing mass."""
    N, D = x.shape
    E, Ep, K = cfg.num_experts, cfg.padded_experts, cfg.top_k
    probs, gates, idx = route(x, wp["router"], cfg)
    SD, capL, slots, keeps = dispatch_plan(idx, cfg)
    NL = N // SD
    dev = x.device
    shard = torch.arange(SD, device=dev)[:, None].expand(SD, NL)
    xs = x.reshape(SD, NL, D)
    # a dropped token goes to a trash slot capL, cut off below (no mask
    # indexing: no host sync)
    buf = x.new_zeros((SD, Ep, capL + 1, D))
    for j in range(K):
        e, sl, keep = idx[:, j].reshape(SD, NL), slots[j], keeps[j]
        buf = buf.index_put((shard, e, torch.where(keep, sl, capL)), xs)

    buff = buf[:, :, :capL].permute(1, 0, 2, 3).reshape(Ep, SD * capL, D)
    dt = x.dtype
    g = expert_matmul(buff, wp["w_gate"].to(dt))
    u = expert_matmul(buff, wp["w_up"].to(dt))
    h = (F.silu(g) * u).to(dt)
    yb = expert_matmul(h, wp["w_down"].to(dt)).to(dt)
    yb = yb.reshape(Ep, SD, capL, D).permute(1, 0, 2, 3)    # [SD,Ep,capL,D]

    y = torch.zeros_like(xs)
    gates_s = gates.reshape(SD, NL, K)
    for j in range(K):
        e, sl, keep = idx[:, j].reshape(SD, NL), slots[j], keeps[j]
        ytok = yb[shard, e, sl.clamp(0, capL - 1)]
        y = y + torch.where(keep[..., None], ytok, 0) \
            * gates_s[..., j:j + 1].to(dt)
    y = y.reshape(N, D)

    # Switch-style load-balance aux loss over the real experts
    me = probs[:, :E].mean(0)
    fe = one_hot(idx[:, 0], Ep).to(torch.float32)[:, :E].mean(0)
    aux = cfg.aux_loss_coef * E * torch.sum(me * fe)

    if cfg.num_shared:
        gs = F.silu(x @ wp["shared_gate_w"].to(dt))
        us = x @ wp["shared_up"].to(dt)
        ys = (gs * us) @ wp["shared_down"].to(dt)
        if cfg.shared_gate:
            sg = torch.sigmoid(x.to(torch.float32)
                               @ wp["shared_out_gate"].to(torch.float32))
            ys = ys * sg.to(dt)
        y = y + ys
    return y, aux


def moe_ffn_chunked(x: torch.Tensor, wp: dict, cfg: MoEConfig):
    """`moe_ffn` over ``cfg.token_chunks`` equal chunks of the tokens in
    order, where N >= token_chunks * CHUNK_MIN_TOKENS and the chunks
    divide N (else one call); the aux loss is the chunks' mean. Under
    autograd each chunk is recomputed in the backward, as the
    reference's ``jax.checkpoint`` does."""
    N = x.shape[0]
    nc = cfg.token_chunks
    if nc <= 1 or N < nc * CHUNK_MIN_TOKENS or N % nc != 0:
        return moe_ffn(x, wp, cfg)

    def body(xc, *ws):
        return moe_ffn(xc, dict(zip(names, ws)), cfg)

    names = sorted(wp)
    ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for xc in x.reshape(nc, N // nc, -1):
        if torch.is_grad_enabled():
            yc, a = checkpoint(body, xc, *(wp[k] for k in names),
                               use_reentrant=False)
        else:
            yc, a = body(xc, *(wp[k] for k in names))
        ys.append(yc)
        aux = aux + a
    return torch.cat(ys), aux / nc


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _ep_coords(mesh, cfg: MoEConfig):
    """(MP, DA, per shard k its (token shard d, expert shard m)): the
    "model" axis's size, the token shards over the dispatch axes the
    mesh has, row-major in ``cfg.dispatch_axes`` order."""
    MP = mesh.axis_size(cfg.ep_axis)
    da = tuple(a for a in cfg.dispatch_axes if a in mesh.axis_names)
    DA = math.prod(mesh.axis_size(a) for a in da)
    dm = []
    for k in range(mesh.size):
        c = mesh.coords(k)
        d = 0
        for a in da:
            d = d * mesh.axis_size(a) + c[a]
        dm.append((d, c[cfg.ep_axis]))
    return MP, DA, dm


def ep_capacity(NL: int, cfg: MoEConfig) -> int:
    """A replicated-EP shard's slots an expert for NL local tokens: an
    inference-safe floor of 8, and at most NL."""
    return min(NL, max(int(NL * cfg.top_k / cfg.padded_experts
                           * cfg.capacity_factor), 8))


def ep_slots(idx: torch.Tensor, cfg: MoEConfig, capL: int, e_lo: int,
             EL: int) -> list:
    """One replicated-EP shard's dispatch of its tokens' expert ids
    ``idx`` [NL, K], owning experts ``e_lo .. e_lo + EL - 1``: per choice
    j, (local expert el, slot sl, keep) [NL] each. A slot is the token's
    rank among the shard's tokens that chose that expert, choice by
    choice (counts carried), whatever shard owns the expert; a choice is
    kept where its slot is below ``capL`` and its expert is local, and a
    dropped one points at the trash (EL, capL)."""
    e = idx.t()                                                 # [K, NL]
    oh = one_hot(e, cfg.padded_experts)                         # [K, NL, Ep]
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32)
    # counts carried from the earlier choices: an exclusive cumsum over K
    prev = torch.cumsum(oh.sum(1, dtype=torch.int32), dim=0,
                        dtype=torch.int32) - oh.sum(1, dtype=torch.int32)
    slot = torch.gather(pos, 2, e[..., None])[..., 0] - 1 \
        + torch.gather(prev, 1, e)
    keep = (slot < capL) & (e >= e_lo) & (e < e_lo + EL)
    el = torch.where(keep, e - e_lo, EL)
    sl = torch.where(keep, slot, capL)
    return [(el[j], sl[j], keep[j]) for j in range(e.shape[0])]


def _leaf_on(leaf, device, dtype=None, shard=None) -> torch.Tensor:
    """A non-expert leaf on ``device``: a `Sharded` one gathered there
    in ``dtype`` (None: as stored) for ``shard`` (`gather_leaf`), a
    tensor moved as it is."""
    if isinstance(leaf, Sharded):
        return gather_leaf(leaf, device, dtype, shard=shard)
    return leaf.to(device)


def moe_ffn_replicated_ep(x, wp: dict, cfg: MoEConfig, mesh=None,
                          dtype=None):
    """Replicated-token expert parallelism, slot for slot the reference's
    `moe_ffn_replicated_ep`. x: [N, D] on one device, or the list of the
    DA token shards' blocks [N / DA, D], each on its own device (a
    sharded train step's data shards); ``mesh`` a `ServingMesh` with a
    ``cfg.ep_axis`` axis. The tokens split into DA equal shards over the
    dispatch axes the mesh has; each (token shard, "model" shard)
    routes its NL tokens on its device, keeps the choices of its EL
    local experts that fit ``capL`` slots (overflow and non-local
    choices are dropped), runs its experts and gives a partial output;
    the partials are summed over "model" on the token shard's device
    (x's, for a whole x: the token shards joined there in order),
    ``aux`` averaged over the token shards (the reference's ``pmean``),
    and the shared experts added after the sum. Shards that differ only
    on other axes hold the same work, run once. `Sharded` leaves are
    gathered where they are used, cast to ``dtype``. Falls back to
    `moe_ffn` without a mesh or a "model" axis, where Ep % MP != 0, or
    where N % DA != 0, as the reference does; split tokens or split
    experts never fall back (that would join them on one device): they
    raise. Returns (y, aux), y as x came (a tensor [N, D] in x's dtype,
    or the list of blocks)."""
    blocks = isinstance(x, (list, tuple))
    E, Ep = cfg.num_experts, cfg.padded_experts
    if mesh is None or cfg.ep_axis not in mesh.axis_names:
        if blocks or any(isinstance(wp[k], Sharded) for k in wp):
            raise ValueError("split tokens or experts need a mesh with "
                             f"the {cfg.ep_axis!r} axis")
        return moe_ffn(x, wp, cfg)
    MP, DA, dm = _ep_coords(mesh, cfg)
    xs = list(x) if blocks else None
    N = sum(b.shape[0] for b in xs) if blocks else x.shape[0]
    D = (xs[0] if blocks else x).shape[1]
    if Ep % MP != 0 or N % DA != 0 or (blocks and len(xs) != DA):
        if blocks or any(isinstance(wp[k], Sharded) for k in wp):
            raise ValueError(f"{Ep} experts over {MP} shards, {N} tokens "
                             f"over {DA}: the expert-parallel route does "
                             "not split them, and split leaves never join")
        return moe_ffn(x, wp, cfg)
    EL = Ep // MP
    NL = N // DA
    capL = ep_capacity(NL, cfg)
    dt = (xs[0] if blocks else x).dtype
    home = [xs[d].device if blocks else x.device for d in range(DA)]
    first: dict = {}
    for k, key in enumerate(dm):
        first.setdefault(key, k)
    parts: dict = {}
    for (d, m), k in sorted(first.items()):
        dev = mesh.devices[k]
        # a copy of its own on every shard, on one card as on several:
        # the tokens' gradient is then the same sum of the shards' parts
        x_l = (xs[d] if blocks else x[d * NL:(d + 1) * NL]).to(dev,
                                                               copy=True)
        probs, gates, idx = route(
            x_l, _leaf_on(wp["router"], dev, dtype, shard=k), cfg)
        e_lo = m * EL
        picks = ep_slots(idx, cfg, capL, e_lo, EL)
        # every kept choice has a slot of its own; dropped ones go to a
        # trash (expert EL, slot capL), cut off
        buf = x_l.new_zeros((EL + 1, capL + 1, D)).index_put(
            (torch.cat([p[0] for p in picks]),
             torch.cat([p[1] for p in picks])),
            x_l.repeat(len(picks), 1))
        w = {}
        for n in EXPERT_LEAVES:
            leaf = wp[n]
            if isinstance(leaf, Sharded):
                leaf = gather_leaf(leaf, dev, dtype,
                                   where={cfg.ep_axis: m}, shard=k)
            else:
                leaf = leaf[e_lo:e_lo + EL]
            w[n] = leaf.to(device=dev, dtype=dt)
        xb = buf[:EL, :capL]
        g = expert_matmul(xb, w["w_gate"])
        u = expert_matmul(xb, w["w_up"])
        hh = (F.silu(g) * u).to(dt)
        yb = expert_matmul(hh, w["w_down"]).to(dt)
        y = torch.zeros_like(x_l)
        for j, (el, sl, keep) in enumerate(picks):
            ytok = yb[el.clamp(0, EL - 1), sl.clamp(0, capL - 1)]
            y = y + torch.where(keep[:, None], ytok, 0) \
                * gates[:, j:j + 1].to(dt)
        me = probs[:, :E].mean(0)
        fe = one_hot(idx[:, 0], Ep).to(torch.float32)[:, :E].mean(0)
        aux = cfg.aux_loss_coef * E * torch.sum(me * fe)
        parts[(d, m)] = (y, aux)
    ys = [reduce_sum([parts[(d, m)][0] for m in range(MP)], home[d])
          for d in range(DA)]
    aux = reduce_sum([parts[(d, 0)][1] for d in range(DA)], home[0]) / DA
    if not blocks:
        xs, ys = [x], [torch.cat(ys) if DA > 1 else ys[0]]
    if cfg.num_shared:
        ys = [y + _shared_ffn(xd, wp, cfg, dtype, first[(d, 0)])
              for d, (y, xd) in enumerate(zip(ys, xs))]
    return (ys if blocks else ys[0]), aux


def _shared_ffn(x: torch.Tensor, wp: dict, cfg: MoEConfig, dtype=None,
                shard=None) -> torch.Tensor:
    """The shared experts (and their sigmoid output gate) on x's
    device, their leaves gathered for ``shard``."""
    dt = x.dtype
    sw = {n: _leaf_on(wp[n], x.device, dtype, shard) for n in
          ("shared_gate_w", "shared_up", "shared_down", "shared_out_gate")
          if n in wp}
    gs = F.silu(x @ sw["shared_gate_w"].to(dt))
    us = x @ sw["shared_up"].to(dt)
    ys = (gs * us) @ sw["shared_down"].to(dt)
    if cfg.shared_gate:
        sg = torch.sigmoid(x.to(torch.float32)
                           @ sw["shared_out_gate"].to(torch.float32))
        ys = ys * sg.to(dt)
    return ys


def moe_apply(x, wp: dict, cfg: MoEConfig, mesh=None, dtype=None):
    """The MoE FFN of a layer, routed as the reference's `moe_apply`
    routes it under its ambient mesh: `moe_ffn_replicated_ep` on a mesh
    with a ``cfg.ep_axis`` axis (``dtype``: the one its `Sharded` leaves
    are gathered in), else `moe_ffn_chunked`."""
    if mesh is not None and cfg.ep_axis in mesh.axis_names:
        return moe_ffn_replicated_ep(x, wp, cfg, mesh, dtype)
    return moe_ffn_chunked(x, wp, cfg)
