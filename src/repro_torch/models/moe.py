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

`moe_apply` always takes the `moe_ffn_chunked` route, as the reference
does without a device mesh. The reference's `moe_ffn_replicated_ep`
(expert parallelism under a JAX mesh with a "model" axis, with a
per-shard capacity of its own) has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    # the reference's mesh axes; no meaning in the port, kept so the two
    # packages' configs compare equal
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


def moe_apply(x: torch.Tensor, wp: dict, cfg: MoEConfig):
    """The MoE FFN of a layer: always `moe_ffn_chunked` (the reference's
    choice without a mesh; see the module docstring)."""
    return moe_ffn_chunked(x, wp, cfg)
