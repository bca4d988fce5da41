"""Attention of the LM family, the reference's `models/attention.py`: GQA
/ MHA with causal or decode masking and an optional sliding window, and
the reference's plain oracle `kernels/ref.py::flash_attention_ref`.

The reference's attention is jnp einsums outside any Pallas kernel, so
it stays PyTorch tensor ops here. Its numerics are kept: ``q * scale``,
``k``, the probabilities and ``v`` are rounded to bfloat16 and every
contraction sums their products in float32 (XLA's
``preferred_element_type=float32``), so logits and outputs are float32
sums of bfloat16 products whatever the compute dtype. `bf16_matmul_f32`
is that contraction: on the card, where no gradient is wanted, one
`torch.bmm` with ``out_dtype=torch.float32`` (cuBLAS, bf16 operands,
float32 accumulation and output); elsewhere the operands are upcast to
float32 first, which keeps every product exact and changes only the
order of the sums.
"""
from __future__ import annotations

import torch

from ..distributed.collectives import pmax, psum, reduce_sum, replicate

NEG_INF = -1e30   # the reference's mask value


def bf16_matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over matching leading (batch) axes, both rounded to
    bfloat16, the products summed in float32: [..., m, k] x [..., k, p]
    -> float32 [..., m, p] (see the module docstring for the two
    routes)."""
    lead = a.shape[:-2]
    a3 = a.to(torch.bfloat16).reshape((-1,) + tuple(a.shape[-2:]))
    b3 = b.to(torch.bfloat16).reshape((-1,) + tuple(b.shape[-2:]))
    if a3.is_cuda and not (torch.is_grad_enabled()
                           and (a3.requires_grad or b3.requires_grad)):
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
    else:
        out = torch.bmm(a3.to(torch.float32), b3.to(torch.float32))
    return out.reshape(tuple(lead) + (a.shape[-2], b.shape[-1]))


def gqa_attention(q, k, v, *, causal: bool = True, q_offset=0,
                  kv_valid_len=None, window: int | None = None,
                  q_chunk: int | None = 512):
    """q: [B, T, Hq, Dh]; k / v: [B, S, Hkv, Dh]; Hq % Hkv == 0. Returns
    [B, T, Hq, Dh] in q's dtype.

    q_offset: absolute position of q[0] (decode: the cache write
      position), an int or a 0-d tensor.
    kv_valid_len: mask kv positions >= this (decode over a preallocated
      cache).
    window: sliding-window size (attend to the last `window` positions).
    q_chunk: where T > q_chunk and T % q_chunk == 0, the queries go in
      blocks of q_chunk, so the [T, S] score matrix is never held beyond
      one block (each block's softmax is whole: exact).
    """
    T = q.shape[1]
    if q_chunk is not None and T > q_chunk and T % q_chunk == 0:
        outs = [_gqa_attention_dense(q[:, o:o + q_chunk], k, v,
                                     causal=causal, q_offset=q_offset + o,
                                     kv_valid_len=kv_valid_len,
                                     window=window)
                for o in range(0, T, q_chunk)]
        return torch.cat(outs, dim=1)
    return _gqa_attention_dense(q, k, v, causal=causal, q_offset=q_offset,
                                kv_valid_len=kv_valid_len, window=window)


def _gqa_attention_dense(q, k, v, *, causal: bool = True, q_offset=0,
                         kv_valid_len=None, window: int | None = None):
    """One block of queries against all of k / v. A decode step (T = 1)
    goes a batch row at a time: a row's keys ``k[b].permute(1, 2, 0)``
    [Hkv, Dh, S] and values [Hkv, S, Dh] are strided views of the cache,
    which a batched matmul reads in place (no cache bytes copied); any
    other call takes all rows in one product (k and v copied once into
    [B * Hkv, ...], small beside the [T, S] scores)."""
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = Dh ** -0.5
    dev = q.device
    # python-int offsets enter as kernel arguments: no host-to-card copy
    qpos = torch.arange(T, device=dev)[:, None] + q_offset
    kpos = torch.arange(S, device=dev)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    if kv_valid_len is not None:
        mask &= kpos < kv_valid_len
    # [B, Hkv, G*T, Dh] rows ordered (g, t); keys [B, Hkv, Dh, S] and
    # values [B, Hkv, S, Dh] as views
    qs = (q * scale).to(torch.bfloat16).reshape(B, T, Hkv, G, Dh) \
        .permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * T, Dh)
    kt = k.to(torch.bfloat16).permute(0, 2, 3, 1)
    vb = v.to(torch.bfloat16).permute(0, 2, 1, 3)
    rows = [slice(b, b + 1) for b in range(B)] if T == 1 else [slice(None)]
    outs = []
    for r in rows:
        logits = bf16_matmul_f32(qs[r], kt[r])           # [., Hkv, G*T, S]
        logits = logits.view(-1, Hkv, G, T, S).masked_fill_(~mask, NEG_INF)
        p = torch.softmax(logits, dim=-1).view(-1, Hkv, G * T, S)
        del logits
        outs.append(bf16_matmul_f32(p, vb[r]))           # [., Hkv, G*T, Dh]
        del p
    out = torch.cat(outs).view(B, Hkv, G, T, Dh).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, Hq, Dh).to(q.dtype)


def gqa_attention_sharded(q, k_blocks, v_blocks, *, q_offset=0,
                          kv_valid_len=None, window: int | None = None):
    """`gqa_attention` (not causal) over a KV cache split along its
    sequence axis into contiguous blocks, one a shard in order, each on
    its own device: q [B, T, Hq, Dh] on one device; k_blocks / v_blocks
    [B, S_local, Hkv, Dh]. Returns [B, T, Hq, Dh] in q's dtype on q's
    device. No block leaves its device.

    The numbers are the reference's `_gqa_attention_dense` as GSPMD
    partitions it over a sequence-sharded cache: each shard's logits are
    its bf16 ``q * scale`` against its bf16 keys summed in float32; the
    max and the sum of ``exp(l - m)`` are global (float32, combined over
    the shards); ``p = exp(l - m) / denom`` is rounded to bf16 after
    that normalisation; each shard sums ``p @ v`` over its block in
    float32, and one sum over the shards gives the output. This is not
    `distributed.collectives.distributed_lse_decode`, whose float32
    probabilities are normalised only after the partial outputs are
    summed: both share its combines (`pmax`, `psum`), and only the
    arithmetic between them differs. A decode step (T = 1) goes a batch
    row at a time over strided views of each block, as the dense
    version's does."""
    B, T, Hq, Dh = q.shape
    Hkv = k_blocks[0].shape[2]
    G = Hq // Hkv
    devs = [k.device for k in k_blocks]
    qs = (q * Dh ** -0.5).to(torch.bfloat16).reshape(B, T, Hkv, G, Dh) \
        .permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * T, Dh)
    q_on = replicate(qs, devs)
    masks, off = [], 0
    for k in k_blocks:
        S_l = k.shape[1]
        qpos = torch.arange(T, device=k.device)[:, None] + q_offset
        kpos = torch.arange(off, off + S_l, device=k.device)[None, :]
        mask = torch.ones((T, S_l), dtype=torch.bool, device=k.device)
        if window is not None:
            mask &= kpos > qpos - window
        if kv_valid_len is not None:
            mask &= kpos < kv_valid_len
        masks.append(~mask)
        off += S_l
    rows = [slice(b, b + 1) for b in range(B)] if T == 1 else [slice(None)]

    def by_row(a, b):
        """``bf16_matmul_f32(a, b)`` a batch row at a time, joined."""
        outs = [bf16_matmul_f32(a[r], b[r]) for r in rows]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    logits = []
    for qk, k, nm in zip(q_on, k_blocks, masks):
        lg = by_row(qk, k.to(torch.bfloat16).permute(0, 2, 3, 1))
        lg.view(B, Hkv, G, T, lg.shape[-1]).masked_fill_(nm, NEG_INF)
        logits.append(lg)                               # [B, Hkv, G*T, S_l]
    m = pmax([lg.amax(-1, keepdim=True) for lg in logits])
    e = [torch.exp(lg - mk) for lg, mk in zip(logits, m)]
    del logits
    denom = psum([ek.sum(-1, keepdim=True) for ek in e])
    parts = [by_row(ek / dk, v.to(torch.bfloat16).permute(0, 2, 1, 3))
             for ek, dk, v in zip(e, denom, v_blocks)]
    del e
    out = reduce_sum(parts, q.device)                   # [B, Hkv, G*T, Dh]
    out = out.view(B, Hkv, G, T, Dh).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, Hq, Dh).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """Plain softmax attention oracle, GQA-aware, in float32 (the
    reference's `kernels/ref.py::flash_attention_ref`).

    q: [B, Hq, Tq, Dh], k / v: [B, Hkv, Tk, Dh]; Hq % Hkv == 0. A causal
    query i attends to keys j <= i + (Tk - Tq)."""
    B, Hq, Tq, Dh = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = (Dh ** -0.5) if scale is None else scale
    qf = q.to(torch.float32).reshape(B, Hkv, G, Tq, Dh)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    if causal:
        Tk = k.shape[2]
        mask = (torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
                >= torch.arange(Tk, device=q.device)[None, :])
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return out.reshape(B, Hq, Tq, Dh).to(q.dtype)
