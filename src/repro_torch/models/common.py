"""Shared model building blocks of the port. Only what its models use so
far: `trunc_normal`, the reference's `models/common.py:trunc_normal`, and
`gather_rows`, an embedding gather whose gradient is deterministic."""
from __future__ import annotations

import math

import torch


def trunc_normal(shape, generator: torch.Generator, scale: float = 1.0,
                 dtype=torch.float32) -> torch.Tensor:
    """``scale / sqrt(fan_in)`` times a standard normal truncated to
    [-2, 2], drawn from ``generator`` on its device. As in the reference,
    ``fan_in = shape[0]`` whatever the rank: for a CIN weight [K, H, M]
    that is K. Draws as `jax.random.truncated_normal(-2, 2)` does (the
    inverse CDF of a uniform on [erf(-2/sqrt 2), erf(2/sqrt 2)]), so the
    distribution is the same; the numbers differ from JAX's for one
    seed."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) >= 1 else 1
    std = scale / math.sqrt(max(fan_in, 1))
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(lo, hi, generator=generator)
    x = math.sqrt(2.0) * torch.erfinv(u)
    # keep the open interval (-2, 2) in float32, as the reference clips
    edge = torch.nextafter(torch.tensor(2.0), torch.tensor(0.0)).item()
    x = x.clamp(-edge, edge)
    return (std * x).to(dtype)


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums each id's rows by sorting: a
    stable sort of the ids, then `torch.segment_reduce` over each run of
    equal ids (one sequential sum per row, in the order the ids came),
    written into a zero table. `index_select`'s own backward scatters
    with float atomics on the card, so two runs could differ in their
    last bits; this one gives the same bits every run."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        order = torch.argsort(ids, stable=True)
        uniq, counts = torch.unique_consecutive(ids[order],
                                                return_counts=True)
        sums = torch.segment_reduce(grad[order], "sum", lengths=counts,
                                    unsafe=True)
        out = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        out[uniq] = sums
        return out, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (int64 [n]) of ``table`` [R, ...]: `index_select`,
    with a deterministic gradient where ``table`` requires one."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherRows.apply(table, ids)
    return table.index_select(0, ids)
