"""Shared model building blocks of the port. Only what its models use so
far: `trunc_normal`, the reference's `models/common.py:trunc_normal`."""
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
