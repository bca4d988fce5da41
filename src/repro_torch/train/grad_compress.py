"""Int8 gradient compression with error feedback, the reference package's
`train/grad_compress.py` in PyTorch.

quantize: g -> (int8 q, float32 scale), per-tensor absmax scaling and
round half to even, as the reference rounds. `compress_decompress` is the
simulation the train step runs (quantize, then dequantize); the residual
``g - dequant(q)`` is what error feedback would add to the next step.
`compressed_psum` is the int8 all-reduce in the port's collective form
(`distributed/collectives.py`): a function over the list of every shard's
tensor, returning every shard's result on its own device.
`compress_decompress_sharded` is the simulation over a leaf stored by
its `Spec` (`launch.mesh.Sharded`): the whole leaf's absmax, the max of
its blocks', sets one grid for every block, as the reference quantizes
its global array.
"""
from __future__ import annotations

import torch

from ..launch.mesh import Sharded


def quantize_int8(g: torch.Tensor):
    a = torch.max(torch.abs(g.to(torch.float32)))
    scale = torch.clamp(a, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(g: torch.Tensor, residual=None):
    """Returns (g_hat, new_residual). Error feedback: compress (g + r)."""
    if residual is not None:
        g = g.to(torch.float32) + residual
    q, s = quantize_int8(g)
    g_hat = dequantize_int8(q, s)
    return g_hat, g - g_hat


def compress_decompress_sharded(g: Sharded) -> Sharded:
    """`compress_decompress(g)[0]` of the whole leaf, block by block on
    each block's device: the blocks' absmax maxed on shard 0's device,
    then each block quantized onto that one grid and dequantized."""
    dev = g[0].device
    a = torch.stack([torch.max(torch.abs(g[k].to(torch.float32))).to(dev)
                     for k in g.owners()]).max()
    scale = torch.clamp(a, min=1e-12) / 127.0
    done: dict = {}
    out = []
    for b in g:
        if id(b) not in done:
            s = scale.to(b.device)
            q = torch.clamp(torch.round(b / s), -127, 127).to(torch.int8)
            done[id(b)] = dequantize_int8(q, s)
        out.append(done[id(b)])
    return g.like(out)


def compressed_psum(xs: list) -> list:
    """The int8 all-reduce over shards, ``xs`` one tensor per shard. The
    scales are max-reduced first, so every shard quantizes onto the same
    grid; the int8 payloads are summed in int32 (no overflow across
    shards) in shard order, on the first shard's device."""
    dev = xs[0].device
    amax = torch.stack([torch.clamp(torch.max(torch.abs(
        x.to(torch.float32))), min=1e-12).to(dev) for x in xs])
    scale = torch.max(amax) / 127.0
    total = None
    for x in xs:
        q = torch.clamp(torch.round(x / scale.to(x.device)), -127,
                        127).to(torch.int8)
        q = q.to(dev, torch.int32)
        total = q if total is None else total + q
    out = total.to(torch.float32) * scale
    return [out.to(x.device) for x in xs]
