"""The one recompute for a region that spans cards: `torch.utils.
checkpoint` keeps no activations and recomputes the region where a saved
tensor is first unpacked, and with the region on several cards two
cards' autograd threads can unpack at once and both recompute. Here the
region is one autograd node that keeps only its inputs; its backward
recomputes it once, on the thread that runs that node, and takes its
vector-Jacobian product there too, so the gradients within the region
add in a fixed order on any number of cards. The graph family's layer
blocks over a mesh (`models.gnn`, `models.nequip`) and the LM's MoE
layer over a mesh (`models.transformer`: every data shard's attention,
then the experts on their own cards) both go through it.

Whatever the region reads must come in through its inputs to get a
gradient: `leaf_blocks` hands a region's `Sharded` leaves in as their
block tensors and rebuilds them inside.
"""
from __future__ import annotations

import torch


class _Recompute(torch.autograd.Function):
    """See `recompute`."""

    @staticmethod
    def forward(ctx, fn, grad, *xs):
        ctx.fn = fn
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*xs)
        # in the caller's grad mode, as the backward reruns it: an op
        # that picks its route by grad mode (the attention's bf16
        # product) then gives the same numbers both times; the graph it
        # records lives until this returns
        with torch.set_grad_enabled(grad):
            return tuple(o.detach() for o in fn(*xs))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        xs = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.fn(*xs)
        pairs = [(o, g) for o, g in zip(outs, gs) if g is not None]
        if not pairs:
            return (None,) * (2 + len(xs))
        # on this thread alone: a tensor read by several cards' ops then
        # adds its gradients in one order, not in the order the cards'
        # autograd threads happen to deliver them
        with torch.autograd.set_multithreading_enabled(False):
            got = torch.autograd.grad([o for o, _ in pairs], xs,
                                      [g for _, g in pairs],
                                      allow_unused=True)
        return (None, None) + tuple(got)


def recompute(fn, *xs) -> tuple:
    """``fn(*xs)`` (float tensors in, a tuple of tensors out) with only
    its inputs kept for the backward, which recomputes it once and takes
    its vector-Jacobian product. Whatever ``fn`` reads must come in
    through ``xs`` to get a gradient."""
    return _Recompute.apply(fn, torch.is_grad_enabled(), *xs)


def leaf_blocks(leaves: dict) -> tuple:
    """(the distinct tensors of the `Sharded` ``leaves``' blocks, in
    sorted key order, then block order; ``rebuild``): ``rebuild(ts)``
    gives the same dict of `Sharded` leaves over the tensors ``ts`` in
    that order. A tensor that several shards share goes in once."""
    keys = sorted(leaves)
    flat, slot, index = [], {}, []
    for k in keys:
        idx = []
        for b in leaves[k]:
            if id(b) not in slot:
                slot[id(b)] = len(flat)
                flat.append(b)
            idx.append(slot[id(b)])
        index.append(idx)

    def rebuild(ts) -> dict:
        return {k: leaves[k].like([ts[i] for i in idx])
                for k, idx in zip(keys, index)}

    return flat, rebuild
