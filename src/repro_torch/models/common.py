"""Shared model building blocks of the port: `trunc_normal`, the
reference's `models/common.py:trunc_normal`; the LM family's `rms_norm`,
`rope_angles`, `apply_rope`, `swiglu`, `mlp` and `count_params`;
`cross_entropy_loss`, its `cross_entropy_loss`; the segment backend the graph models and the
embedding gradient share; and the helpers that carry a nested parameter
tree between numpy and a module.

The segment backend replaces `jax.ops.segment_sum` / `segment_max` and
the gathers ``x[ids]`` around them. A `SegmentPlan` sorts the ids once
(stably) and splits every segment into runs of at most `SEGMENT_RUN`
rows; a reduction sums each run in order, then the runs of a segment in
order, level by level (`torch.segment_reduce` over lengths, one thread a
run and column), so a long segment (a padded block's sink node) is not
one long serial sum, and no float atomic is ever used: every run gives
the same bits, on the card too. `segment_sum` and `segment_gather` are a
pair of `torch.autograd.Function`s whose backwards are each other (the
gather's gradient is the segment sum by the same ids, the sum's is the
gather), so they differentiate any number of times. `segment_max` /
`segment_min` split the gradient evenly among ties, as JAX does, and
leave an empty segment at ``-inf`` / ``+inf``. Ids outside
``[0, num_segments)`` are dropped by the reductions, as JAX drops them,
and gather zeros."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

SEGMENT_RUN = 64   # rows a reduction sums serially before a next level


def trunc_normal(shape, generator: torch.Generator, scale: float = 1.0,
                 dtype=torch.float32, fan_in: int | None = None
                 ) -> torch.Tensor:
    """``scale / sqrt(fan_in)`` times a standard normal truncated to
    [-2, 2], drawn from ``generator`` on its device. As in the reference,
    ``fan_in = shape[0]`` whatever the rank: for a CIN weight [K, H, M]
    that is K. A caller that draws one slice of a larger leaf at a time
    passes the whole leaf's ``fan_in``. Draws as
    `jax.random.truncated_normal(-2, 2)` does (the inverse CDF of a
    uniform on [erf(-2/sqrt 2), erf(2/sqrt 2)]), so the distribution is
    the same; the numbers differ from JAX's for one seed."""
    shape = tuple(shape)
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 1 else 1
    std = scale / math.sqrt(max(fan_in, 1))
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(lo, hi, generator=generator)
    # in place: a layer slice of a full-width expert leaf is 4.2 GB
    x = u.erfinv_().mul_(math.sqrt(2.0))
    # keep the open interval (-2, 2) in float32, as the reference clips
    edge = torch.nextafter(torch.tensor(2.0), torch.tensor(0.0)).item()
    return x.clamp_(-edge, edge).mul_(std).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm over the last axis in float32, rounded back to ``x``'s
    dtype, then times ``scale`` (promoted as the reference promotes)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def rope_angles(positions, d_head: int, theta: float = 10000.0,
                dtype=torch.float32):
    """positions: [...] int -> (sin, cos) of shape [..., d_head // 2] in
    ``dtype``; the angles in float32."""
    positions = torch.as_tensor(positions)
    half = d_head // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang).to(dtype), torch.cos(ang).to(dtype)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: [..., T, H, Dh]; sin / cos: [..., T, Dh // 2], broadcast over
    the heads (the rotate-half convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, w_gate, w_up, w_down):
    """LLaMA-style gated MLP. x: [..., D]."""
    g = torch.nn.functional.silu(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def mlp(params_prefix, x, ws, act=torch.relu):
    """Plain MLP given a list of (w, b); ``act`` between layers."""
    del params_prefix
    for i, (w, b) in enumerate(ws):
        x = x @ w + b
        if i + 1 < len(ws):
            x = act(x)
    return x


def count_params(tree) -> int:
    """Elements over the leaves of a nested container of tensors or
    arrays."""
    from ..train.tree import tree_leaves
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)))


def cross_entropy_loss(logits: torch.Tensor, labels, z_loss: float = 0.0
                       ) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0 (the others are masked),
    with the reference's optional ``z_loss * lse**2``; every reduction in
    float32, whatever the logits' dtype."""
    total, count = cross_entropy_sums(logits, labels, z_loss)
    return total / count.clamp_min(1.0)


def cross_entropy_sums(logits: torch.Tensor, labels, z_loss: float = 0.0):
    """(the masked sum of the token losses, the count of labels >= 0),
    both float32 scalars: a batch's row blocks add theirs to a global
    mean."""
    labels = torch.as_tensor(labels, device=logits.device)
    mask = (labels >= 0).to(torch.float32)
    labels_c = labels.clamp_min(0).long()
    lf = logits.to(torch.float32)
    m = lf.detach().amax(dim=-1)
    lse = m + torch.log(torch.exp(lf - m[..., None]).sum(-1))
    onehot = torch.arange(logits.shape[-1], device=logits.device) \
        == labels_c[..., None]
    ll = torch.where(onehot, lf, 0.0).sum(-1)
    loss = (lse - ll) * mask
    if z_loss:
        loss = loss + z_loss * (lse * mask) ** 2
    return loss.sum(), mask.sum()


# ---------------------------------------------------------- segment backend
class SegmentPlan:
    """The ids of a segment reduction (or of a gather), sorted once.

    ``ids`` [n] int: the segment of each row; ``num_segments`` S. Ids
    outside [0, S) go to a trash segment S that reductions drop;
    ``trashed`` is their mask, or None where there is none. ``order``
    is the stable sort of the ids; ``levels`` the run lengths of each
    reduction level (the last one has S + 1 entries, zeros for empty
    segments). Both are made at a reduction's first use, so a plan that
    only gathers costs no sort. Build one per batch and pass it to every
    op over the same ids: a plan costs a sort and a few host syncs.

    Meta ids (a dry-run count) have no values: the plan takes them as in
    range (no trash mask) and its levels as one run a segment, so every
    op returns a result of the right shape and reads nothing."""

    def __init__(self, ids, num_segments: int):
        ids = torch.as_tensor(ids).long()
        S = int(num_segments)
        bad = (ids < 0) | (ids >= S)
        self.num_segments = S
        self.ids = torch.where(bad, S, ids)
        self.trashed = None if ids.is_meta or not bool(bad.any()) else bad

    @functools.cached_property
    def order(self) -> torch.Tensor:
        return torch.argsort(self.ids, stable=True)

    @functools.cached_property
    def levels(self) -> list:
        S, dev = self.num_segments, self.ids.device
        if self.ids.is_meta:
            return [torch.empty(S + 1, dtype=torch.long, device=dev)]
        counts = torch.bincount(self.ids, minlength=S + 1)
        levels = []
        while int(counts.max()) > SEGMENT_RUN:
            nruns = (counts + SEGMENT_RUN - 1) // SEGMENT_RUN
            seg = torch.repeat_interleave(torch.arange(S + 1, device=dev),
                                          nruns)
            first = torch.cumsum(nruns, 0) - nruns
            j = torch.arange(seg.shape[0], device=dev) - first[seg]
            levels.append(torch.clamp(counts[seg] - j * SEGMENT_RUN,
                                      max=SEGMENT_RUN))
            counts = nruns
        levels.append(counts)
        return levels

    def __len__(self) -> int:
        return self.ids.shape[0]


def as_plan(ids, num_segments: int | None = None) -> SegmentPlan:
    """``ids`` as a `SegmentPlan` (a plan passes through unchanged)."""
    if isinstance(ids, SegmentPlan):
        if num_segments is not None and num_segments != ids.num_segments:
            raise ValueError(f"plan has {ids.num_segments} segments, "
                             f"asked for {num_segments}")
        return ids
    if num_segments is None:
        raise ValueError("num_segments is required with raw ids")
    return SegmentPlan(ids, num_segments)


def _reduce(x: torch.Tensor, plan: SegmentPlan, op: str,
            wide: bool = False) -> torch.Tensor:
    """The plain reduction: ``op`` over each segment of rows of ``x``
    ([n, ...] -> [S, ...]); sums accumulate in float32 at least, and with
    ``wide`` stay in it (a partial that a cross-shard sum adds to)."""
    if x.shape[0] != len(plan):
        raise ValueError(f"{x.shape[0]} rows for a plan of {len(plan)} ids")
    tail = tuple(x.shape[1:])
    y = x.reshape(x.shape[0], -1).index_select(0, plan.order)
    if op == "sum" and y.dtype in (torch.bfloat16, torch.float16):
        y = y.to(torch.float32)
    for lengths in plan.levels:
        y = torch.segment_reduce(y, op, lengths=lengths, unsafe=True)
    return y[:plan.num_segments].to(y.dtype if wide else x.dtype).reshape(
        (plan.num_segments,) + tail)


def _take(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """``x[ids]`` with a zero row for trashed ids."""
    S = plan.num_segments
    if x.shape[0] != S:
        raise ValueError(f"{x.shape[0]} rows for a plan of {S} segments")
    if plan.trashed is None:
        return x.index_select(0, plan.ids)
    y = x.index_select(0, plan.ids.clamp_max(S - 1))
    return y.masked_fill(plan.trashed.view((-1,) + (1,) * (y.dim() - 1)), 0)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _reduce(x, plan, "sum")

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.plan), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _take(x, plan)

    @staticmethod
    def backward(ctx, g):
        return _SegmentSum.apply(g, ctx.plan), None


class _SegmentExtreme(torch.autograd.Function):
    """Segment max or min; the gradient of a segment is split evenly
    among the rows that reach its extreme (its backward is built from
    the differentiable pair, so it differentiates again)."""

    @staticmethod
    def forward(ctx, x, plan, op):
        out = _reduce(x, plan, op)
        ctx.plan = plan
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        plan = ctx.plan
        with torch.no_grad():
            hit = (x == _take(out, plan)).to(g.dtype)
            cnt = _reduce(hit, plan, "sum").clamp_min(1)
        return _Gather.apply(g / cnt, plan) * hit, None, None


def segment_sum(x: torch.Tensor, ids, num_segments: int | None = None
                ) -> torch.Tensor:
    """`jax.ops.segment_sum`: rows of ``x`` [n, ...] summed by segment
    (``ids`` a `SegmentPlan` or int ids [n]) into [S, ...]; deterministic
    and differentiable any number of times."""
    return _SegmentSum.apply(x, as_plan(ids, num_segments))


def segment_max(x: torch.Tensor, ids, num_segments: int | None = None
                ) -> torch.Tensor:
    """`jax.ops.segment_max`: ``-inf`` where a segment is empty; ties
    share the gradient evenly."""
    return _SegmentExtreme.apply(x, as_plan(ids, num_segments), "max")


def segment_min(x: torch.Tensor, ids, num_segments: int | None = None
                ) -> torch.Tensor:
    """`jax.ops.segment_min`: ``+inf`` where a segment is empty; ties
    share the gradient evenly."""
    return _SegmentExtreme.apply(x, as_plan(ids, num_segments), "min")


def segment_gather(x: torch.Tensor, ids) -> torch.Tensor:
    """``x[ids]`` for a ``x`` of ``num_segments`` rows: its gradient is
    `segment_sum` over the same plan (no float atomics, any order of
    derivative)."""
    return _Gather.apply(x, as_plan(ids, x.shape[0]))


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (int [n]) of ``table`` [R, ...]: `index_select` where
    no gradient is wanted, else `segment_gather` (a deterministic
    gradient)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return segment_gather(table, ids)
    return table.index_select(0, ids)


# ------------------------------------------------------ parameter trees
def flatten_params(tree: dict, prefix: str = "") -> dict:
    """A nested dict as {"a.b.c": leaf}."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(flatten_params(val, path + "."))
        else:
            flat[path] = val
    return flat


def nest_params(flat: dict) -> dict:
    """The inverse of `flatten_params`."""
    out: dict = {}
    for path, v in flat.items():
        *groups, name = path.split(".")
        node = out
        for g in groups:
            node = node.setdefault(g, {})
        node[name] = v
    return out


def abstract_tree(defs: dict) -> dict:
    """``defs`` (path -> shape) as the nested tree of float32 meta tensors:
    the reference's `abstract_params`."""
    return nest_params({path: torch.empty(shape, device="meta")
                        for path, shape in defs.items()})


class ParamGroup(nn.Module):
    """A named group of parameters (``cin``, ``layers``, ...)."""


def register_tensors(module: nn.Module, flat: dict) -> None:
    """Register every ``path: tensor`` of ``flat`` on ``module`` as a
    parameter that does not require gradients (training runs the
    functional path), sharing the tensor's storage and keeping its dtype
    (a path ``group.name`` in a `ParamGroup`)."""
    for path, t in flat.items():
        target = module
        if "." in path:
            group, path = path.split(".", 1)
            if not hasattr(module, group):
                module.add_module(group, ParamGroup())
            target = getattr(module, group)
        target.register_parameter(path, nn.Parameter(t, requires_grad=False))


def register_params(module: nn.Module, defs: dict, device) -> None:
    """Register an uninitialised float32 parameter for every ``path:
    shape`` of ``defs`` on ``module`` (`register_tensors`)."""
    register_tensors(module, {path: torch.empty(shape, device=device)
                              for path, shape in defs.items()})


def param_tree(model: nn.Module) -> dict:
    """A module's parameters as the reference's nested dict, each leaf a
    detached tensor sharing the parameter's storage."""
    return nest_params({n: p.detach() for n, p in model.named_parameters()})


def tree_to_numpy(params) -> dict:
    """A nested dict of numpy arrays, from a module or a nested dict of
    tensors; bfloat16 and float16 leaves come back as float32 (numpy has
    no bfloat16), the others in their own dtype."""
    if isinstance(params, nn.Module):
        params = param_tree(params)

    def host(v):
        v = v.detach()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.to(torch.float32)
        return v.cpu().numpy()

    return nest_params({p: host(v) for p, v in flatten_params(params).items()})


def load_numpy_tree(model: nn.Module, defs: dict, tree: dict) -> nn.Module:
    """Copy the nested numpy tree ``tree`` into ``model``, whose
    parameters are ``defs`` (path -> shape). A missing key, an extra key
    or a shape that differs raises."""
    flat = flatten_params(tree)
    missing = sorted(set(defs) - set(flat))
    extra = sorted(set(flat) - set(defs))
    if missing or extra:
        raise KeyError(f"params_from_numpy: missing {missing}, extra {extra}")
    for path, val in flat.items():
        if tuple(np.shape(val)) != tuple(defs[path]):
            raise ValueError(f"params_from_numpy: {path} has shape "
                             f"{tuple(np.shape(val))}, expected {defs[path]}")
    with torch.no_grad():
        for path, val in flat.items():
            model.get_parameter(path).copy_(torch.tensor(
                np.asarray(val, dtype=np.float32)))
    return model
