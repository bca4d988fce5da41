"""Collectives of the sharded paths, over per-shard tensors.

Port of the reference package's `distributed/collectives.py`. The
reference runs these inside `shard_map`, where each device sees its own
block and a `psum` / `psum_scatter` combines them. The port has one
controller (`launch.mesh`): a collective takes the list of every shard's
block, in the mesh's row-major linear order, and returns the list of
every shard's result, each on that shard's device.

The row gathers behind the row-sharded label store: shard k owns the
contiguous block of rows ``[k * rows_per_shard, (k + 1) * rows_per_shard)``
of an array, and a gather of global row ids hands each consumer the rows
it asked for. The reference sums every shard's contribution (its owned
rows, zeros elsewhere); the port gathers each row from its owner
(`index_select` on the owner's block, then ``.to`` the consumer's
device), which is the same result for every dtype: one real addend plus
zeros. A row id outside every block gathers all zeros, as the sum does;
the reference's per-shard addend (`_owned_contribution`) has no
counterpart here. Row ids are host arrays (a tensor is copied to the
host), so the owner partition is planned without a device sync; each
physical device gets the local ids in one copy.

`psum` / `pmax` / `pmin` combine one tensor a shard in linear shard
order on shard 0's device (a sum in float32 at least, cast once) and
hand every shard a tensor of its own on its device (a ``.to`` between
cards, never a host sync); `reduce_sum` leaves the sum on one device,
and `cross_entropy_blocks` forms a global mean from row blocks with it.
`all_reduce` is `psum` over several tensors a shard as one autograd
node, differentiable any number of times (the graph family's layers).
`distributed_lse_decode` is decode attention over a KV cache split
along its sequence axis: each shard reduces its own block to a
``[B, H, G]`` max, a ``[B, H, G]`` sum and a ``[B, H, G, Dh]`` partial
output, and those three combine; the cache is never gathered.

`gather_leaf` joins a leaf stored by its `Spec` (`launch.mesh.Sharded`)
onto the device that uses it, FSDP's all-gather; autograd
differentiates it, and its backward is the reduce-scatter: each block
takes its slice of the joined gradient, on its own device, where
autograd sums the slices of every gather that read it.
`gather_leaf_rows` takes only the rows a lookup needs from each block.
`sum_replicas` completes the gradient of a block held by several
shards: their partial sums added, the total on each of them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..launch.mesh import Sharded, join_leaf, region_slices


def hierarchical_psum(xs, shape):
    """Sum over a ``(pods, inner)`` mesh in two phases, inner first, then
    across pods. ``xs`` holds one tensor per shard in row-major order;
    returns the total on every shard's device."""
    n_pod, n_inner = shape
    pods = []
    for p in range(n_pod):
        acc = xs[p * n_inner]
        for x in xs[p * n_inner + 1:(p + 1) * n_inner]:
            acc = acc + x.to(acc.device)
        pods.append(acc)
    total = pods[0]
    for x in pods[1:]:
        total = total + x.to(total.device)
    return [total.to(x.device) for x in xs]


def replicate(x: torch.Tensor, devices, distinct: bool = False) -> list:
    """``x`` on each of ``devices``: one copy a distinct device, or with
    ``distinct`` a tensor of its own for each entry (devices that repeat
    get clones, so each entry has its own autograd history)."""
    copies: dict = {}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = x.to(d)
            out.append(copies[d])
        else:
            out.append(copies[d].clone() if distinct else copies[d])
    return out


def reduce_sum(xs, device=None) -> torch.Tensor:
    """The sum of one tensor a shard, added in linear shard order on
    ``device`` (shard 0's by default)."""
    acc = xs[0].to(device or xs[0].device)
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    return acc


def psum(xs, dtype=None) -> list:
    """The sum of one tensor a shard, added in linear shard order on
    shard 0's device in float32 at least and cast once to ``dtype`` (the
    first tensor's by default), handed to every shard's device as a
    tensor of its own (`replicate` with ``distinct``)."""
    wide = torch.promote_types(xs[0].dtype, torch.float32)
    acc = xs[0].to(wide, copy=True)
    for x in xs[1:]:
        acc = acc + x.to(acc.device).to(wide)
    return replicate(acc.to(dtype or xs[0].dtype), [x.device for x in xs],
                     distinct=True)


def _extreme(xs, pick) -> list:
    acc = xs[0].clone()
    for x in xs[1:]:
        acc = pick(acc, x.to(acc.device))
    return replicate(acc, [x.device for x in xs], distinct=True)


def pmax(xs) -> list:
    """The elementwise max over shards in linear shard order, handed out
    as `psum` hands out its sum."""
    return _extreme(xs, torch.maximum)


def pmin(xs) -> list:
    """The elementwise min over shards, as `pmax`."""
    return _extreme(xs, torch.minimum)


def cross_entropy_blocks(logits: list, labels: list) -> torch.Tensor:
    """The mean cross-entropy of a batch given as row blocks (the data
    shards', each on its device): the sum of the blocks' masked sums over
    the global count of labels >= 0, on the first block's device. Equal
    rows a block do not make the blocks' means safe to average: masked
    labels need not fall evenly."""
    from ..models.common import cross_entropy_sums
    sums = [cross_entropy_sums(lg, lb) for lg, lb in zip(logits, labels)]
    dev = logits[0].device
    return reduce_sum([s for s, _ in sums], dev) / reduce_sum(
        [n for _, n in sums], dev).clamp_min(1.0)


class _AllReduce(torch.autograd.Function):
    """`psum` over several tensors a shard, each cast to its ``dtypes``
    entry. Its backward is the same all-reduce of the
    replicas' gradients (in linear shard order, cast once to each
    input's dtype), itself through this Function, so it differentiates
    any number of times."""

    @staticmethod
    def forward(ctx, n_shards, dtypes, *flat):
        per = len(flat) // n_shards
        ctx.n_shards, ctx.per = n_shards, per
        ctx.in_dtypes = tuple(x.dtype for x in flat[:per])
        ctx.meta = [(x.shape, x.device) for x in flat]
        ctx.out_dtypes = dtypes
        outs = [psum(flat[j::per], dtypes[j]) for j in range(per)]
        return tuple(outs[j][k] for k in range(n_shards)
                     for j in range(per))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(shape, dtype=ctx.out_dtypes[i % ctx.per],
                          device=dev) if g is None else g
              for i, (g, (shape, dev)) in enumerate(zip(gs, ctx.meta))]
        back = _AllReduce.apply(ctx.n_shards, ctx.in_dtypes, *gs)
        return (None, None) + tuple(back)


def all_reduce(parts) -> list:
    """The layers' all-reduce of partial aggregates: ``parts`` holds each
    shard's list of tensors (in linear shard order, each on its shard's
    device); returns each shard's list of the totals, each summed in
    linear shard order in float32 at least and cast once to the
    partial's dtype, a distinct tensor a shard. One autograd node for
    all of them: its backward (the same all-reduce) runs once every
    shard's gradient is in, and differentiates again."""
    n, per = len(parts), len(parts[0])
    flat = [x for shard in parts for x in shard]
    out = _AllReduce.apply(n, tuple(x.dtype for x in parts[0]), *flat)
    return [list(out[k * per:(k + 1) * per]) for k in range(n)]


def all_gather(leaf: Sharded, devices) -> list:
    """The whole of ``leaf`` on each of ``devices``, without gradient:
    one copy a distinct device (a block that is already the whole leaf
    on that device is used as it is; row blocks are joined in order)."""
    copies: dict = {}
    rows = all(tuple(b.shape[1:]) == tuple(leaf.shape[1:]) for b in leaf)
    with torch.no_grad():
        for d in devices:
            if d in copies:
                continue
            whole = [b for b in leaf if b.device == d
                     and tuple(b.shape) == tuple(leaf.shape)]
            if whole:
                copies[d] = whole[0]
            elif rows:
                copies[d] = torch.cat([leaf[k].to(d) for k in leaf.owners()])
            else:
                copies[d] = join_leaf(leaf, d)
    return [copies[d] for d in devices]


def distributed_lse_decode(q, k_shards, v_shards, kv_valid_mask=None
                           ) -> list:
    """Decode attention against a KV cache sharded along its sequence
    axis, without gathering it (the reference's `distributed_lse_decode`,
    the log-sum-exp trick).

    q: [B, Hkv, G, Dh], replicated to every shard; k_shards / v_shards:
    each shard's [B, S_local, Hkv, Dh] block; kv_valid_mask: None or
    each shard's bool [B, S_local]. ``q * scale``
    is formed in q's dtype and the logits in float32; a masked logit is
    -1e30. The shards combine a max and a sum of ``[B, Hkv, G]`` and a
    sum of ``[B, Hkv, G, Dh]`` partial outputs (float32). Returns each
    shard's [B, Hkv, G, Dh] result in q's dtype, on its device."""
    qs = replicate(q * q.shape[-1] ** -0.5, [k.device for k in k_shards])
    masks = (list(kv_valid_mask) if kv_valid_mask is not None
             else [None] * len(k_shards))
    logits = []
    for qk, k, m in zip(qs, k_shards, masks):
        lg = torch.einsum("bhgd,bshd->bhgs", qk.float(), k.float())
        if m is not None:
            lg = lg.masked_fill(~m[:, None, None, :].to(torch.bool), -1e30)
        logits.append(lg)
    mx = pmax([lg.amax(-1) for lg in logits])
    p = [torch.exp(lg - m[..., None]) for lg, m in zip(logits, mx)]
    denom = psum([pk.sum(-1) for pk in p])
    out = psum([torch.einsum("bhgs,bshd->bhgd", pk, v.float())
                for pk, v in zip(p, v_shards)])
    return [(o / d[..., None]).to(q.dtype) for o, d in zip(out, denom)]


def axis_linear_index(coords, shape) -> int:
    """A shard's linear index from its mesh coordinates, row-major in
    axis order (an int is a 1-D mesh's coordinate)."""
    if isinstance(coords, (int, np.integer)):
        return int(coords)
    idx = 0
    for c, n in zip(coords, shape):
        idx = idx * int(n) + int(c)
    return idx


def batch_slice(x, shard: int, n_local: int):
    """Shard ``shard``'s contiguous slice of a replicated batch-axis
    array: ``x[shard * n_local : (shard + 1) * n_local]``, the slice the
    scattering gathers below hand it."""
    return x[shard * n_local:(shard + 1) * n_local]


class _GatherPlan:
    """Who gathers which rows from whom. ``rows`` is ``[K, m]``: consumer
    k (shard k) receives rows ``rows[k]`` in that order. Each consumer's
    ids are sorted by owner (stable) on the host, so every (owner,
    consumer) pair is one contiguous run; the owner-major list of local
    ids goes to each physical device once."""

    def __init__(self, rows, rows_per_shard: int, devices):
        if torch.is_tensor(rows):
            rows = rows.cpu().numpy()
        R = np.asarray(rows, dtype=np.int64)
        self.n = n = len(devices)
        self.devices = devices
        K, m = R.shape
        per = int(rows_per_shard)
        owner = np.where((R >= 0) & (R < n * per), R // per, n)
        self.order = np.argsort(owner, axis=1, kind="stable")
        so = np.take_along_axis(owner, self.order, 1)
        local = np.take_along_axis(R, self.order, 1) - so * per
        # counts[k, o]: rows consumer k takes from owner o (o == n: nobody)
        self.counts = np.stack([np.bincount(so[k], minlength=n + 1)
                                for k in range(K)]) if K else \
            np.zeros((0, n + 1), np.int64)
        starts = np.zeros_like(self.counts)
        starts[:, 1:] = np.cumsum(self.counts, axis=1)[:, :-1]
        segs, self.owner_off = [], np.zeros(n + 1, np.int64)
        for o in range(n):
            for k in range(K):
                segs.append(local[k, starts[k, o]:starts[k, o]
                                  + self.counts[k, o]])
            self.owner_off[o + 1] = self.owner_off[o] + self.counts[:, o].sum()
        flat = np.concatenate(segs) if segs else np.zeros(0, np.int64)
        self._flat = flat
        self._flat_dev: dict = {}
        self.identity = [bool((self.order[k] == np.arange(m)).all())
                         for k in range(K)]
        self._perm_dev: dict = {}

    def _ids(self, o: int) -> torch.Tensor:
        dev = self.devices[o]
        if dev not in self._flat_dev:
            self._flat_dev[dev] = torch.from_numpy(self._flat).to(dev)
        return self._flat_dev[dev][self.owner_off[o]:self.owner_off[o + 1]]

    def apply(self, blocks):
        """Gather from one array given as its per-shard ``blocks``:
        returns consumer k's ``[m, ...]`` rows on shard k's device."""
        n = self.n
        got = [blocks[o].index_select(0, self._ids(o))
               if self.counts[:, o].sum() else None for o in range(n)]
        out = []
        for k in range(self.counts.shape[0]):
            dev = blocks[k].device
            pieces = []
            for o in range(n):
                c = int(self.counts[k, o])
                if c:
                    a = int(self.counts[:k, o].sum())
                    pieces.append(got[o][a:a + c].to(dev))
            nobody = int(self.counts[k, n])
            if nobody:
                pieces.append(torch.zeros((nobody,) + tuple(
                    blocks[k].shape[1:]), dtype=blocks[k].dtype, device=dev))
            if not pieces:
                res = torch.empty((0,) + tuple(blocks[k].shape[1:]),
                                  dtype=blocks[k].dtype, device=dev)
            elif len(pieces) == 1:
                res = pieces[0]
            else:
                res = torch.cat(pieces)
            if not self.identity[k]:
                if k not in self._perm_dev:
                    self._perm_dev[k] = torch.from_numpy(
                        self.order[k]).to(dev)
                res = torch.empty_like(res).index_copy_(
                    0, self._perm_dev[k], res)
            out.append(res.contiguous())
        return out


def _scatter_rows(rows, n: int) -> np.ndarray:
    if torch.is_tensor(rows):
        rows = rows.cpu().numpy()
    rows = np.asarray(rows)
    if rows.shape[0] % n:
        raise ValueError(f"{rows.shape[0]} row ids do not split over {n} "
                         "shards")
    return rows.reshape(n, rows.shape[0] // n)


def _devices(blocks):
    return [b.device for b in blocks]


def row_gather_psum(shards, rows, rows_per_shard: int):
    """Gather global ``rows`` (``[B]``, replicated) from an array whose
    per-shard blocks are ``shards``: every shard receives all ``[B, ...]``
    gathered rows."""
    if torch.is_tensor(rows):
        rows = rows.cpu().numpy()
    rows = np.asarray(rows)
    R = np.broadcast_to(rows, (len(shards),) + rows.shape)
    return _GatherPlan(R, rows_per_shard, _devices(shards)).apply(shards)


def row_gather_psum_scatter(shards, rows, rows_per_shard: int):
    """`row_gather_psum` fused with a batch split: shard k receives only
    its ``B / n`` slice of the gathered rows (``B`` divisible by the shard
    count)."""
    R = _scatter_rows(rows, len(shards))
    return _GatherPlan(R, rows_per_shard, _devices(shards)).apply(shards)


def multi_row_gather_psum_scatter(arrays, rows, rows_per_shard: int):
    """`row_gather_psum_scatter` over several same-sharded arrays in one
    call: ``arrays`` holds each array's per-shard blocks, of any dtype
    and rank. Returns, per shard, the tuple of its gathered slices."""
    arrays = [list(a) for a in arrays]
    plan = _GatherPlan(_scatter_rows(rows, len(arrays[0])), rows_per_shard,
                       _devices(arrays[0]))
    per_array = [plan.apply(a) for a in arrays]
    return [tuple(g[k] for g in per_array) for k in range(len(arrays[0]))]


def ragged_tile_gather(arrays, rows, rows_per_shard: int):
    """The worklist tile gather of the row-sharded ragged dispatch:
    ``rows`` concatenates every shard's tile list in linear shard order,
    and shard k receives exactly its own list's tiles of each array
    (the int32 trio, or the compressed int16 / float16-format / int8
    one: a selection moves every dtype exactly, so the reference's
    int16 bit-pattern route for floats is not needed)."""
    return multi_row_gather_psum_scatter(arrays, rows, rows_per_shard)


# ------------------------------------------------ leaves stored by Spec
class _GatherBlocks(torch.autograd.Function):
    """Blocks at their offsets in a new tensor on ``device``; the
    backward hands each block its slice of the gradient on the block's
    device (a copy, never a view that would keep the whole gradient)."""

    @staticmethod
    def forward(ctx, device, shape, offsets, *blocks):
        ctx.offsets = offsets
        ctx.devices = [b.device for b in blocks]
        out = torch.empty(shape, dtype=blocks[0].dtype, device=device)
        for sl, b in zip(offsets, blocks):
            out[sl] = b
        return out

    @staticmethod
    def backward(ctx, g):
        grads = []
        for sl, dev in zip(ctx.offsets, ctx.devices):
            piece = g[sl]
            grads.append(piece.clone() if dev == g.device
                         else piece.to(dev))
        return (None, None, None) + tuple(grads)


def _sources(leaf: Sharded, device, where, shard=None) -> list:
    """(region, shard) for each distinct block among the shards whose
    coordinates match ``where`` ({axis: coordinate}): the reading
    ``shard``'s own where it holds the block on ``device``, else the
    shard on ``device`` where one holds the block, else the first."""
    mesh = leaf.mesh
    out = []
    for region, ks in leaf.groups().items():
        if where:
            ks = [k for k in ks if all(mesh.coords(k).get(a, 0) == c
                                       for a, c in where.items())]
        if ks:
            here = [k for k in ks if leaf[k].device == device]
            own = [shard] if shard in here else []
            out.append((region, (own or here or ks)[0]))
    return out


def gather_leaf(leaf, device, dtype=None, where=None,
                shard=None) -> torch.Tensor:
    """The whole of a `Sharded` leaf on ``device`` (with ``where``, the
    box the blocks of the matching shards cover: a "model" shard's
    experts), each block cast to ``dtype`` on its own device before it
    moves. A box held by one block already on ``device`` is that block
    (no copy). ``shard``, the shard that reads, takes its own replica of
    a block where it holds one on ``device``: each replica's gradient
    then stays its own until `sum_replicas` adds them in order, the same
    on four logical shards of a card as on four cards. Differentiable:
    see the module's note."""
    device = torch.device(device)
    src = _sources(leaf, device, where, shard)
    if not src:
        raise ValueError(f"no shard of the mesh matches {where}")
    lo = [min(r[i][0] for r, _ in src) for i in range(len(leaf.shape))]
    hi = [max(r[i][1] for r, _ in src) for i in range(len(leaf.shape))]
    shape = tuple(b - a for a, b in zip(lo, hi))
    covered = sum(int(np.prod([b - a for a, b in r])) for r, _ in src)
    if covered != int(np.prod(shape)):
        raise ValueError(f"the blocks of {leaf.spec} at {where} do not tile "
                         f"a box of {leaf.shape}")
    blocks = [leaf[k] if dtype is None else leaf[k].to(dtype)
              for _, k in src]
    if len(blocks) == 1 and blocks[0].device == device:
        return blocks[0]
    offsets = tuple(region_slices(r, lo) for r, _ in src)
    return _GatherBlocks.apply(device, shape, offsets, *blocks)


def gather_leaf_rows(leaf: Sharded, ids: torch.Tensor, device,
                     shard=None) -> torch.Tensor:
    """Rows ``ids`` (int [n]) of a `Sharded` table [R, C] on ``device``,
    without joining it: each block gathers the ids its rows hold (the
    others clamped into range and masked out after) on its own device,
    and the column blocks are joined (``shard`` as in `gather_leaf`).
    The gather is `gather_rows` (`models.common`: a deterministic
    gradient)."""
    from ..models.common import gather_rows
    device = torch.device(device)
    ids = ids.to(device)
    cols: dict = {}
    for (r, c), k in _sources(leaf, device, None, shard):
        if r[1] <= r[0]:
            continue
        blk = leaf[k]
        local = (ids - r[0]).clamp(0, r[1] - r[0] - 1).to(blk.device)
        rows = gather_rows(blk, local).to(device)
        if c in cols:
            inside = (ids >= r[0]) & (ids < r[1])
            rows = torch.where(inside[:, None], rows, cols[c])
        cols[c] = rows
    parts = [cols[c] for c in sorted(cols)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


def sum_replicas(grad: Sharded) -> Sharded:
    """A `Sharded` gradient whose replicas (shards holding one block)
    may each hold a part, or None: each block's parts summed in linear
    shard order on its first shard's device (zeros where no shard has
    one), the total handed to every shard that holds it (one copy a
    device)."""
    out = list(grad)
    for region, ks in grad.groups().items():
        parts = [grad[k] for k in ks if grad[k] is not None]
        owner = grad.mesh.devices[ks[0]]
        if not parts:
            total = None
        elif len(parts) == 1 and len(ks) == 1:
            continue
        else:
            total = reduce_sum(parts, owner)
        if total is None:
            shape = tuple(b - a for a, b in region)
            total = torch.zeros(shape, device=owner)
        here = replicate(total, [grad.mesh.devices[k] for k in ks])
        for k, t in zip(ks, here):
            out[k] = t
    return grad.like(out)
