"""Wrappers the engines and the models call for the port's kernels.

Each wrapper chooses by the device of the tensors it is given: a CPU
tensor gets the kernel's plain PyTorch version, a CUDA tensor the CUDA
kernel (which raises if it cannot launch — there is no fallback). The
wrappers the dry-run cells reach (`wcsd_query`, `cin_layer` with
`CinLayer`, `cin_weight_grad`) also take meta tensors, before they ask
`_on_card`: a dry-run count (`launch.op_analysis`) gets a result of the
right shape and dtype, and the kernel's work, a function of the shapes
alone, goes to every counter in `WORK_SINKS`; the other wrappers raise
on meta tensors. The
wrappers also own the post-processing the reference package's
`kernels/ops.py` does around its kernels: ``>= DEV_INF`` maps to
INF_DIST, and profile bucket minima become staircases by a suffix min.
"""
from __future__ import annotations

import torch

from . import cin_fuse as _cin
from . import frontier as _frontier
from . import wcsd_query as _wq
from . import wcsd_segmented as _seg

DEV_INF = 1 << 29
INF_DIST = 1 << 30


# the dry-run counters active now (`launch.op_analysis.OpCounter` adds
# itself on entry and removes itself on exit)
WORK_SINKS: list = []


def _on_card(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {x.device}")


def _report(kernel: str, *, flops: int = 0, int_ops: int = 0,
            nbytes: int = 0) -> None:
    """A meta-route call's kernel work, to every active counter: its
    FLOPs, its integer operations and the bytes it must move (each input
    read once, the output written once)."""
    for sink in WORK_SINKS:
        sink.add_kernel(kernel, flops=flops, int_ops=int_ops, nbytes=nbytes)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _to_inf_dist(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= DEV_INF, INF_DIST, x).to(torch.int32)


def _staircase(bucket: torch.Tensor) -> torch.Tensor:
    """Per-pair-level bucket minima -> staircases: the suffix min over
    levels (torch has no reverse cummin: flip, cummin, flip back), then
    ``>= DEV_INF`` -> INF_DIST."""
    prof = torch.flip(torch.cummin(torch.flip(bucket, (1,)), dim=1).values,
                      (1,))
    return _to_inf_dist(prof)


def padded_rows(hub, dist, wlev, count, v, w_level=None):
    """Rows ``v`` of the padded store [V, L], masked: (hub, dist clamped to
    DEV_INF and set to DEV_INF past the row's count -- and below the
    query's ``w_level`` where given --, wlev set to -1 past the count)."""
    v = v.long()
    col = torch.arange(hub.shape[1], device=hub.device)
    m = col[None, :] < count[v][:, None]
    w = torch.where(m, wlev[v], -1)
    if w_level is not None:
        m = m & (wlev[v] >= w_level[:, None])
    return hub[v], torch.where(m, dist[v].clamp_max(DEV_INF), DEV_INF), w


def gather_padded_rows(hub, dist, wlev, count, s, t, w_level):
    """The K9 inputs of a padded-store batch: both label rows of every
    query, ``[B, L]`` each, masked by count and level (`padded_rows`).
    Returns (hs, ds, ht, dt). The store's pad cells keep hub -1 on both
    sides; their meets sum to 2^30, which never beats a DEV_INF
    accumulator."""
    hs, ds, _ = padded_rows(hub, dist, wlev, count, s, w_level)
    ht, dt, _ = padded_rows(hub, dist, wlev, count, t, w_level)
    return hs, ds, ht, dt


def wcsd_query(hub, dist, wlev, count, s, t, w_level):
    """Batched queries against the padded store (reference `ops.py:
    wcsd_query`): hub/dist/wlev [V, L], count [V], s/t/w_level [B].
    Gathers and masks the rows, runs K9 (plain version on the CPU), and
    returns [B] int32 distances (INF_DIST when no feasible path). K9
    takes any B and L and pads nothing itself; the padded engine's store
    comes lane-padded to a multiple of 128 with ``use_pallas=True``, as
    the reference ships it, and those pad cells are masked here like the
    row's own."""
    hs, ds, ht, dt = gather_padded_rows(hub, dist, wlev, count, s, t,
                                        w_level)
    if hub.is_meta:
        # K9's merge join: at most 2L compares and L hub meets (2 ops
        # each) a query; the meets depend on the rows, so count them all
        B, L = hs.shape
        best = hs.new_empty((B,))
        _report("wcsd_query_gathered", int_ops=4 * B * L,
                nbytes=_nbytes(hs, ds, ht, dt, best))
    elif _on_card(hub, "wcsd_query"):
        best = _wq.wcsd_query_gathered_cuda(hs, ds, ht, dt)
    else:
        best = _wq.wcsd_query_gathered_plain(hs, ds, ht, dt)
    return _to_inf_dist(best)


def wcsd_query_ragged(hub, dist, wlev, tile_lo, tile_hi, qidx, stile, ttile,
                      first, wq):
    """One ragged flush: every query of the batch in a single launch over
    the lane-tiled arena (worklist contract: `core.query.
    emit_ragged_worklist`). ``first`` is part of the worklist contract but
    neither version needs it. Returns [Q] int32 distances (INF_DIST when
    no feasible path)."""
    del first
    if _on_card(hub, "wcsd_query_ragged"):
        best = _wq.wcsd_query_ragged_cuda(hub, dist, wlev, tile_lo, tile_hi,
                                          qidx, stile, ttile, wq)
    else:
        best = _wq.wcsd_query_ragged_plain(hub, dist, wlev, qidx, stile,
                                           ttile, wq)
    return _to_inf_dist(best)


def wcsd_profile_ragged(hub, dist, wlev, tile_lo, tile_hi, qidx, stile,
                        ttile, first, *, num_rows: int, num_levels: int):
    """Ragged PROFILE flush: per-pair-level bucket minima from one launch,
    turned into staircases by the suffix min over levels. Returns
    [num_rows, num_levels + 1] int32 (INF_DIST where infeasible)."""
    del first
    if _on_card(hub, "wcsd_profile_ragged"):
        bucket = _wq.wcsd_profile_ragged_cuda(
            hub, dist, wlev, tile_lo, tile_hi, qidx, stile, ttile,
            num_rows=num_rows, num_levels=num_levels)
    else:
        bucket = _wq.wcsd_profile_ragged_plain(
            hub, dist, wlev, qidx, stile, ttile, num_rows=num_rows,
            num_levels=num_levels)
    return _staircase(bucket)


def wcsd_query_ragged_compressed(hub_delta, dist, wlev, tile_lo, tile_hi,
                                 qidx, stile, ttile, first, wq):
    """`wcsd_query_ragged` over the compressed arena (`CompressedArena`
    fields: int16 hub deltas, bfloat16/float16 distances, int8 levels,
    decoded in the kernel). Same worklist and output contract; callers
    route stores with overflowed tiles to the uncompressed path."""
    del first
    if _on_card(hub_delta, "wcsd_query_ragged_compressed"):
        best = _wq.wcsd_query_ragged_compressed_cuda(
            hub_delta, dist, wlev, tile_lo, tile_hi, qidx, stile, ttile, wq)
    else:
        best = _wq.wcsd_query_ragged_compressed_plain(
            hub_delta, dist, wlev, tile_lo, qidx, stile, ttile, wq)
    return _to_inf_dist(best)


def wcsd_profile_ragged_compressed(hub_delta, dist, wlev, tile_lo, tile_hi,
                                   qidx, stile, ttile, first, *,
                                   num_rows: int, num_levels: int):
    """`wcsd_profile_ragged` over the compressed arena."""
    del first
    if _on_card(hub_delta, "wcsd_profile_ragged_compressed"):
        bucket = _wq.wcsd_profile_ragged_compressed_cuda(
            hub_delta, dist, wlev, tile_lo, tile_hi, qidx, stile, ttile,
            num_rows=num_rows, num_levels=num_levels)
    else:
        bucket = _wq.wcsd_profile_ragged_compressed_plain(
            hub_delta, dist, wlev, tile_lo, qidx, stile, ttile,
            num_rows=num_rows, num_levels=num_levels)
    return _staircase(bucket)


def wcsd_query_segmented(hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t,
                         srow, trow, w_level):
    """One bucket-pair sub-batch: [Ns, Ws] s-side and [Nt, Wt] t-side
    bucket tiles (pads hub -1, wlev -1), row ids and levels [B]. Returns
    [B] int32 distances (INF_DIST when no feasible path)."""
    if _on_card(srow, "wcsd_query_segmented"):
        best = _seg.wcsd_query_segmented_cuda(hub_s, dist_s, wlev_s, hub_t,
                                              dist_t, wlev_t, srow, trow,
                                              w_level)
    else:
        best = _seg.wcsd_query_segmented_plain(hub_s, dist_s, wlev_s, hub_t,
                                               dist_t, wlev_t, srow, trow,
                                               w_level)
    return _to_inf_dist(best)


def wcsd_query_segmented_grouped(flush):
    """A whole bucket-pair flush of scalar queries, staged as a
    `kernels.wcsd_segmented.GroupedFlush`: one K7 launch on the card (the
    plain version per sub-batch on the CPU). Returns [B] int32 distances
    in staging order (INF_DIST when no feasible path)."""
    if _on_card(flush.st, "wcsd_query_segmented"):
        best = _seg.wcsd_query_segmented_grouped_cuda(flush)
    else:
        best = _seg.wcsd_query_segmented_grouped_plain(flush)
    return _to_inf_dist(best)


def wcsd_profile_segmented(hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t,
                           srow, trow, *, num_levels: int):
    """One bucket-pair sub-batch of profiles: both rows read once, every
    level answered. Returns [B, num_levels + 1] int32 staircases
    (INF_DIST where infeasible)."""
    if _on_card(srow, "wcsd_profile_segmented"):
        bucket = _seg.wcsd_profile_segmented_cuda(
            hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t, srow, trow,
            num_levels=num_levels)
    else:
        bucket = _seg.wcsd_profile_segmented_plain(
            hub_s, dist_s, wlev_s, hub_t, dist_t, wlev_t, srow, trow,
            num_levels=num_levels)
    return _staircase(bucket)


def wcsd_profile_segmented_grouped(flush, *, num_levels: int):
    """A whole bucket-pair flush of profiles, staged as a
    `kernels.wcsd_segmented.GroupedFlush` with a ``[2, B]`` array: one K8
    launch on the card (the plain version per sub-batch on the CPU).
    Returns [B, num_levels + 1] int32 staircases in staging order
    (INF_DIST where infeasible)."""
    if _on_card(flush.st, "wcsd_profile_segmented"):
        bucket = _seg.wcsd_profile_segmented_grouped_cuda(flush, num_levels)
    else:
        bucket = _seg.wcsd_profile_segmented_grouped_plain(flush, num_levels)
    return _staircase(bucket)


def wc_prune_emit(F, T, hub, dist, wlev, d: int, *, do_prune: bool = True,
                  row_end=None):
    """Fused partial-index prune + emission for a batch of roots. F [B, V]
    frontier levels (-1 inactive); T [B, V, W+1] per-root hub tables (any
    strides; the card reads the level-major layout the builder makes);
    hub/dist/wlev [V, cap] partial index, pads anywhere; d the round;
    ``row_end`` [V] optional row ends (`frontier.row_ends`; slots at or
    past them are pads on either device; computed on the card where not
    given). Returns
    emit_w [B, V]. With do_prune=False (round 0) the whole frontier
    emits."""
    if not do_prune:
        return F
    if _on_card(F, "wc_prune_emit"):
        return _frontier.wc_prune_emit_batched_cuda(F, T, hub, dist, wlev, d,
                                                    row_end=row_end)
    return _frontier.wc_prune_emit_batched_plain(F, T, hub, dist, wlev, d,
                                                 row_end=row_end)


def wc_relax_batched(emit_w, nbr_pad, lvl_pad, rank, root_ranks, R, *,
                     row_end=None):
    """One batched relaxation round. emit_w/R [B, V]; nbr_pad/lvl_pad
    [V, D] (pads anywhere; ids >= V read V - 1); rank [V]; root_ranks
    [B]; ``row_end`` [V] optional row ends as for `wc_prune_emit`.
    Returns (newF, newR)."""
    if _on_card(emit_w, "wc_relax_batched"):
        return _frontier.wc_relax_batched_cuda(emit_w, nbr_pad, lvl_pad,
                                               rank, root_ranks, R,
                                               row_end=row_end)
    return _frontier.wc_relax_batched_plain(emit_w, nbr_pad, lvl_pad, rank,
                                            root_ranks, R, row_end=row_end)


def frontier_relax(nbr_pad, lvl_pad, Fw, R):
    """One single-root constrained-relaxation round over a padded
    adjacency (reference `ops.py:frontier_relax`): nbr_pad/lvl_pad [V, D]
    (pads nbr -1, lvl -1), Fw/R [V]. Gathers ``Fw[nbr]`` (-1 at pad
    neighbours), then K10 (plain version on the CPU). Returns (newF,
    newR), both [V]."""
    fw_nbr = Fw[nbr_pad.clamp(0, Fw.shape[0] - 1).long()]
    fw_nbr = torch.where(nbr_pad >= 0, fw_nbr, -1).to(torch.int32)
    if _on_card(R, "frontier_relax"):
        return _frontier.frontier_relax_gathered_cuda(fw_nbr, lvl_pad, R)
    return _frontier.frontier_relax_gathered_plain(fw_nbr, lvl_pad, R)


def _cin_forward(x1, x0, w):
    """K11 on the card (any B; the reference pads B to its block of 8,
    K11 masks its edge; the narrow kernel where `cin_fuse.cin_narrow`
    says so, else the wide one), the plain version on the CPU."""
    if x1.is_meta:
        B, H, D = x1.shape
        K, M = w.shape[0], x0.shape[1]
        out = x1.new_empty((B, K, D), dtype=torch.float32)
        # the card's scratch, allocated (and freed on return) as the CUDA
        # wrapper does, so that a counter sees it live
        work_shape, words = _cin.cin_scratch(
            x1.device, B, H, M, D, K, x1.dtype == torch.bfloat16)
        scratch = (x1.new_empty(work_shape, dtype=torch.float32),
                   x1.new_empty((words,), dtype=torch.int32))
        _report("cin_layer_narrow" if _cin.cin_narrow(K, x1.dtype)
                else "cin_layer", flops=2 * B * H * M * K * D,
                nbytes=_nbytes(x1, x0, w, out))
        del scratch
        return out
    if _on_card(x1, "cin_layer"):
        return _cin.cin_layer_cuda(x1, x0, w)
    return _cin.cin_layer_plain(x1, x0, w)


def cin_layer_split(x1, x0, w):
    """`_cin_forward` over x0's channels cut into `cin_fuse.cin_m_parts`
    (one call where the call is narrow or M fits the wide kernel's shared
    memory), each part with its slice of w, the parts' outputs added in
    index order. The same calls on either device."""
    parts = _cin.cin_m_parts(x0.shape[1],
                             _cin.cin_narrow(w.shape[0], x1.dtype))
    if len(parts) == 1:
        return _cin_forward(x1, x0, w)
    out = None
    for a, b in parts:
        y = _cin_forward(x1, x0[:, a:b].contiguous(),
                         w[:, :, a:b].contiguous())
        out = y if out is None else out + y
    return out


def cin_weight_grad(g, x1, x0):
    """The weight gradient of a CIN layer, ``dw[k, h, m] = sum_{b, d}
    g[b, k, d] x1[b, h, d] x0[b, m, d]`` -> [K, H, M] float32: K12 on the
    card, its plain version on the CPU."""
    if g.is_meta:
        (B, K, D), H, M = g.shape, x1.shape[1], x0.shape[1]
        dw = g.new_empty((K, H, M), dtype=torch.float32)
        work_shape, words = _cin.cin_grad_scratch(g.device, B, H, M, D, K)
        scratch = (g.new_empty(work_shape, dtype=torch.float32),
                   g.new_empty((words,), dtype=torch.int32))
        _report("cin_weight_grad", flops=2 * B * H * M * K * D,
                nbytes=_nbytes(g, x1, x0, dw))
        del scratch
        return dw
    if _on_card(g, "cin_weight_grad"):
        return _cin.cin_weight_grad_cuda(g, x1, x0)
    return _cin.cin_weight_grad_plain(g, x1, x0)


class CinLayer(torch.autograd.Function):
    """A CIN layer with its gradient on the same kernels, for g = dL/dout
    [B, K, D]:

      dx1 = cin_layer(g, x0, w.permute(1, 0, 2))   K11, H' = K, K' = H
      dx0 = cin_layer(g, x1, w.permute(2, 0, 1))   K11, H' = K, M' = H,
                                                   K' = M (split only
                                                   where the call is wide
                                                   and M' passes
                                                   CIN_MAX_M)
      dw  = cin_weight_grad(g, x1, x0)             K12

    At the model's widths (M = 39) dx0 and the first layer's dx1 go to
    the narrow K11 kernel, one call each.

    Where x1 and x0 are one tensor (the first layer: both are the
    embeddings), autograd adds the two contributions."""

    @staticmethod
    def forward(ctx, x1, x0, w):
        ctx.save_for_backward(x1, x0, w)
        return _cin_forward(x1, x0, w)

    @staticmethod
    def backward(ctx, g):
        x1, x0, w = ctx.saved_tensors
        g = g.contiguous()
        dx1 = dx0 = dw = None
        if ctx.needs_input_grad[0]:
            dx1 = _cin_forward(g, x0, w.permute(1, 0, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dx0 = cin_layer_split(g, x1, w.permute(2, 0, 1).contiguous())
        if ctx.needs_input_grad[2]:
            dw = cin_weight_grad(g, x1, x0)
        return dx1, dx0, dw


def cin_layer(x1, x0, w):
    """One xDeepFM CIN layer (reference `ops.py:cin_layer`): x1 [B, H, D],
    x0 [B, M, D], w [K, H, M] -> [B, K, D] float32. K11 on the card, the
    plain version on the CPU. Where an input requires a gradient (and
    grad mode is on) it goes through `CinLayer`, whose backward runs K11
    and K12; otherwise it is the forward alone, as serving calls it."""
    if torch.is_grad_enabled() and (x1.requires_grad or x0.requires_grad
                                    or w.requires_grad):
        return CinLayer.apply(x1, x0, w)
    return _cin_forward(x1, x0, w)
