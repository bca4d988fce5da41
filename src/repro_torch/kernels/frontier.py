"""Constrained-BFS kernels: the rank-batched construction kernels (K3
`wc_prune_emit_batched`, K4 `wc_relax_batched`) and the single-root
relaxation K10 `frontier_relax_gathered`. The CUDA launchers and, beside
each, its plain PyTorch version.

One synchronized round of the device-resident builder
(`core.wc_index_batched.build_wc_index_batched_packed`) for a batch of B
roots: K3 prunes the frontier against the partial index and emits the
surviving labels, K4 relaxes the emitted frontier over the padded
adjacency. The CUDA source is `repro_torch/csrc/frontier.cu`; the plain
versions translate the reference package's
`kernels/ref.py:wc_prune_emit_batched_ref` / `wc_relax_batched_ref` line
by line, chunked over (root, vertex) blocks so that the ``[B, V, cap]``
and ``[B, V, D]`` intermediates stay bounded on the card.

Pads may sit anywhere in a label or adjacency row: both versions mask
each pad as a cell. Both also take an optional row end per row
(``row_end``: one past the last slot that can contribute) and treat every
slot at or past it as a pad; the CUDA kernels do not read those slots. A
caller that knows the row ends passes them (the builder does); otherwise
the CUDA wrapper computes them exactly (`row_ends`) and the plain version
reads every slot.
K3 reads T through its strides in the level-major layout ``[B, W+1, V]``
(seen as ``[B, V, W+1]``, `level_major`), which the builder makes; any
other layout is copied into it once per call.

K10 is one round of a single-root constrained BFS over a padded adjacency
whose frontier levels are already gathered per neighbour
(`kernels.ops.frontier_relax` gathers ``Fw[nbr]``): per vertex v,
``cand = max_j min(fw_nbr[v, j], lvl[v, j])``, ``newF = cand if cand >
R[v] else -1``, ``newR = max(R[v], cand)`` -- K4 with one root and no
rank mask.
"""
from __future__ import annotations

import torch

from . import _cuda

DEV_INF = 1 << 29
INF_DIST = 1 << 30
_CHUNK_CELLS = 1 << 25  # gathered cells per chunk of the plain versions
_CHUNK_ROWS = 64        # most vertices per chunk of the plain prune


def _vchunk(B: int, width: int) -> int:
    return max(1, _CHUNK_CELLS // max(B * width, 1))


def row_ends(ids, lvl):
    """[V] int32: one past the last slot of each row of ``ids`` / ``lvl``
    ([V, D]) with ``ids >= 0`` and ``lvl >= 0`` (0 for a row without
    one). Every other slot is a pad for K3 (hub, wlev) and K4 (nbr, lvl),
    wherever it sits; the kernels scan a row only this far."""
    V, D = ids.shape
    out = torch.zeros(V, dtype=torch.int32, device=ids.device)
    if D == 0:
        return out
    col = torch.arange(1, D + 1, dtype=torch.int32, device=ids.device)
    step = max(1, _CHUNK_CELLS // D)
    for a in range(0, V, step):
        real = (ids[a:a + step] >= 0) & (lvl[a:a + step] >= 0)
        out[a:a + step] = torch.where(real, col, 0).amax(dim=1)
    return out


def level_major(T):
    """T [B, V, W+1] as a view of a level-major ``[B, W+1, V]`` tensor
    (strides ``(W1 * V, 1, V)``): T itself when it already is one, else
    one copy."""
    B, V, W1 = T.shape
    if T.stride() == (W1 * V, 1, V):
        return T
    return T.permute(0, 2, 1).contiguous().permute(0, 2, 1)


def _real(ids, row_end, a: int):
    """[n, width] bool: the slots of rows a.. of ``ids`` that are not pads
    (id >= 0 and before the row's ``row_end``, where one is given)."""
    real = ids >= 0
    if row_end is not None:
        col = torch.arange(ids.shape[1], device=ids.device)
        real &= col[None] < row_end[a:a + ids.shape[0], None]
    return real


def wc_prune_emit_batched_plain(F, T, hub, dist, wlev, d: int,
                                row_end=None):
    """Plain version of K3: F [B, V], T [B, V, W+1] (any strides),
    hub/dist/wlev [V, cap] (pads hub -1, dist INF_DIST, wlev -1,
    anywhere in a row), d the round, ``row_end`` [V] optional (slots at
    or past it are pads). Returns emit [B, V] int32: F where the partial
    index does not already cover the frontier distance, else -1."""
    B, V = F.shape
    W1 = T.shape[2]
    cap = hub.shape[1]
    out = torch.empty_like(F)
    bidx = torch.arange(B, device=F.device)[:, None, None]
    step = min(_vchunk(B, cap), _CHUNK_ROWS)
    for a in range(0, V, step):
        Fa = F[:, a:a + step]
        if not bool((Fa >= 0).any()):   # no active frontier: all -1
            out[:, a:a + step] = -1
            continue
        ha, da, wa = hub[a:a + step], dist[a:a + step], wlev[a:a + step]
        fw = Fa.clamp(0, W1 - 1)
        # T[b, clip(hub), fw], gathered through T's own strides
        tv = T[bidx, ha.clamp(0, V - 1).long()[None],
               fw.long()[:, :, None]]                         # [B, n, cap]
        feas = _real(ha, row_end, a)[None] & (wa[None] >= fw[:, :, None])
        cand = torch.where(feas, da.clamp_max(DEV_INF)[None]
                           + tv.clamp_max(DEV_INF), INF_DIST)
        q = cand.amin(dim=2)
        survive = (Fa >= 0) & (q > d)
        out[:, a:a + step] = torch.where(survive, Fa, -1)
    return out


def wc_relax_batched_plain(emit_w, nbr_pad, lvl_pad, rank, root_ranks, R,
                           row_end=None):
    """Plain version of K4: emit_w/R [B, V], nbr_pad/lvl_pad [V, D] (a
    slot with nbr < 0 is a pad, wherever it sits; ids >= V read V - 1),
    rank [V], root_ranks [B], ``row_end`` [V] optional (slots at or past
    it are pads). Returns (newF, newR), both [B, V]."""
    B, V = emit_w.shape
    D = nbr_pad.shape[1]
    newF = torch.empty_like(R)
    newR = torch.empty_like(R)
    step = _vchunk(B, D)
    for a in range(0, V, step):
        na, la = nbr_pad[a:a + step], lvl_pad[a:a + step]
        fwn = emit_w[:, na.clamp(0, V - 1)]                   # [B, n, D]
        fwn = torch.where(_real(na, row_end, a)[None], fwn, -1)
        wp = torch.minimum(fwn, la[None])
        cand = wp.amax(dim=2)
        cand = torch.where(rank[None, a:a + step] > root_ranks[:, None],
                           cand, -1)
        Ra = R[:, a:a + step]
        newF[:, a:a + step] = torch.where(cand > Ra, cand, -1)
        newR[:, a:a + step] = torch.maximum(Ra, cand)
    return newF, newR


def frontier_relax_gathered_plain(fw_nbr, lvl_pad, R):
    """Plain version of K10 (the reference's `frontier_relax_gathered_ref`):
    fw_nbr/lvl_pad [V, D], R [V]. Returns (newF, newR), both [V]."""
    cand = torch.minimum(fw_nbr, lvl_pad).amax(dim=1)
    return torch.where(cand > R, cand, -1), torch.maximum(R, cand)


def frontier_relax_gathered_cuda(fw_nbr, lvl_pad, R):
    """Launch K10 on the current stream: one warp per vertex. Same
    contract as the plain version."""
    what = "frontier_relax_gathered"
    _cuda.check_cuda_args(what, R.device, fw_nbr=fw_nbr, lvl_pad=lvl_pad,
                          R=R)
    V = R.shape[0] if R.dim() == 1 else -1
    if fw_nbr.dim() != 2 or fw_nbr.shape[0] != V \
            or lvl_pad.shape != fw_nbr.shape:
        raise ValueError(f"{what}: expected fw_nbr/lvl_pad [V, D], R [V]")
    D = fw_nbr.shape[1]
    if D < 1:
        raise ValueError(f"{what}: empty adjacency rows")
    newF = torch.empty_like(R)
    newR = torch.empty_like(R)
    if V == 0:                            # no vertex launches nothing
        return newF, newR
    fn = _cuda.library("frontier").frontier_relax_gathered_launch
    err = fn(fw_nbr.data_ptr(), lvl_pad.data_ptr(), R.data_ptr(),
             newF.data_ptr(), newR.data_ptr(), V, D,
             _cuda.stream_ptr(R.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return newF, newR


def wc_prune_emit_batched_cuda(F, T, hub, dist, wlev, d: int,
                               row_end=None):
    """Launch K3 on the current stream: one launch, a block per 256
    vertices, each active vertex's row read once for all of its active
    roots. Same contract as the plain version, for any placement of
    pads. ``row_end`` [V] (`row_ends`; the builder's per-row counts; slots
    at or past it are pads) is computed from hub/wlev where not given; T
    is read level-major (`level_major`)."""
    what = "wc_prune_emit_batched"
    given = {} if row_end is None else {"row_end": row_end}
    _cuda.check_cuda_args(what, F.device, F=F, hub=hub, dist=dist,
                          wlev=wlev, **given)
    if row_end is None:
        row_end = row_ends(hub, wlev)
    B, V = F.shape
    W1 = T.shape[2] if T.dim() == 3 else -1
    cap = hub.shape[1]
    if T.shape != (B, V, W1) or W1 < 1:
        raise ValueError(f"{what}: T must be [B, V, W+1] = [{B}, {V}, *]")
    if T.device != F.device or T.dtype != torch.int32:
        raise ValueError(f"{what}: T must be int32 on {F.device}")
    if hub.shape != (V, cap) or dist.shape != (V, cap) \
            or wlev.shape != (V, cap) or row_end.shape != (V,):
        raise ValueError(f"{what}: hub/dist/wlev must be [V, cap], "
                         "row_end [V]")
    T = level_major(T)
    emit = torch.empty_like(F)
    fn = _cuda.library("frontier").wc_prune_emit_launch
    err = fn(F.data_ptr(), T.data_ptr(), hub.data_ptr(), dist.data_ptr(),
             wlev.data_ptr(), row_end.data_ptr(), emit.data_ptr(), B, V, W1,
             cap, int(d), _cuda.stream_ptr(F.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return emit


def wc_relax_batched_cuda(emit_w, nbr_pad, lvl_pad, rank, root_ranks, R,
                          row_end=None):
    """Launch K4 on the current stream: a mask pass (one uint32 word of
    active-root bits per vertex and 32 roots) and the vertex-major pull
    over it, two CUDA launches. Same contract as the plain version, for
    any placement of pads and any pad id (ids >= V are clipped to V - 1,
    as the reference clips them). ``row_end`` [V] (`row_ends` of nbr/lvl;
    the builder computes it once per build; slots at or past it are pads)
    is computed here where not given."""
    what = "wc_relax_batched"
    _cuda.check_cuda_args(what, emit_w.device, emit_w=emit_w,
                          nbr_pad=nbr_pad, lvl_pad=lvl_pad, rank=rank,
                          root_ranks=root_ranks, R=R)
    B, V = emit_w.shape
    D = nbr_pad.shape[1]
    if R.shape != (B, V) or nbr_pad.shape != (V, D) \
            or lvl_pad.shape != (V, D):
        raise ValueError(f"{what}: expected emit_w/R [B, V], nbr_pad/"
                         "lvl_pad [V, D]")
    if rank.shape != (V,) or root_ranks.shape != (B,):
        raise ValueError(f"{what}: expected rank [V], root_ranks [B]")
    if row_end is None:
        row_end = row_ends(nbr_pad, lvl_pad)
    else:
        _cuda.check_cuda_args(what, emit_w.device, row_end=row_end)
    if row_end.shape != (V,):
        raise ValueError(f"{what}: row_end must be [V]")
    newF = torch.empty_like(R)
    newR = torch.empty_like(R)
    act = torch.empty(((B + 31) // 32, V), dtype=torch.int32,
                      device=R.device)      # uint32 bits, scratch
    fn = _cuda.library("frontier").wc_relax_batched_launch
    err = fn(emit_w.data_ptr(), nbr_pad.data_ptr(), lvl_pad.data_ptr(),
             rank.data_ptr(), root_ranks.data_ptr(), row_end.data_ptr(),
             R.data_ptr(), newF.data_ptr(), newR.data_ptr(), act.data_ptr(),
             B, V, D, _cuda.stream_ptr(emit_w.device))
    _cuda.check_launch(err, what)
    _cuda.LAUNCHES[what] += 1
    return newF, newR
