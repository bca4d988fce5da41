"""Device-side batched WCSD query engine (ragged dispatch over the CSR
store's lane-tiled arena).

Port of the reference package's `core/query.py` for
``DeviceQueryEngine(layout="csr", dispatch="ragged")``: a batch of
(s, t, w_level) queries becomes a flat (query, s_tile, t_tile) worklist
emitted on the device (`emit_ragged_worklist`), and the whole batch is
answered by ONE kernel launch (K1 `wcsd_query_ragged`, or K2
`wcsd_profile_ragged` for all-level profiles).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels._cuda import resolve_device
from .wc_index import LANE, PackedWCIndex

TRASH_LEVEL = 1 << 20  # no stored wlev reaches it: infeasible everywhere


def emit_ragged_worklist(tile_base, tile_cnt, s, t, *, worklist_len: int):
    """Device-side ragged plan: the flat (query, s_tile, t_tile) worklist.

    Query q over rows with ``tile_cnt[s[q]]`` x ``tile_cnt[t[q]]`` arena
    tiles owns that many consecutive work items (query-major, via an
    exclusive prefix sum). Returns (qidx, stile, ttile, first), all int32
    [worklist_len]. Items beyond the real total carry ``qidx == len(s)``
    (the caller's trash output row) and tile 0 on both sides; ``first``
    marks each output row's first work item, the trash row's included.
    """
    Q = s.shape[0]
    dev = s.device
    ts = tile_cnt[s.long()]
    tt = tile_cnt[t.long()]
    c = ts * tt                                            # [Q] >= 1
    cum = torch.cumsum(c, 0, dtype=torch.int32)
    k = torch.arange(worklist_len, dtype=torch.int32, device=dev)
    qidx = torch.searchsorted(cum, k, right=True, out_int32=True)
    qc = qidx.clamp_max(Q - 1).long()                      # clamp for pads
    local = k - (cum[qc] - c[qc])
    pad = qidx >= Q
    stile = torch.where(pad, 0, tile_base[s[qc].long()]
                        + torch.div(local, tt[qc], rounding_mode="floor"))
    ttile = torch.where(pad, 0, tile_base[t[qc].long()]
                        + torch.remainder(local, tt[qc]))
    first = torch.ones_like(qidx)
    first[1:] = (qidx[1:] != qidx[:-1]).to(torch.int32)
    return qidx, stile.to(torch.int32), ttile.to(torch.int32), first


def ragged_worklist_len(tile_cnt: np.ndarray, s: np.ndarray, t: np.ndarray
                        ) -> int:
    """Host-side worklist length: the batch's exact tile-pair count. O(B)
    — the only per-flush host arithmetic of the ragged path. (The
    reference rounds it up to a power of two to bound its jit shapes; the
    kernels here take any length, so no pad items are launched.)"""
    total = int(tile_cnt[s].astype(np.int64) @ tile_cnt[t].astype(np.int64))
    return total


def ragged_query_batch(hub, dist, wlev, tile_lo, tile_hi, tile_base,
                       tile_cnt, stq, *, worklist_len: int):
    """Plan + launch: emit the worklist from the staged queries and answer
    every query with one K1 launch. stq: [3, Q] staged (s, t, w_level).
    Returns [Q] int32 distances (INF_DIST when no feasible path)."""
    s, t, wl = stq[0], stq[1], stq[2]
    qidx, stile, ttile, first = emit_ragged_worklist(
        tile_base, tile_cnt, s, t, worklist_len=worklist_len)
    # one trash output row for worklist pads, at an infeasible level
    wq = torch.cat([wl, torch.full((1,), TRASH_LEVEL, dtype=torch.int32,
                                   device=wl.device)])
    out = kops.wcsd_query_ragged(hub, dist, wlev, tile_lo, tile_hi, qidx,
                                 stile, ttile, first, wq)
    return out[: s.shape[0]]


def ragged_profile_batch(hub, dist, wlev, tile_lo, tile_hi, tile_base,
                         tile_cnt, stq, *, worklist_len: int,
                         num_levels: int):
    """Profile twin of `ragged_query_batch`: stq is [2, Q] staged (s, t);
    every level of every query comes from one K2 launch. Returns
    [Q, num_levels + 1] staircases."""
    s, t = stq[0], stq[1]
    qidx, stile, ttile, first = emit_ragged_worklist(
        tile_base, tile_cnt, s, t, worklist_len=worklist_len)
    out = kops.wcsd_profile_ragged(hub, dist, wlev, tile_lo, tile_hi, qidx,
                                   stile, ttile, first,
                                   num_rows=int(s.shape[0]) + 1,
                                   num_levels=num_levels)
    return out[: s.shape[0]]


class PendingResult:
    """Handle to an in-flight query batch.

    The device work is already enqueued when the handle is created;
    `wait()` copies the answers to the host (once — the handle caches).
    `ready()` probes without blocking: on the card it queries a CUDA event
    recorded right after the launch; on the CPU the work is already done.
    """

    def __init__(self, finalize, event=None):
        self._finalize = finalize
        self._event = event
        self._out = None

    def ready(self) -> bool:
        if self._finalize is None or self._event is None:
            return True
        return bool(self._event.query())

    def wait(self) -> np.ndarray:
        if self._finalize is not None:
            self._out = np.asarray(self._finalize())
            self._finalize = None
            self._event = None
        return self._out


def _pending(res: torch.Tensor, n: int) -> PendingResult:
    event = None
    if res.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(res.device))
    return PendingResult(lambda: res[:n].cpu().numpy(), event)


class DeviceQueryEngine:
    """Holds the label arena on the device and answers query batches: each
    flush is ONE kernel launch over the lane-tiled `LabelArena`, planned by
    a device-emitted tile-pair worklist.

    Runs on the card unless ``device="cpu"`` (the kernels' plain
    versions). Only ``layout="csr"`` with ``dispatch="ragged"``,
    uncompressed, is ported; the other engine configurations raise
    `NotImplementedError`.
    """

    def __init__(self, idx: PackedWCIndex, layout: str = "csr",
                 dispatch: str = "ragged", lane: int | None = None,
                 compressed: bool = False, cap: int | None = None,
                 device=None):
        if layout != "csr":
            raise NotImplementedError(f"layout={layout!r} (padded store) is "
                                      "not ported yet; use layout='csr'")
        if dispatch != "ragged":
            raise NotImplementedError(f"dispatch={dispatch!r} (bucket-pair "
                                      "dispatch) is not ported yet")
        if compressed:
            raise NotImplementedError("compressed=True (compressed arena) is "
                                      "not ported yet")
        if cap is not None:
            raise ValueError("cap (label-row trimming) only applies to the "
                             "padded layout; the CSR store keeps exact rows")
        self.device = resolve_device(device)
        self.layout = layout
        self.dispatch = dispatch
        self.num_levels = idx.num_levels
        lane = LANE if lane is None else int(lane)
        self.lane = lane
        packed = idx.packed(lane=lane)
        self.packed = packed
        ar = packed.arena(lane=lane)
        self.arena = ar
        self._tile_cnt_np = ar.tile_cnt
        self._arena = tuple(
            torch.from_numpy(a).to(self.device)
            for a in (ar.hub, ar.dist, ar.wlev, ar.tile_lo, ar.tile_hi,
                      ar.tile_base, ar.tile_cnt))

    def _stage_ragged(self, s, t, w_level=None):
        """One [3 or 2, B] staging array for a ragged flush: exactly the
        batch, no pad lanes (the reference pads the batch to a power of
        two to bound its jit shapes; the kernels here take any size)."""
        rows = (s, t) if w_level is None else (s, t, w_level)
        return np.stack([np.asarray(r, np.int32) for r in rows])

    def _put(self, stq: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(stq).to(self.device)

    def query(self, s, t, w_level) -> np.ndarray:
        """[B] int32 distances (INF_DIST where no feasible path)."""
        return self.query_async(s, t, w_level).wait()

    def query_async(self, s, t, w_level) -> PendingResult:
        """Enqueue a batch without waiting: the worklist emission and the
        one kernel launch are issued when this returns."""
        s = np.asarray(s, np.int32)
        t = np.asarray(t, np.int32)
        w_level = np.asarray(w_level, np.int32)
        stq = self._stage_ragged(s, t, w_level)
        wl_len = ragged_worklist_len(self._tile_cnt_np, stq[0], stq[1])
        res = ragged_query_batch(*self._arena, self._put(stq),
                                 worklist_len=wl_len)
        return _pending(res, len(s))

    def query_profile(self, s, t) -> np.ndarray:
        """[B, W + 1] staircases: ``out[b, w] == query(s, t, w)[b]`` for
        every level, from one label sweep."""
        return self.query_profile_async(s, t).wait()

    def query_profile_async(self, s, t) -> PendingResult:
        s = np.asarray(s, np.int32)
        t = np.asarray(t, np.int32)
        stq = self._stage_ragged(s, t)
        wl_len = ragged_worklist_len(self._tile_cnt_np, stq[0], stq[1])
        res = ragged_profile_batch(*self._arena, self._put(stq),
                                   worklist_len=wl_len,
                                   num_levels=self.num_levels)
        return _pending(res, len(s))

    def query_from_quality(self, s, t, w: np.ndarray, levels: np.ndarray):
        """Real-valued thresholds -> levels (exact canonicalization)."""
        wl = np.searchsorted(levels, np.asarray(w), side="left")
        return self.query(s, t, wl.astype(np.int32))
