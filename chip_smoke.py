#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Builds the four CUDA kernels from `src/repro_torch/csrc/` (one `nvcc` per
source, started together), then drives the port's main path once on the
card: `scale_free(2^17, m=4, num_levels=5, seed=0)` -> the rank-batched
device builder -> `WCSDServer` serving 2^20 random queries and 2^16
profile queries, once in epoch flushes and once under continuous
batching. Launch counts are reset just before that run and read just
after it. Then every kernel is held against its plain PyTorch version on
inputs captured from that run (exact int32 equality) and timed with CUDA
events; every served flush is checked against the plain path, 64 pairs
against the host BFS at every level, and a 2,000-vertex build on the card
against the same build on the CPU, byte for byte.

Prints one JSON object per phase (toolchain, kernels, build, serve),
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
if there is no CUDA device, a kernel does not build or launch, or any
check fails.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# int32 ALU ops/s: 132 SMs x 64 INT32 lanes x 1.98 GHz boost. The data
# sheet's 67 TFLOP/s fp32 is the same clock on 128 FP32 lanes x 2 (FMA).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DEVICE = "cuda"
LOG2_V = 17          # build: scale_free(2^17, m=4, num_levels=5, seed=0)
BATCH = 32           # roots per build batch
LOG2_QUERIES = 20    # served scalar queries
LOG2_PROFILES = 16   # served profile queries
MAX_BATCH = 4096     # server flush size
CHECK_V = 2000       # vertices of the card-vs-CPU build identity check
BFS_PAIRS = 64       # served pairs checked against the host BFS


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ----------------------------------------------------------------- phases
def toolchain() -> dict:
    import torch
    from repro_torch.kernels import _cuda
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    try:
        import triton  # noqa: F401  (only whether it imports is reported)
        has_triton = True
    except ImportError:
        has_triton = False
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    return {"phase": "toolchain", "nvidia_smi": smi[0] if smi else None,
            "torch": torch.__version__, "torch_cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "nvcc": nvcc[-1] if nvcc else None, "triton": has_triton,
            "device": torch.cuda.get_device_name(0),
            "kernel_build_s": build_s}


class Capture:
    """Wraps the build's two round wrappers to keep (clones of) the inputs
    of one call each, and to bracket every call with CUDA events (the
    step's device time, launch overhead included). K3 keeps the pruning
    call that scans the most label entries in the whole build (active
    (root, vertex) pairs times their label-row lengths: one row-length
    count per root batch and one extra host sync per round); K4 keeps
    round 1 of the middle root batch. The wrapped call itself is the original, so the
    launch counts are unchanged."""

    def __init__(self, ops, target_batch: int):
        self.ops = ops
        self.target = target_batch
        self.orig = (ops.wc_prune_emit, ops.wc_relax_batched)
        self.k3 = self.k4 = None
        self.k3_scanned = -1
        self._T = self._lens = None
        self.events = {"wc_prune_emit": [], "wc_relax_batched": []}
        self._rr = None
        self._b4 = -1
        self._k4_calls = 0

    def __enter__(self):
        prune, relax = self.orig

        def wc_prune_emit(F, T, hub, dist, wlev, d, *, do_prune=True):
            if do_prune:
                if T is not self._T:      # a new root batch: rows have grown
                    self._T, self._lens = T, (hub >= 0).sum(1)
                n = int(((F >= 0).sum(0) * self._lens).sum().item())
                if n > self.k3_scanned:
                    self.k3 = None                  # free the old clones
                    self.k3 = tuple(x.clone() for x in (F, T, hub, dist,
                                                        wlev)) + (int(d),)
                    self.k3_scanned = n
            with self._timed("wc_prune_emit"):
                return prune(F, T, hub, dist, wlev, d, do_prune=do_prune)

        def wc_relax_batched(emit_w, nbr, lvl, rank, rr, R):
            if rr is not self._rr:
                self._rr, self._b4, self._k4_calls = rr, self._b4 + 1, 0
            self._k4_calls += 1
            if self._b4 == self.target and self._k4_calls <= 2:
                self.k4 = (emit_w.clone(), nbr, lvl, rank, rr.clone(),
                           R.clone())
            with self._timed("wc_relax_batched"):
                return relax(emit_w, nbr, lvl, rank, rr, R)

        self.ops.wc_prune_emit = wc_prune_emit
        self.ops.wc_relax_batched = wc_relax_batched
        return self

    def __exit__(self, *exc):
        self.ops.wc_prune_emit, self.ops.wc_relax_batched = self.orig
        self._rr = self._T = self._lens = None

    @contextlib.contextmanager
    def _timed(self, name):
        import torch
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        yield
        ev[1].record()
        self.events[name].append(ev)

    def step_seconds(self) -> dict:
        """Summed device time of each wrapped step (call after a sync)."""
        return {k: sum(a.elapsed_time(b) for a, b in evs) / 1e3
                for k, evs in self.events.items()}


def record_flushes(engine, log: list) -> None:
    """Log every flush the server dispatches: (kind, s, t, wl, handle)."""
    qa, pa = engine.query_async, engine.query_profile_async

    def query_async(s, t, wl):
        h = qa(s, t, wl)
        log.append(("query", s.copy(), t.copy(), wl.copy(), h))
        return h

    def query_profile_async(s, t):
        h = pa(s, t)
        log.append(("profile", s.copy(), t.copy(), None, h))
        return h

    engine.query_async = query_async
    engine.query_profile_async = query_profile_async


def serve_epoch(idx, qs, ps, max_batch, log, device):
    from repro_torch.core.serve import WCSDServer
    srv = WCSDServer(idx, max_batch=max_batch, device=device)
    record_flushes(srv.engine, log)
    t0 = time.perf_counter()
    out = srv.query_many(*qs)
    prof = srv.query_profile_many(*ps)
    wall = time.perf_counter() - t0
    return srv, out, prof, wall


def serve_continuous(idx, qs, ps, max_batch, log, device):
    from repro_torch.core.serve import WCSDServer
    srv = WCSDServer(idx, max_batch=max_batch, max_wait_us=200.0,
                     min_batch=max_batch // 4, device=device)
    record_flushes(srv.engine, log)
    s, t, wl = qs
    every = max(1, len(s) // max(len(ps[0]), 1))
    rids, prids = [], []
    t0 = time.perf_counter()
    for i in range(len(s)):
        rids.append(srv.submit(int(s[i]), int(t[i]), int(wl[i])))
        if i % every == 0 and len(prids) < len(ps[0]):
            j = len(prids)
            prids.append(srv.submit_profile(int(ps[0][j]), int(ps[1][j])))
        if i % 256 == 0:
            srv.poll()
    srv.flush()
    out = np.array([srv.result(r) for r in rids], dtype=np.int32)
    prof = np.stack([srv.profile_result(r) for r in prids])
    wall = time.perf_counter() - t0
    return srv, out, prof, wall


def flush_inputs(engine, rec):
    """The worklist of one recorded flush, on the card."""
    import torch
    from repro_torch.core.query import emit_ragged_worklist, \
        ragged_worklist_len, TRASH_LEVEL
    kind, s, t, wl, _ = rec
    stq = engine._stage_ragged(s, t, wl)
    n_len = ragged_worklist_len(engine._tile_cnt_np, stq[0], stq[1])
    st = torch.from_numpy(stq).to(engine.device)
    hub, dist, wlev, lo, hi, base, cnt = engine._arena
    qidx, stile, ttile, first = emit_ragged_worklist(
        base, cnt, st[0], st[1], worklist_len=n_len)
    wq = None
    if kind == "query":
        wq = torch.cat([st[2], torch.full((1,), TRASH_LEVEL,
                                          dtype=torch.int32, device=st.device)])
    return (hub, dist, wlev, lo, hi, qidx, stile, ttile, wq,
            int(st.shape[1]) + 1)


def plain_flush(engine, rec) -> np.ndarray:
    """The plain PyTorch path for one recorded flush, chunked, on the card."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wcsd_query as kwq
    hub, dist, wlev, lo, hi, qidx, stile, ttile, wq, rows = \
        flush_inputs(engine, rec)
    n = len(rec[1])
    if rec[0] == "query":
        best = kwq.wcsd_query_ragged_plain(hub, dist, wlev, qidx, stile,
                                           ttile, wq)
        return kops._to_inf_dist(best)[:n].cpu().numpy()
    import torch
    b = kwq.wcsd_profile_ragged_plain(hub, dist, wlev, qidx, stile, ttile,
                                      rows, engine.num_levels)
    prof = torch.flip(torch.cummin(torch.flip(b, (1,)), 1).values, (1,))
    return kops._to_inf_dist(prof)[:n].cpu().numpy()


_BFS_GRAPH = None


def _bfs_init(g) -> None:
    global _BFS_GRAPH
    _BFS_GRAPH = g


def _bfs_row(pair):
    from repro_torch.core.ref import wcsd_bfs
    g = _BFS_GRAPH
    return [wcsd_bfs(g, pair[0], pair[1], w) for w in range(g.num_levels + 1)]


# ------------------------------------------------------- kernel phases
def ragged_kernel_phase(engine, rec, profile: bool, launches: int,
                        iters: int) -> dict:
    import torch
    from repro_torch.kernels import wcsd_query as kwq
    hub, dist, wlev, lo, hi, qidx, stile, ttile, wq, rows = \
        flush_inputs(engine, rec)
    lane = hub.shape[1]
    L = engine.num_levels
    if profile:
        def kern():
            return kwq.wcsd_profile_ragged_cuda(hub, dist, wlev, lo, hi, qidx,
                                                stile, ttile, rows, L)

        def plain():
            return kwq.wcsd_profile_ragged_plain(hub, dist, wlev, qidx,
                                                 stile, ttile, rows, L)
    else:
        def kern():
            return kwq.wcsd_query_ragged_cuda(hub, dist, wlev, lo, hi, qidx,
                                              stile, ttile, wq)

        def plain():
            return kwq.wcsd_query_ragged_plain(hub, dist, wlev, qidx, stile,
                                               ttile, wq)
    a, b = kern(), plain()
    torch.cuda.synchronize()
    err = int((a.long() - b.long()).abs().max().item())
    # data-dependent work: only real items (not pads, which feed the trash
    # row rows - 1) whose tile hub spans meet are joined
    real = qidx < rows - 1
    meet = real & (lo[stile] <= hi[ttile]) & (lo[ttile] <= hi[stile])
    n_meet = int(meet.sum().item())
    tiles = torch.unique(torch.cat([stile[meet], ttile[meet]]))
    all_tiles = torch.unique(torch.cat([stile[real], ttile[real]]))
    WL = qidx.shape[0]
    nbytes = (12 * WL + 8 * all_tiles.numel() + 12 * lane * tiles.numel()
              + 4 * b.numel() + (4 * wq.numel() if wq is not None else 0))
    nops = (4 if profile else 3) * lane * lane * n_meet
    bms, by = bound_ms(nbytes, nops)
    return {"name": "wcsd_profile_ragged" if profile else "wcsd_query_ragged",
            "route": "cuda", "source": "src/repro_torch/csrc/wcsd_query.cu",
            "replaces": ("src/repro/kernels/wcsd_query.py:371"
                         if profile else "src/repro/kernels/wcsd_query.py:283"),
            "launches": launches, "max_abs_err": err,
            "ms": cuda_ms(kern, iters), "plain_ms": cuda_ms(plain, 2),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": {"worklist": WL, "pad_items": WL - int(real.sum()),
                      "meeting_items": n_meet, "lane": lane,
                      "queries": rows - 1}}


def prune_kernel_phase(cap3, launches: int, step_s: float,
                       iters: int) -> dict:
    import torch
    from repro_torch.kernels import frontier as kfr
    F, T, hub, dist, wlev, d = cap3
    a = kfr.wc_prune_emit_batched_cuda(F, T, hub, dist, wlev, d)
    b = kfr.wc_prune_emit_batched_plain(F, T, hub, dist, wlev, d)
    torch.cuda.synchronize()
    err = int((a.long() - b.long()).abs().max().item())
    B, V = F.shape
    W1 = T.shape[2]
    lens = (hub >= 0).sum(1)                       # prefix length per row
    bi, vi = torch.nonzero(F >= 0, as_tuple=True)
    scanned = int(lens[vi].sum().item())
    rows_bytes = 12 * int(lens[torch.unique(vi)].sum().item())
    # the T cells the active entries gather, each counted once
    gathered = torch.zeros(B * V * W1, dtype=torch.bool, device=F.device)
    for a0 in range(0, bi.numel(), 4096):
        b_, v_ = bi[a0:a0 + 4096], vi[a0:a0 + 4096]
        h = hub[v_]
        fw = F[b_, v_].clamp(0, W1 - 1)
        ok = (h >= 0) & (wlev[v_] >= fw[:, None])
        key = (b_[:, None] * V + h.clamp(min=0)).long() * W1 + fw[:, None]
        gathered[key[ok]] = True
    t_cells = int(gathered.sum().item())
    nbytes = 8 * B * V + rows_bytes + 4 * t_cells
    bms, by = bound_ms(nbytes, 4 * scanned)
    return {"name": "wc_prune_emit_batched", "route": "cuda",
            "source": "src/repro_torch/csrc/frontier.cu",
            "replaces": "src/repro/kernels/frontier.py:108",
            "launches": launches, "max_abs_err": err,
            "ms": cuda_ms(lambda: kfr.wc_prune_emit_batched_cuda(
                F, T, hub, dist, wlev, d), iters),
            "plain_ms": cuda_ms(lambda: kfr.wc_prune_emit_batched_plain(
                F, T, hub, dist, wlev, d), 2),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "main_path_mean_ms": step_s * 1e3 / max(launches, 1),
            "shape": {"B": B, "V": V, "cap": hub.shape[1], "W1": W1,
                      "round": d, "active": int(bi.numel()),
                      "scanned_entries": scanned}}


def relax_kernel_phase(cap4, launches: int, step_s: float,
                       iters: int) -> dict:
    import torch
    from repro_torch.kernels import frontier as kfr
    emit_w, nbr, lvl, rank, rr, R = cap4
    a = kfr.wc_relax_batched_cuda(emit_w, nbr, lvl, rank, rr, R)
    b = kfr.wc_relax_batched_plain(emit_w, nbr, lvl, rank, rr, R)
    torch.cuda.synchronize()
    err = max(int((x.long() - y.long()).abs().max().item())
              for x, y in zip(a, b))
    B, V = emit_w.shape
    deg = (nbr >= 0).sum(1)                           # prefix length per row
    elig = rank[None, :] > rr[:, None]                # [B, V]
    scanned = int((elig.long() * deg[None]).sum().item())
    rows_bytes = 8 * int(deg[elig.any(0)].sum().item())
    # emit cells needed: (b, n) with an eligible neighbour v of n (the
    # adjacency is symmetric), each counted once
    needed = 0
    for a0 in range(0, V, 4096):
        nb = nbr[a0:a0 + 4096]
        e = elig[:, nb.clamp(min=0)] & (nb >= 0)[None]
        needed += int(e.any(2).sum().item())
    nbytes = 12 * B * V + 4 * needed + rows_bytes + 4 * (V + B)
    bms, by = bound_ms(nbytes, 2 * scanned)
    return {"name": "wc_relax_batched", "route": "cuda",
            "source": "src/repro_torch/csrc/frontier.cu",
            "replaces": "src/repro/kernels/frontier.py:160",
            "launches": launches, "max_abs_err": err,
            "ms": cuda_ms(lambda: kfr.wc_relax_batched_cuda(
                emit_w, nbr, lvl, rank, rr, R), iters),
            "plain_ms": cuda_ms(lambda: kfr.wc_relax_batched_plain(
                emit_w, nbr, lvl, rank, rr, R), 2),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "main_path_mean_ms": step_s * 1e3 / max(launches, 1),
            "shape": {"B": B, "V": V, "D": nbr.shape[1],
                      "scanned_neighbours": scanned}}


# ------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core.generators import random_queries, scale_free
    from repro_torch.core.wc_index_batched import \
        build_wc_index_batched_packed
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import ops as kops

    dev = DEVICE
    progress("building kernels")
    tool = toolchain()
    progress(f"kernels built in {tool['kernel_build_s']:.1f} s")

    # ---------------------------------------------- the main path, once
    V = 1 << LOG2_V
    B = BATCH
    t0 = time.perf_counter()
    g = scale_free(V, m=4, num_levels=5, seed=0)
    graph_s = time.perf_counter() - t0
    s, t, wl = random_queries(g, 1 << LOG2_QUERIES, seed=1)
    ps, pt, _ = random_queries(g, 1 << LOG2_PROFILES, seed=2)
    flushes_epoch, flushes_cont = [], []
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    progress(f"main path: build V={V}")
    with Capture(kops, target_batch=(-(-V // B)) // 2) as cap:
        t0 = time.perf_counter()
        idx, stats = build_wc_index_batched_packed(g, batch_size=B,
                                                   device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    after_build = dict(_cuda.LAUNCHES)
    steps = cap.step_seconds()
    progress(f"built in {build_s:.1f} s: {stats}")
    srv_e, out_e, prof_e, wall_e = serve_epoch(idx, (s, t, wl), (ps, pt),
                                               MAX_BATCH, flushes_epoch, dev)
    after_epoch = dict(_cuda.LAUNCHES)
    progress(f"epoch serving {wall_e:.1f} s")
    srv_c, out_c, prof_c, wall_c = serve_continuous(idx, (s, t, wl),
                                                    (ps, pt), MAX_BATCH,
                                                    flushes_cont, dev)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    progress(f"continuous serving {wall_c:.1f} s; launches {launches}")
    for k, n in launches.items():
        if n == 0:
            fail(f"kernel {k} was not launched on the main path")

    # ------------------------------------------------- build phase checks
    ar = srv_e.engine.arena
    build = {"phase": "build", "V": V, "edges": g.num_edges,
             "max_degree": int(g.degree().max()), "levels": g.num_levels,
             "batch_size": B, "graph_s": graph_s, "build_s": build_s,
             "rounds": stats["rounds"], "raw_entries": stats["raw_entries"],
             "entries": stats["entries"],
             "entries_per_vertex": stats["entries"] / V,
             "dominated_removed": stats["dominated_removed"],
             "partial_index_cap": stats["partial_index_cap"],
             "finalize_s": stats["finalize_s"],
             "round_loop_s": build_s - stats["finalize_s"],
             "step_device_s": steps,
             "arena_tiles": ar.num_tiles, "arena_bytes": ar.memory_bytes(),
             "max_tiles_per_row": int(ar.tile_cnt.max()),
             "launches": {k: after_build[k] for k in
                          ("wc_prune_emit_batched", "wc_relax_batched")}}
    gc = scale_free(CHECK_V, m=4, num_levels=5, seed=0)
    t0 = time.perf_counter()
    ic, _ = build_wc_index_batched_packed(gc, batch_size=B, device=dev)
    check_gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ih, _ = build_wc_index_batched_packed(gc, batch_size=B, device="cpu")
    check_cpu_s = time.perf_counter() - t0
    for name in ("hub_rank", "dist", "wlev", "offsets", "bucket_widths",
                 "bucket_of", "slot_of"):
        a, b = getattr(ic.labels, name), getattr(ih.labels, name)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"{CHECK_V}-vertex build: card and CPU differ in "
                 f"PackedLabels.{name}")
    build.update(check_v=CHECK_V, check_identical=True,
                 check_card_s=check_gpu_s, check_cpu_s=check_cpu_s)
    progress(f"{CHECK_V}-vertex card/CPU builds identical")

    # ------------------------------------------------- serve phase checks
    serve = {"phase": "serve", "max_batch": MAX_BATCH,
             "queries": len(s), "profile_queries": len(ps)}
    for name, srv, out, prof, wall, log, base in (
            ("epoch", srv_e, out_e, prof_e, wall_e, flushes_epoch,
             after_build),
            ("continuous", srv_c, out_c, prof_c, wall_c, flushes_cont,
             after_epoch)):
        nq = sum(1 for r in log if r[0] == "query")
        np_ = sum(1 for r in log if r[0] == "profile")
        k1 = (after_epoch if name == "epoch" else launches)[
            "wcsd_query_ragged"] - base["wcsd_query_ragged"]
        k2 = (after_epoch if name == "epoch" else launches)[
            "wcsd_profile_ragged"] - base["wcsd_profile_ragged"]
        if (k1, k2) != (nq, np_):
            fail(f"{name}: {nq} query + {np_} profile flushes made "
                 f"{k1} K1 + {k2} K2 launches (expected one each)")
        bad = 0
        for rec in log:
            if not np.array_equal(rec[4].wait(), plain_flush(srv.engine,
                                                             rec)):
                bad += 1
        if bad:
            fail(f"{name}: {bad} flushes differ from the plain path")
        lat = srv.latency_summary()
        serve[name] = {
            "wall_s": wall, "requests_per_s": (len(s) + len(ps)) / wall,
            "server_flushes": srv.stats.batches,
            "query_dispatches": nq, "profile_dispatches": np_,
            "k1_launches": k1, "k2_launches": k2,
            "launches_per_dispatch": (k1 + k2) / max(nq + np_, 1),
            "dispatch_s": srv.stats.dispatch_time_s,
            "drain_wait_s": srv.stats.drain_wait_s,
            "p50_us": lat["p50_us"], "p99_us": lat["p99_us"],
            "memo_hits": srv.stats.memo_hits,
            "max_batch_seen": srv.stats.max_batch,
            "opportunistic_flushes": srv.stats.opportunistic_flushes,
            "deadline_flushes": srv.stats.deadline_flushes,
            "flushes_equal_plain": True}
    if not (np.array_equal(out_e, out_c) and np.array_equal(prof_e, prof_c)):
        fail("epoch and continuous serving answers differ")
    if not np.array_equal(prof_e[np.arange(len(ps)), 0],
                          srv_e.engine.query(ps, pt, np.zeros(len(ps),
                                                              np.int32))):
        fail("profile level 0 differs from the scalar query")
    rng = np.random.default_rng(3)
    bs_ = rng.integers(0, V, BFS_PAIRS)
    bt_ = rng.integers(0, V, BFS_PAIRS)
    W = g.num_levels
    got = srv_e.engine.query_profile(bs_, bt_)
    got_s = np.stack([srv_e.engine.query(bs_, bt_, np.full(len(bs_), w,
                                                           np.int32))
                      for w in range(W + 1)], axis=1)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            8, mp_context=ctx, initializer=_bfs_init, initargs=(g,)) as pool:
        exp = np.array(list(pool.map(
            _bfs_row, [(int(a), int(b)) for a, b in zip(bs_, bt_)])))
    if not (np.array_equal(got, exp) and np.array_equal(got_s, exp)):
        fail("sampled answers differ from the host BFS")
    progress("served answers equal the plain path and the host BFS")
    serve["bfs_pairs"] = int(BFS_PAIRS)
    serve["bfs_levels"] = W + 1
    serve["bfs_equal"] = True

    # ----------------------------------------- kernels vs plain, timed
    if cap.k3 is None or cap.k4 is None:
        fail("no build round was captured for the kernel phases")
    qrec = next(r for r in flushes_epoch if r[0] == "query")
    prec = next(r for r in flushes_epoch if r[0] == "profile")
    kernels = [
        ragged_kernel_phase(srv_e.engine, qrec, False,
                            launches["wcsd_query_ragged"], 50),
        ragged_kernel_phase(srv_e.engine, prec, True,
                            launches["wcsd_profile_ragged"], 50),
        prune_kernel_phase(cap.k3, launches["wc_prune_emit_batched"],
                           steps["wc_prune_emit"], 50),
        relax_kernel_phase(cap.k4, launches["wc_relax_batched"],
                           steps["wc_relax_batched"], 50),
    ]
    for k in kernels:
        if k["max_abs_err"] != 0:
            fail(f"kernel {k['name']} differs from its plain version "
                 f"(max abs err {k['max_abs_err']})")

    emit(tool)
    for k in kernels:
        emit({"phase": "kernel", **k})
    emit(build)
    emit(serve)
    emit({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for k in kernels]})
    print(tool["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
