#!/usr/bin/env python3
"""Build and bucket-pair serving of the port at V = 2^17, for comparing
two trees of the port on one card.

    python3 scripts/chip_ab.py --src SRC --label NAME [--out FILE]
                               [--profile] [--no-serve]

imports `repro_torch` from ``SRC`` (the ``src/`` directory of the tree
under test), builds `scale_free(2^17, m=4, num_levels=5, seed=0)` with
`build_wc_index_batched_packed` (batch 32) on the card, and serves 2^20
random queries and 2^16 profiles through
`WCSDServer(dispatch="bucket_pair", max_batch=4096)` in epoch flushes,
as `chip_smoke.py` does. The only instrumentation is a pair of CUDA
events around every call of the build's two round wrappers (K3
`ops.wc_prune_emit`, K4 `ops.wc_relax_batched`), the same for any tree,
so two trees run in turns on one card (A, B, B, A) compare like for
like. Prints one JSON line (and appends it to ``--out``): a SHA-256 of
the built index's packed arrays (two trees that build the same index
print the same digest), build, round loop and finalize seconds, the
device seconds of each round step (CUDA events around the call, so the
wrapper's own host time between them is counted too), the host seconds
spent inside each wrapper, the launch counts, and the serving wall
time, requests/s, dispatch and drain-wait seconds. ``--profile`` also
traces the build with `torch.profiler` (CUDA activity only) and adds
every kernel's summed device time, the busy device time over the round
loop, the round loop's idle share, and the round kernels' calls binned
by their device time ([count, seconds] per bin). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--no-serve", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core.generators import random_queries, scale_free
    from repro_torch.core.serve import WCSDServer
    from repro_torch.core.wc_index_batched import \
        build_wc_index_batched_packed
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import ops as kops

    _cuda.build()
    g = scale_free(1 << 17, m=4, num_levels=5, seed=0)
    s, t, wl = random_queries(g, 1 << 20, seed=1)
    ps, pt, _ = random_queries(g, 1 << 16, seed=2)
    events = {"wc_prune_emit": [], "wc_relax_batched": []}
    host_s = dict.fromkeys(events, 0.0)

    def timed(name, fn):
        def call(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            h0 = time.perf_counter()
            out = fn(*a, **k)
            host_s[name] += time.perf_counter() - h0
            ev[1].record()
            events[name].append(ev)
            return out
        return call

    orig = {n: getattr(kops, n) for n in events}
    for n, fn in orig.items():
        setattr(kops, n, timed(n, fn))
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    idx, stats = build_wc_index_batched_packed(g, batch_size=32,
                                               device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kernels = None
    if prof is not None:
        prof.__exit__(None, None, None)
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            if us:
                kernels[e.key] = {"s": us / 1e6, "calls": e.count}
        edges = (15, 30, 60, 120, 250, float("inf"))
        per_call = {}                # the round kernels' calls by duration
        for e in prof.events():
            name = e.name.split("(")[0]
            if not name.startswith(("wc_prune", "wc_relax")):
                continue
            us = getattr(e, "device_time_total", None)
            us = e.cuda_time_total if us is None else us
            hist = per_call.setdefault(name, [[0, 0.0] for _ in edges])
            k = next(i for i, x in enumerate(edges) if us < x)
            hist[k][0] += 1
            hist[k][1] += us / 1e6
    for n, fn in orig.items():
        setattr(kops, n, fn)
    build_launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    step_s = {n: sum(a.elapsed_time(b) for a, b in evs) / 1e3
              for n, evs in events.items()}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    digest = hashlib.sha256()
    for name in ("hub_rank", "dist", "wlev", "offsets", "bucket_widths",
                 "bucket_of", "slot_of"):
        digest.update(np.ascontiguousarray(getattr(idx.labels, name)))
    rec = {"label": args.label, "card": smi,
           "index_sha256": digest.hexdigest(), "build_s": build_s,
           "finalize_s": stats["finalize_s"],
           "round_loop_s": build_s - stats["finalize_s"],
           "rounds": stats["rounds"], "entries": stats["entries"],
           "step_device_s": step_s, "step_host_s": host_s,
           "build_launches": build_launches}
    if kernels is not None:
        busy = sum(k["s"] for k in kernels.values())
        rec["profile"] = {
            "kernels": dict(sorted(kernels.items(),
                                   key=lambda kv: -kv[1]["s"])[:25]),
            "device_busy_s": busy,
            "per_call_us_edges": [15, 30, 60, 120, 250, "inf"],
            "per_call": per_call,
            "round_loop_idle_share": 1 - busy / rec["round_loop_s"]}
    if not args.no_serve:
        srv = WCSDServer(idx, max_batch=4096, dispatch="bucket_pair",
                         device="cuda")
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        srv.query_many(s, t, wl)
        srv.query_profile_many(ps, pt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec["bucket_pair"] = {
            "wall_s": wall, "requests_per_s": (len(s) + len(ps)) / wall,
            "dispatch_s": srv.stats.dispatch_time_s,
            "drain_wait_s": srv.stats.drain_wait_s,
            "launches": {k: v for k, v in _cuda.LAUNCHES.items() if v}}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
