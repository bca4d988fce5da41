#!/usr/bin/env python3
"""Build and serving of the port at V = 2^17, for comparing two trees of
the port on one card.

    python3 scripts/chip_ab.py --src SRC --label NAME [--out FILE]
                               [--profile] [--no-serve]

imports `repro_torch` from ``SRC`` (the ``src/`` directory of the tree
under test), builds `scale_free(2^17, m=4, num_levels=5, seed=0)` with
`build_wc_index_batched_packed` (batch 32) on the card, and serves 2^20
random queries and 2^16 profiles in epoch flushes of 4,096 through three
servers in turn, each with `chip_smoke.serve_epoch` (the smoke's own
serving loop, imported from the checkout this script sits in): the
ragged server (K1 a scalar flush, K2 a profile flush), the bucket-pair
server (K7, K8) and the padded server (`layout="padded"`, K9 a scalar
flush, the plain padded join for profiles); every server's answers must
equal the ragged server's. Then the smoke's compressed path: the V =
2^15 index of `chip_smoke.compressed_serve_phase` (same graph, build and
streams), served in epoch flushes of 4,096 by a ragged server and by a
compressed one (K5, K6), whose answers must equal the ragged server's.
The only instrumentation is a pair of CUDA
events around every call of the build's two round wrappers (K3
`ops.wc_prune_emit`, K4 `ops.wc_relax_batched`), the same for any tree,
so two trees run in turns on one card (A, B, B, A) compare like for
like. Prints one JSON line (and appends it to ``--out``): a SHA-256 of
the built index's packed arrays (two trees that build the same index
print the same digest), build, round loop and finalize seconds, the
device seconds of each round step (CUDA events around the call, so the
wrapper's own host time between them is counted too), the host seconds
spent inside each wrapper, the launch counts, and per server (the V =
2^15 ones as ``ragged_v15`` and ``compressed``) the serving wall time,
requests/s, dispatch and drain-wait seconds, p50 and p99 latency and the
launch counts. ``--profile`` also
traces the build with `torch.profiler` (CUDA activity only) and adds
every kernel's summed device time, the busy device time over the round
loop, the round loop's idle share, and the round kernels' calls binned
by their device time ([count, seconds] per bin). ``--kernels`` also
times, with the smoke's own kernel phases (CUDA events, the smoke's
shapes), K1 and K2 on the ragged server's first scalar and profile
flush, K7 and K8 on the bucket-pair server's first scalar and profile
flush, K9 (and the
gather before it) on the padded server's first scalar flush, and K5 and
K6 on the compressed server's first scalar and profile flush; each
kernel is held against its plain version there, as in the smoke. Needs
a CUDA device.
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
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke               # puts its own src/ first on the path
    sys.path.insert(0, os.path.abspath(args.src))   # the tree under test
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core.generators import random_queries, scale_free
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
    first = {}                  # server -> (engine, first query / profile)
    if not args.no_serve:
        servers = (("ragged", {}),
                   ("bucket_pair", {"dispatch": "bucket_pair"}),
                   ("padded", {"layout": "padded", "use_pallas": True}))
        if not serve_all(chip_smoke, idx, (s, t, wl), (ps, pt), servers,
                         rec, first):
            return 1
        del idx
        g = scale_free(1 << chip_smoke.LOG2_V_COMPRESSED, m=4, num_levels=5,
                       seed=0)
        idx, _ = build_wc_index_batched_packed(
            g, batch_size=chip_smoke.BATCH, device="cuda")
        qs = random_queries(g, 1 << chip_smoke.LOG2_QUERIES, seed=1)
        pq = random_queries(g, 1 << chip_smoke.LOG2_PROFILES, seed=2)[:2]
        if not serve_all(chip_smoke, idx, qs, pq,
                         (("ragged_v15", {}),
                          ("compressed", {"compressed": True})), rec, first):
            return 1
        if first["compressed"][0].compressed is not True:
            print("chip_ab: the V = 2^15 index was not served compressed",
                  file=sys.stderr)
            return 1
    if args.kernels and first:
        rec["kernels"] = kernel_times(chip_smoke, first, "cuda")
        bad = [k for k, v in rec["kernels"].items()
               if any(x for key, x in v.items() if key.endswith("err"))]
        if bad:
            print(f"chip_ab: {bad} differ from their plain versions",
                  file=sys.stderr)
            return 1
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


def serve_all(smoke, idx, qs, ps, servers, rec, first) -> bool:
    """Serve the streams through each (name, WCSDServer keywords) in turn
    with `chip_smoke.serve_epoch`, recording each server's numbers in
    ``rec[name]`` and its engine with its first scalar and profile flush
    in ``first[name]``. False (and a message) where a server's answers
    differ from the first one's."""
    import numpy as np
    import torch
    from repro_torch.kernels import _cuda
    answers = None
    for name, kw in servers:
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        log = []
        srv, out, prof, wall = smoke.serve_epoch(idx, qs, ps, 4096, log,
                                                 "cuda", **kw)
        torch.cuda.synchronize()
        if answers is None:
            answers = (out, prof)
        elif not (np.array_equal(out, answers[0])
                  and np.array_equal(prof, answers[1])):
            print(f"chip_ab: {name} serving differs from {servers[0][0]}",
                  file=sys.stderr)
            return False
        lat = srv.latency_summary()
        rec[name] = {
            "wall_s": wall,
            "requests_per_s": (len(qs[0]) + len(ps[0])) / wall,
            "dispatch_s": srv.stats.dispatch_time_s,
            "drain_wait_s": srv.stats.drain_wait_s,
            "p50_us": lat["p50_us"], "p99_us": lat["p99_us"],
            "launches": {k: v for k, v in _cuda.LAUNCHES.items() if v}}
        first[name] = (srv.engine, next(r for r in log if r[0] == "query"),
                       next(r for r in log if r[0] == "profile"))
        del srv, log
    return True


def kernel_times(smoke, first, device) -> dict:
    """The smoke's kernel phases on the first flushes of each server: per
    kernel its times (``*ms``), merge shares and errors against the plain
    version."""
    phases = []
    for name in ("ragged", "compressed"):
        eng, qrec, prec = first[name]
        phases += [smoke.ragged_kernel_phase(eng, qrec, False, 0, 50),
                   smoke.ragged_kernel_phase(eng, prec, True, 0, 50)]
    eng, qrec, prec = first["bucket_pair"]
    phases += [smoke.segmented_kernel_phase(eng, qrec, False, 0, 20),
               profile_flush_times(smoke, eng, prec)]
    eng, qrec, _ = first["padded"]
    phases.append(smoke.gathered_kernel_phase(eng, qrec, 0, 10))
    return {k["name"]: {key: v for key, v in k.items()
                        if key.endswith(("ms", "err", "share"))}
            for k in phases}


def profile_flush_times(smoke, eng, prec) -> dict:
    """K8 on the bucket-pair server's first profile flush: the smoke's
    kernel phase where the tree under test launches K8 once a flush;
    where it launches K8 once a sub-batch (no grouped K8), those launches
    back to back (its flush, ``ms``) and its heaviest sub-batch alone,
    each sub-batch held against the plain version."""
    import torch
    from repro_torch.kernels import wcsd_segmented as kseg
    if hasattr(kseg, "wcsd_profile_segmented_grouped_cuda"):
        return smoke.segmented_kernel_phase(eng, prec, True, 0, 20)
    L = eng.num_levels
    subs = smoke.sub_batches(eng, prec)

    def kern(stq, tiles):
        return kseg.wcsd_profile_segmented_cuda(*tiles, stq[0], stq[1], L)

    err = 0
    for _, stq, tiles in subs:
        exp = kseg.wcsd_profile_segmented_plain(*tiles, stq[0], stq[1], L)
        err = max(err, int((kern(stq, tiles).long() - exp.long()).abs()
                           .max().item()))
    torch.cuda.synchronize()
    _, stq, tiles = max(subs, key=lambda x: len(x[0].positions)
                        * x[2][0].shape[1] * x[2][3].shape[1])
    def flush():
        return [kern(q, t_) for _, q, t_ in subs]

    flush_ms = smoke.cuda_ms(flush, 2)
    return {"name": "wcsd_profile_segmented", "max_abs_err": err,
            "ms": flush_ms, "per_sub_batch_flush_ms": flush_ms,
            "device_ms": smoke.device_ms(flush, 2, "wcsd_profile_segmented"),
            "heaviest_sub_batch_ms": smoke.cuda_ms(lambda: kern(stq, tiles),
                                                   20)}


if __name__ == "__main__":
    sys.exit(main())
