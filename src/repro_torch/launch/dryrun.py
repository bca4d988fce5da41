"""Run the sharded serving stack end to end: every engine mode against
the single-device engine, bit for bit, and the seeded chaos schedules
over several engine configurations.

Port of `run_serve` and `run_chaos` from the reference package's
`launch/dryrun.py` (its compile matrix, `run_cell` / ``--all``, belongs
to the compile substrate, which the port does not carry). The reference
runs on 8 virtual host devices forced by an XLA flag; here the mesh is
built explicitly: 8 logical shards on the chosen device, or 8 physical
devices where the chosen device is the card and 8 are visible.

    python -m repro_torch.launch.dryrun --serve [--quick] [--device cpu]
    python -m repro_torch.launch.dryrun --chaos [--quick] [--device cpu]

Without ``--device`` the stack runs on the card.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

N_SHARDS = 8


def serving_devices(device=None) -> list:
    """The 8 shards' devices: 8 physical cards where the device is the
    card and 8 are visible, else 8 logical shards on ``device``."""
    from ..kernels._cuda import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= N_SHARDS:
        return [torch.device("cuda", i) for i in range(N_SHARDS)]
    return [dev] * N_SHARDS


def _instance_queries(g, V: int, W: int, seed: int):
    from ..core.generators import random_queries
    if V <= 16:  # the full (s, t, w) grid on the tiny instances
        s, t, wl = np.meshgrid(np.arange(V), np.arange(V), np.arange(W + 1),
                               indexing="ij")
        return tuple(a.ravel().astype(np.int32) for a in (s, t, wl))
    return random_queries(g, 512, seed=seed + 1)


def run_serve(quick: bool, device=None) -> None:
    """Every layout x dispatch x placement x (8, 2x4) mesh x compressed
    leg of `ShardedQueryEngine` against `DeviceQueryEngine` (queries and
    profiles, the profiles also against the per-level loop), then an
    epoch and a continuous-batching `WCSDServer(backend="sharded")`.
    Raises SystemExit on any mismatch."""
    from ..configs.wcsd_serve import smoke_serve_config
    from ..core.generators import erdos_renyi
    from ..core.query import DeviceQueryEngine, ShardedQueryEngine
    from ..core.serve import WCSDServer
    from ..core.wc_index import as_packed_index, build_wc_index
    from ..kernels._cuda import resolve_device
    from .mesh import make_serving_mesh

    dev = resolve_device(device)
    devices = serving_devices(dev)
    cfg = smoke_serve_config()
    instances = [(12, 3.5, 3, 5), (10, 2.5, 2, 11)] if quick else \
        [(12, 3.5, 3, 5), (10, 2.5, 2, 11), (60, 4.0, 4, 7),
         (120, 3.0, 5, 13)]
    t0 = time.time()
    for V, deg, W, seed in instances:
        g = erdos_renyi(V, deg, num_levels=W, seed=seed)
        idx = as_packed_index(build_wc_index(g))
        s, t, wl = _instance_queries(g, V, W, seed)
        for layout, dispatch in (("csr", "ragged"), ("csr", "bucket_pair"),
                                 ("padded", "ragged")):
            dev_eng = DeviceQueryEngine(idx, layout=layout,
                                        use_pallas=cfg.use_pallas,
                                        dispatch=dispatch, device=dev)
            exp = dev_eng.query(s, t, wl)
            exp_prof = np.stack([dev_eng.query(
                s, t, np.full(len(s), w, np.int32)) for w in range(W + 1)],
                axis=1)
            if not np.array_equal(dev_eng.query_profile(s, t), exp_prof):
                raise SystemExit(f"MISMATCH V={V} layout={layout} "
                                 "device profile vs per-level loop")
            # the compressed arena rides the csr-ragged legs only; hop
            # distances here stay inside bf16's exact range
            comp_legs = ((False, True) if (layout, dispatch)
                         == ("csr", "ragged") else (False,))
            for multi_pod in (False, True):
                mesh = make_serving_mesh(devices, multi_pod=multi_pod)
                for budget in (None, 1):  # replicated / sharded_labels
                    for compressed in comp_legs:
                        eng = ShardedQueryEngine(
                            idx, mesh=mesh, layout=layout,
                            use_pallas=cfg.use_pallas,
                            device_budget_bytes=budget, dispatch=dispatch,
                            compressed=compressed)
                        got = eng.query(s, t, wl)
                        tag = (f"V={V} layout={layout} "
                               f"dispatch={eng.dispatch} "
                               f"mesh={'2x4' if multi_pod else '8'} "
                               f"mode={eng.mode}"
                               + (" compressed" if eng.compressed else ""))
                        if not np.array_equal(got, exp):
                            raise SystemExit(
                                f"MISMATCH {tag}: "
                                f"{np.flatnonzero(got != exp)[:8]}")
                        if not np.array_equal(eng.query_profile(s, t),
                                              exp_prof):
                            raise SystemExit(f"MISMATCH profile {tag}")
                        print(f"OK {tag}: {len(s)} queries + profiles "
                              "bit-identical", flush=True)
        # async double-buffered server over the sharded backend
        mesh = make_serving_mesh(devices)
        srv = WCSDServer(idx, mesh=mesh, device=dev,
                         **{**cfg.server_kwargs(), "max_batch": 64})
        if not np.array_equal(srv.query_many(s, t, wl), exp):
            raise SystemExit(f"MISMATCH async server V={V}")
        if srv.results:
            raise SystemExit("read-once delivery left results behind")
        if not np.array_equal(srv.query_profile_many(s, t), exp_prof):
            raise SystemExit(f"MISMATCH async server profiles V={V}")
        if srv.profile_results:
            raise SystemExit("profile read-once left results behind")
        print(f"OK V={V} async server (+profiles): {srv.stats.batches} "
              f"batches, {srv.stats.memo_hits} memo hits", flush=True)
        # continuous batching: deadline and opportunistic flushes on, the
        # same submissions, the epoch server's answers
        srv_cb = WCSDServer(idx, mesh=mesh, device=dev,
                            **{**cfg.server_kwargs(), "max_batch": 64,
                               "max_wait_us": 200.0, "min_batch": 4})
        rids = [srv_cb.submit(int(a), int(b), int(c))
                for a, b, c in zip(s, t, wl)]
        srv_cb.flush()
        got = np.array([srv_cb.result(r) for r in rids], dtype=np.int32)
        if not np.array_equal(got, exp):
            raise SystemExit(f"MISMATCH continuous-batching server V={V}")
        lat = srv_cb.latency_summary()
        st = srv_cb.stats
        print(f"OK V={V} continuous batching: {st.batches} batches "
              f"({st.opportunistic_flushes} opportunistic, "
              f"{st.deadline_flushes} deadline), p50 {lat['p50_us']:.0f}us "
              f"p99 {lat['p99_us']:.0f}us", flush=True)
    print(f"serve dryrun PASS on {N_SHARDS} shards over "
          f"{len(set(devices))} {dev.type} device(s) "
          f"({time.time() - t0:.1f}s)", flush=True)


def chaos_legs(quick: bool, devices) -> list:
    """(tag, steps, seed, crash_step, server_kwargs overrides): the
    reference's legs, the sharded ones over an 8-shard mesh of
    ``devices``."""
    from .mesh import make_serving_mesh
    legs = [("csr-ragged-device", 200, 3, 100, {}),
            ("csr-ragged-sharded", 120 if quick else 200, 7, 60, {
                "backend": "sharded", "mesh": make_serving_mesh(devices)})]
    if not quick:
        legs += [("compressed-sharded", 200, 11, 110, {
                     "backend": "sharded",
                     "mesh": make_serving_mesh(devices),
                     "compressed": True}),
                 # a padded K9 primary, so the ladder has the plain padded
                 # oracle rung below it
                 ("padded-single", 200, 13, 90, {
                     "layout": "padded", "use_pallas": True})]
    if quick:
        legs[0] = ("csr-ragged-device", 120, 3, 60, {})
    return legs


def run_chaos(quick: bool, device=None) -> list:
    """The seeded chaos schedules (`checkpoint.fault.run_chaos_schedule`)
    over the legs of `chaos_legs`: every answer checked against the BFS
    oracle, the server back at its top rung at the end. Returns each
    leg's (tag, summary)."""
    from ..checkpoint.fault import run_chaos_schedule
    from ..kernels._cuda import resolve_device

    dev = resolve_device(device)
    devices = serving_devices(dev)
    t0 = time.time()
    out = []
    for tag, steps, seed, crash_step, overrides in chaos_legs(quick,
                                                              devices):
        with tempfile.TemporaryDirectory() as tmp:
            s = run_chaos_schedule(server_kwargs={**overrides,
                                                  "device": dev},
                                   steps=steps, seed=seed,
                                   crash_step=crash_step, workdir=tmp)
        if not (s["final_mode"] == "primary"
                and s["answered"] == s["submitted"]
                and s["injected"] > 0 and s["crashes"] == 1):
            raise SystemExit(f"chaos {tag} failed: {s}")
        print(f"OK chaos {tag}: {s['submitted']} answered, "
              f"{s['injected']} faults injected "
              f"({s['error_retries']}err/{s['timeout_retries']}to retries, "
              f"{s['demotions']} demotions, {s['promotions']} promotions), "
              f"{s['replayed_records']} WAL records replayed, "
              f"final mode {s['final_mode']}", flush=True)
        out.append((tag, s))
    print(f"chaos dryrun PASS on {N_SHARDS} shards over "
          f"{len(set(devices))} {dev.type} device(s) "
          f"({time.time() - t0:.1f}s)", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    if not (args.serve or args.chaos):
        ap.error("pass --serve and/or --chaos")
    if args.serve:
        run_serve(quick=args.quick, device=args.device)
    if args.chaos:
        run_chaos(quick=args.quick, device=args.device)


if __name__ == "__main__":
    main()
