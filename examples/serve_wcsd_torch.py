"""Serving example of the PyTorch/CUDA port (`repro_torch`): batched WCSD
query serving with request batching, a memo cache and the device query
engine, the paper's 10k-query experiment as a service, as
`examples/serve_wcsd.py` does with the JAX package.

Three legs over one index, each answering the same queries: the padded
``[V, L]`` store (K9, one launch a flush), the CSR arena (K1, one launch
a flush over the lane-tiled arena), and the sharded engine over an
8-shard mesh on one device (`WCSDServer(backend="sharded")`, labels
replicated, the batch split over the shards: one K1 launch a shard a
flush). Then profile (staircase) queries, the memo serving their levels,
and spot checks against the BFS oracle.

    python examples/serve_wcsd_torch.py                # on the card
    python examples/serve_wcsd_torch.py --device cpu   # plain versions
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import WCSDServer, build_wc_index
from repro_torch.core.generators import random_queries, scale_free
from repro_torch.core.ref import wcsd_bfs
from repro_torch.kernels._cuda import resolve_device
from repro_torch.launch.mesh import make_serving_mesh

SHARDS = 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) or "
                         "cpu")
    ap.add_argument("--nodes", type=int, default=2000,
                    help="graph size (the CPU test cuts it)")
    ap.add_argument("--queries", type=int, default=10_000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = scale_free(args.nodes, 4, num_levels=5, seed=0)
    idx = build_wc_index(g)
    s, t, wl = random_queries(g, args.queries, seed=1)

    # layout="padded": one [V, cap] store (K9); layout="csr": the
    # CSR-packed store served by the ragged kernel (K1), one launch per
    # flush over the lane-tiled arena; backend="sharded": the same
    # queries over an 8-shard mesh on this device (labels replicated,
    # the batch split over the shards)
    mesh = make_serving_mesh([dev] * SHARDS)
    out = None
    for tag, kwargs in [("padded", dict(layout="padded")),
                        ("csr", dict(layout="csr")),
                        ("sharded", dict(layout="csr", backend="sharded",
                                         mesh=mesh))]:
        srv = WCSDServer(idx, max_batch=512, device=dev, **kwargs)
        srv.query_many(s[:64], t[:64], wl[:64])  # warm-up
        t0 = time.perf_counter()
        got = srv.query_many(s, t, wl)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        print(f"[{tag:7s}] {len(s):,} queries in {dt:.2f}s -> "
              f"{len(s)/dt:,.0f} qps ({dt/len(s)*1e6:.0f} us/query), "
              f"batches: {srv.stats.batches}, "
              f"memo hits: {srv.stats.memo_hits}")
        assert out is None or np.array_equal(out, got)
        out = got

    # spot check vs oracle
    for i in range(0, min(200, len(s)), 37):
        assert out[i] == wcsd_bfs(g, int(s[i]), int(t[i]), int(wl[i]))
    print("spot checks vs BFS oracle pass")

    # profile (staircase) queries: every constraint level of a pair in ONE
    # label sweep (K2, one launch a flush)
    srv = WCSDServer(idx, max_batch=512, layout="csr", device=dev)
    n_prof = min(2_000, len(s))
    t0 = time.perf_counter()
    profs = srv.query_profile_many(s[:n_prof], t[:n_prof])
    dt = time.perf_counter() - t0
    levels = profs.shape[1]
    print(f"[profile] {n_prof:,} staircases x {levels} levels in {dt:.2f}s "
          f"-> {n_prof * levels / dt:,.0f} level-answers/s")
    # a cached profile answers any single level without device work
    batches = srv.stats.batches
    for w in range(levels):
        rid = srv.submit(int(s[0]), int(t[0]), w)
        assert srv.result(rid) == profs[0, w]
    assert srv.stats.batches == batches, "memo should have served these"
    print(f"[profile] single-level queries served from the cached "
          f"staircase ({srv.stats.memo_hits} memo hits, 0 extra batches)")
    # staircases are monotone: relaxing the constraint never lengthens
    assert np.all(profs[:, :-1] <= profs[:, 1:])
    for i in range(0, n_prof, 251):   # spot check vs the scalar BFS
        for w in range(levels - 1):
            assert profs[i, w] == wcsd_bfs(g, int(s[i]), int(t[i]), w)
    print("profile spot checks vs BFS oracle pass")
    return {"answers": out, "profiles": profs}


if __name__ == "__main__":
    main()
