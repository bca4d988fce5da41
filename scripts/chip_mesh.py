#!/usr/bin/env python3
"""The sharded serving engine over a mesh of several cards, against the
device server.

    python3 scripts/chip_mesh.py [--out FILE]

Needs two or more CUDA devices. Builds `scale_free(2^15, m=4,
num_levels=5, seed=0)` on card 0 (the smoke's compressed-path graph) and
serves `random_queries(g, 2^18, seed=1)` and 2^14 profiles (seed 2) in
epoch flushes of 4,096 through `chip_smoke.serve_epoch` (the smoke's
serving loop): a device server on card 0 first (untimed: its answers are
the reference), then in turns the device server on card 0,
`WCSDServer(backend="sharded")` over a mesh of every visible card
(replicated labels, then row-sharded ones), the same two again in the
other order, a sharded server of 8 logical shards on card 0, and the
device server again. Every server's answers must equal the untimed
device server's; a sharded server must launch K1 once per shard per scalar
flush and K2 once per shard per profile flush (launch counts reset just
before each run and read just after). Prints, and appends to ``--out``,
one JSON line: the cards' names and power limits, and per run its mesh,
placement, requests/s, p50 / p99 latency, dispatch and drain-wait
seconds and launch counts.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print("chip_mesh: needs two or more CUDA devices", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.generators import random_queries, scale_free
    from repro_torch.core.wc_index_batched import \
        build_wc_index_batched_packed
    from repro_torch.launch.mesh import make_serving_mesh

    card0 = torch.device("cuda", 0)
    g = scale_free(1 << 15, m=4, num_levels=5, seed=0)
    idx, _ = build_wc_index_batched_packed(g, batch_size=cs.BATCH,
                                           device=card0)
    qs = random_queries(g, 1 << 18, seed=1)
    ps = random_queries(g, 1 << 14, seed=2)[:2]
    every = make_serving_mesh()
    logical = make_serving_mesh([card0] * cs.SHARDS)
    _, out, prof, _ = cs.serve_epoch(idx, qs, ps, cs.MAX_BATCH, [], card0)
    runs = []
    for name, kw in (("device", {}),
                     ("cards-replicated", {"mesh": every}),
                     ("cards-row-sharded", {"mesh": every,
                                            "device_budget_bytes": 1}),
                     ("cards-row-sharded", {"mesh": every,
                                            "device_budget_bytes": 1}),
                     ("cards-replicated", {"mesh": every}),
                     ("card0-8-shards", {"mesh": logical}),
                     ("device", {})):
        if "mesh" in kw:
            kw = dict(kw, backend="sharded")
        rec = cs.sharded_serve(idx, qs, ps, out, prof, card0, **kw)
        runs.append({"run": name, "shards": rec["ndev"],
                     "cards": len(kw["mesh"].physical_devices())
                     if "mesh" in kw else 1, **rec})
        print(f"{name}: {rec['requests_per_s']:.0f} requests/s",
              file=sys.stderr, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    line = json.dumps({"cards": smi, "V": g.num_nodes,
                       "queries": len(qs[0]), "profiles": len(ps[0]),
                       "max_batch": cs.MAX_BATCH, "runs": runs})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
