"""Quickstart of the PyTorch/CUDA port (`repro_torch`): the paper end to
end on a synthetic road network, as `examples/quickstart.py` does with
the JAX package.

Builds a WC-INDEX, checks it against the constrained-BFS oracle, compares
the naive per-level baseline, answers a batch of queries through the
device engine (K1, the ragged query kernel, on the card), and runs the
rank-batched builder with cleaning.

    python examples/quickstart_torch.py                # on the card
    python examples/quickstart_torch.py --device cpu   # the kernels' plain
                                                       # versions on the CPU
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import (DeviceQueryEngine, build_wc_index,
                              build_wc_index_batched, clean_index)
from repro_torch.core.baselines import NaiveIndex, cbfs_query
from repro_torch.core.generators import random_queries, road_grid
from repro_torch.core.ref import wcsd_bfs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) or "
                         "cpu")
    ap.add_argument("--grid", type=int, default=30,
                    help="side of the square road grid (the CPU test "
                         "cuts it)")
    args = ap.parse_args(argv)

    g = road_grid(args.grid, args.grid, num_levels=5, seed=0)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"|w|={g.num_levels} quality levels {g.levels}")

    t0 = time.time()
    idx = build_wc_index(g, ordering="hybrid")
    print(f"WC-INDEX built in {time.time()-t0:.2f}s: "
          f"{idx.size_entries()} entries ({idx.memory_bytes()/1e6:.2f} MB)")

    naive = NaiveIndex.build(g)
    print(f"naive per-w index: {naive.size_entries()} entries "
          f"({naive.memory_bytes()/1e6:.2f} MB) — "
          f"{naive.memory_bytes()/idx.memory_bytes():.1f}x larger")

    s, t, wl = random_queries(g, 500, seed=1)
    exp = np.array([wcsd_bfs(g, int(a), int(b), int(w))
                    for a, b, w in zip(s, t, wl)])
    assert np.array_equal(idx.query_batch(s, t, wl), exp)
    print("500 random queries match the constrained-BFS oracle")

    q = (int(s[0]), int(t[0]), int(wl[0]))
    print(f"example: dist_w{q[2]}({q[0]}, {q[1]}) = {idx.query_one(*q)} "
          f"(online BFS agrees: {cbfs_query(g, *q)})")

    # device-batched querying: the CSR arena, one K1 launch a batch on
    # the card (its plain version on the CPU)
    eng = DeviceQueryEngine(idx, device=args.device)
    out = np.asarray(eng.query(s, t, wl))
    assert np.array_equal(out, exp)
    print(f"device batch on {eng.device} agrees")

    # beyond-paper: rank-batched construction + cleaning
    bat, stats = build_wc_index_batched(g, ordering="hybrid", batch_size=64,
                                        device=args.device)
    cleaned, removed = clean_index(bat)
    print(f"rank-batched build: {stats['rounds']} synchronized rounds vs "
          f"{g.num_nodes} sequential; cleaning removed {removed} entries -> "
          f"{cleaned.size_entries()} (sequential-minimal: "
          f"{idx.size_entries()})")
    return {"entries": idx.size_entries(),
            "naive_entries": naive.size_entries(),
            "rounds": stats["rounds"], "batched_entries": bat.size_entries(),
            "removed": removed, "cleaned_entries": cleaned.size_entries()}


if __name__ == "__main__":
    main()
