#!/usr/bin/env python3
"""The smoke's `gnn` phase alone on one card, for work on the GNN
family without the whole smoke run.

    python3 scripts/chip_gnn.py [--out FILE]

Builds the kernels (`chip_smoke.toolchain`), then the main path's index
(`scale_free(2^17, m=4, num_levels=5, seed=0)`, the rank-batched build
on the card), then runs `chip_smoke.gnn_phase` on that graph and index:
the feature stage through K1 and the GIN / PNA / GatedGCN / NequIP
steps with every check the smoke holds. Prints the toolchain record,
the build seconds, the phase's JSON record and the card's name and
power limit; writes the phase record to ``--out`` (default
`chiprun_out/gnn_phase.json`). Exits non-zero where there is no card or
a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "gnn_phase.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_gnn: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as S
    from repro_torch.core.generators import scale_free
    from repro_torch.core.wc_index_batched import \
        build_wc_index_batched_packed
    tool = S.toolchain()
    print(json.dumps(tool), flush=True)
    t0 = time.perf_counter()
    g = scale_free(1 << S.LOG2_V, m=4, num_levels=5, seed=0)
    idx, _ = build_wc_index_batched_packed(g, batch_size=S.BATCH,
                                           device="cuda")
    torch.cuda.synchronize()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    rec = S.gnn_phase(g, idx, "cuda")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    print(tool["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
