#!/usr/bin/env python3
"""xDeepFM's training step on one card under two or more copies of the
port's package, in turn: the step time, the peak memory and the device
time outside the CIN kernels, to see what a change to the embedding
gather (`models/common.py:gather_rows` and the segment backend under it)
costs a step.

    python3 scripts/chip_gather_ab.py --tree A --tree B --tree B --tree A
        [--steps 6] [--out FILE]

Each ``--tree`` is a directory that holds ``src/repro_torch`` (an
unpacked `git archive` of a commit; ``.`` for the checkout itself). Each
runs in a process of its own, in the order given, which builds that
copy's kernels and then, at `get_config()` and the smoke's train batch
(65,536 rows of `CTRStream(seed=0)`), with weights from seed 0: one
warm-up step, ``--steps`` timed steps (median seconds), the peak memory
above the allocation before the first step, and `chip_smoke.step_profile`
of one step (K11, K11-narrow and K12 device ms, the rest as
``other_ms``, the top kernels). Prints one JSON line a run and the
card's name and power limit; writes the runs to ``--out`` (default
`chiprun_out/gather_ab.json`). Exits non-zero where there is no card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree: str, steps: int) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as S               # its helpers; the package is tree's
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.configs.xdeepfm_arch import (TRAIN_OPT, get_config,
                                                  make_train_step_for)
    from repro_torch.data.recsys import CTRStream
    from repro_torch.kernels import _cuda
    from repro_torch.models import xdeepfm as X
    from repro_torch.train.optim import init_opt_state
    pkg = os.path.dirname(os.path.abspath(repro_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "src", "repro_torch"):
        raise RuntimeError(f"imported {pkg}, not the copy in {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    cfg = get_config()
    st = CTRStream(cfg.field_vocabs, cfg.field_offsets, S.TRAIN_BATCH, seed=0)
    batch = st.next_batch()
    params = X.param_tree(X.XDeepFM(cfg, device="cuda", seed=0))
    opt = init_opt_state(TRAIN_OPT, params)
    step = make_train_step_for(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, opt, m = step(params, opt, batch)
    first_loss = float(m["loss"])
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    prof = S.step_profile(lambda: step(params, opt, batch),
                          S.train_launches_per_step(cfg))
    return {"tree": tree, "kernel_build_s": build_s, "first_loss": first_loss,
            "step_s": times, "median_step_s": float(np.median(times)),
            "peak_above_start_bytes": peak, "allocated_before": base,
            "step_profile": prof}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=None)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "gather_ab.json"))
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.steps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_gather_ab: no CUDA device is available", file=sys.stderr)
        return 2
    runs = []
    for tree in args.tree or ["."]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", os.path.abspath(tree),
                            "--steps", str(args.steps)],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        rec["tree"] = tree
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
