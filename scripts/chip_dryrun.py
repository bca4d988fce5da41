#!/usr/bin/env python3
"""The dry-run matrix on one H100: every cell counted on meta tensors and
recorded on both production meshes, every cell one card holds run on it
at its global size (`python -m repro_torch.launch.dryrun --all
--execute`), then `launch.roofline`'s tables.

    python3 scripts/chip_dryrun.py [--out chiprun_out/dryrun]
    python3 scripts/chip_dryrun.py --phase     # chip_smoke.py's `dryrun`
                                               # phase alone

Builds the kernels first (`chip_smoke.toolchain`), with the card's
allocator on expandable segments (`launch.dryrun.ALLOC_CONF`). Records
go to ``OUT/*.json``, the tables to ``OUT/roofline_16x16.md``,
``OUT/roofline_2x16x16.md`` and ``OUT/matrix.md`` (one row a cell: its
per-card bytes on both meshes, the counted work, the one-card bound and
peak, and where it ran, the step and peak measured); ``--phase``
writes ``chiprun_out/dryrun_phase.json``. Prints the card's name and
power limit last; exits 1 if a cell failed.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts the checkout's src/ on the path)
from repro_torch.launch import dryrun, roofline  # noqa: E402

# before the first CUDA call: the allocator reads it once
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", dryrun.ALLOC_CONF)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "dryrun"))
    ap.add_argument("--phase", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_dryrun: no CUDA device is available", file=sys.stderr)
        return 2
    tool = chip_smoke.toolchain()
    chip_smoke.emit(tool)
    if args.phase:
        out = chip_smoke.dryrun_phase("cuda")
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "dryrun_phase.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
        chip_smoke.emit({k: v for k, v in out.items()
                         if k != "per_card_bytes"})
        print(tool["nvidia_smi"], flush=True)
        return 0
    failures = dryrun.run_all([False, True], args.out, execute=True)
    records = roofline.load_records(args.out)
    rows = [roofline.roofline_row(r) for r in records]
    tables = {f"roofline_{mesh}": roofline.fmt_table(rows, mesh)
              for mesh in ("16x16", "2x16x16")}
    tables["matrix"] = roofline.matrix_table(records)
    for name, table in tables.items():
        with open(os.path.join(args.out, f"{name}.md"), "w") as f:
            f.write(table + "\n")
        print(table, flush=True)
    print(tool["nvidia_smi"], flush=True)
    if failures:
        print("FAILURES:", failures, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
