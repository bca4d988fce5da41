#!/usr/bin/env python3
"""Runs `chip_smoke.py`'s `lm` phase alone on the card (path 13: the LM
family at full width; no kernel is built, as none runs on this path) and
writes its record to `chiprun_out/lm_phase.json`.

    python3 scripts/chip_lm.py          # from the root of a checkout
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts the checkout's src/ on the path)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_lm: no CUDA device is available", file=sys.stderr)
        return 2
    out = chip_smoke.lm_phase("cuda")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "lm_phase.json"), "w") as f:
        json.dump(out, f, indent=1)
    chip_smoke.emit(out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
