"""Roofline aggregation of the dry-run records (`launch.dryrun`), the
reference's `launch/roofline.py` with the H100's constants. Per (arch x
shape x mesh), seconds a step per card:

  compute = FLOPs / peak FLOP/s + int_ops / the int32 rate
  memory  = moved bytes / HBM bytes/s

(moved bytes: `op_analysis`'s count with a gather charged the rows it
reads; ``bytes_accessed``, which charges the whole table as the
reference's HLO count does, is recorded beside it)

and the larger is the bound. The reference adds a collective term from
its partitioned HLO; the port counts the unpartitioned step
(`launch.op_analysis`), so it has none, and its per-card FLOPs and bytes
are the global count split evenly over the cards. MODEL_FLOPS (the
analytic 6ND / 2ND in the cell's meta) over the counted FLOPs says how
much of the counted compute is the model's. Where a cell ran on one card
(``executed``), the one-card bound over its measured step is its
roofline share.

Usage: python -m repro_torch.launch.roofline --dir experiments/dryrun
       [--csv out] [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

# NVIDIA H100 SXM5 80 GB, dense rates without sparsity (NVIDIA's H100
# data sheet)
PEAK_FLOPS = 989.4e12          # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12               # HBM3 bytes/s
CARD_BYTES = 80e9              # HBM bytes per card
# int32 ops/s: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the rate of the
# kernel bounds in PERF.md section 6)
INT_OPS = 132 * 64 * 1.98e9


def roofline_terms(flops: float, int_ops: float, nbytes: float) -> dict:
    """{"compute": seconds, "memory": seconds} of the work on one card."""
    return {"compute": flops / PEAK_FLOPS + int_ops / INT_OPS,
            "memory": nbytes / HBM_BW}


def bound_s(flops: float, int_ops: float, nbytes: float) -> tuple:
    """(the least seconds the work takes on one card, "compute" or
    "memory")."""
    terms = roofline_terms(flops, int_ops, nbytes)
    by = max(terms, key=terms.get)
    return terms[by], by


def load_records(d: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def roofline_row(rec: dict) -> dict:
    cost = rec["cost"]
    chips = rec["chips"]
    work = (cost["flops"], cost["int_ops"], cost["moved_bytes"])
    t_c, t_m = roofline_terms(*work).values()
    step, bottleneck = bound_s(*work)
    mf = rec["meta"].get("model_flops", 0.0)
    peak = rec["memory"]["peak_bytes"]
    ex = rec.get("executed") or {}
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"], "chips": chips,
        "compute_s": t_c, "memory_s": t_m,
        "bottleneck": bottleneck,
        "step_s": step,
        "model_flops": mf,
        "flops_chip": cost["flops"],
        "useful_flops_frac": (mf / (cost["flops"] * chips)
                              if cost["flops"] else 0.0),
        # achievable-compute share of the bound step time
        "roofline_frac": t_c / step if step else 0.0,
        "peak_gib": peak / 2**30,
        "fits_80g": peak <= CARD_BYTES,
        "count_s": rec["count_s"],
        "executed_ms": ex.get("step_ms"),
        "executed_share": ex.get("roofline_share"),
    }


def fmt_table(rows: list[dict], mesh: str = "16x16") -> str:
    rows = [r for r in rows if r["mesh"] == mesh]
    hdr = ("| arch | shape | kind | compute s | memory s | bound | "
           "roofline frac | useful FLOPs | peak GiB | fits | 1-card ms | "
           "1-card share |")
    out = [hdr, "|" + "---|" * 12]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        ms, share = r["executed_ms"], r["executed_share"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | "
            f"{r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['bottleneck']} | {r['roofline_frac']:.2f} | "
            f"{r['useful_flops_frac']:.2f} | {r['peak_gib']:.2f} | "
            f"{'y' if r['fits_80g'] else 'NO'} | "
            f"{'-' if ms is None else f'{ms:.3f}'} | "
            f"{'-' if share is None else f'{share:.3f}'} |")
    return "\n".join(out)


def matrix_table(records: list) -> str:
    """One row a cell: per-card argument + output GB on 16 x 16 and 2 x
    16 x 16 (exact), the counted global GFLOP and bytes (``moved_bytes``,
    and ``hbm_bytes`` with every table read whole), the one-card bound
    (ms, by), the counted peak (GB) and, where the cell ran, the measured
    step (ms), peak (GB) and roofline share; else why not."""
    by = {}
    for r in records:
        by.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    out = ["| cell | args + outs / card GB, 16x16 / 2x16x16 | GFLOP | "
           "GB moved (tables whole) | 1-card bound ms | counted peak GB | "
           "step ms | peak GB | share |", "|" + "---|" * 9]
    for (arch, shape), m in sorted(by.items()):
        a, b = m["16x16"], m["2x16x16"]
        per = [(r["memory"]["argument_bytes"] + r["memory"]["output_bytes"])
               / 1e9 for r in (a, b)]
        c, ex = a["count"], a.get("executed") or {}
        bound, bound_by = bound_s(c["flops"], c["int_ops"], c["moved_bytes"])
        if "step_ms" in ex:
            run = (f"{ex['step_ms']:.3f} | {ex['peak_bytes'] / 1e9:.2f} | "
                   f"{ex['roofline_share']:.3f}")
        else:
            why = ex.get("skipped") or ex.get("error") or "not asked"
            run = f"not run: {why.split(':')[0]} | |"
        out.append(f"| {arch} {shape} | {per[0]:.3f} / {per[1]:.3f} | "
                   f"{c['flops'] / 1e9:.4g} | {c['moved_bytes'] / 1e9:.4g} "
                   f"({c['hbm_bytes'] / 1e9:.4g}) | {bound * 1e3:.4g} "
                   f"({bound_by}) | {c['peak_bytes'] / 1e9:.4g} | {run} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--csv")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    rows = [roofline_row(r) for r in load_records(args.dir)]
    print(fmt_table(rows, args.mesh))
    if args.csv:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    single = [r for r in rows if r["mesh"] == args.mesh]
    worst = min(single, key=lambda r: r["roofline_frac"])
    print(f"\nworst roofline fraction: {worst['arch']}x{worst['shape']} "
          f"({worst['roofline_frac']:.3f})")
    over = [r for r in single if not r["fits_80g"]]
    if over:
        print("over 80 GB:", [(r["arch"], r["shape"],
                               round(r["peak_gib"], 1)) for r in over])


if __name__ == "__main__":
    main()
