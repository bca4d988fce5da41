#!/usr/bin/env python3
"""The CIN's training calls at train_batch, for comparing two trees of the
port on one card.

    python3 scripts/chip_cin_ab.py --src SRC --label NAME [--out FILE]
                                   [--iters N] [--no-library]
                                   [--only NAME,NAME]

imports `repro_torch` from ``SRC`` (the ``src/`` directory of the tree
under test) and times, on one card, the CIN backward's calls of one
xDeepFM train step at `get_config()`'s widths and B = 65,536 (M = 39
fields, D = 10, K = 200; layer inputs H = 39, 200, 200), each through
the tree's own `ops` entry points on inputs made from seed 0 on the card
(unit normal, w x 0.05): ``dx0_h200`` (`ops.cin_layer_split(g, x1,
w.permute(2, 0, 1))` of a 200-wide layer: H' = M' = 200, K' = 39),
``dx0_h39`` (the same at the first layer: H' = 200, M' = K' = 39; the
first layer's dx1 has these shapes too), ``dx1_h200`` (the wide K' =
200 call, unchanged by the narrow kernel) and ``dw_h200`` / ``dw_h39``
(`ops.cin_weight_grad`, K12). Each call is held against the plain
versions on the card (relative to the output's max) and against itself
(bit-identical), and timed with CUDA events (``--iters`` calls after a
warm-up); the plain version's time and one `torch.einsum` of the same
function on the whole batch (``library_ms``) stand beside it, with the
launch counts of one call by kernel. The same instrumentation for any
tree, so two trees run in turns on one card (A, B, B, A) compare like
for like. Prints one JSON line (and appends it to ``--out``);
``--only`` times the named calls alone. Needs a CUDA device.

``xla_backward_h200`` times the reference's formulation of the same
layer's whole backward (what its XLA program computes for
`cin_fuse.py:39`'s gradient, Queue C3): per d-slice ``dz = g_d W`` as
one float32 `torch.matmul` ([B, K] x [K, H M]), ``dx1`` and ``dx0`` as
reductions of ``dz`` (batched matrix-vector products), and ``dW += g_d^T
z_d`` with ``z_d = x1_d (x) x0_d``; its outputs are held against the
port's three calls (dx1_h200, dx0_h200, dw_h200), and the sum of those
three calls' times in the same run stands beside it (``port_ms``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, M, D, K = 65536, 39, 10, 200
TF32_FLOPS_PER_S = 494.7e12   # dense TF32, H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--no-library", action="store_true")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))   # the tree under test
    import torch
    if not torch.cuda.is_available():
        print("chip_cin_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import cin_fuse as kcin
    from repro_torch.kernels import ops as kops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    def plain(fn):
        real = kops._on_card
        kops._on_card = lambda x, what: False
        try:
            return fn()
        finally:
            kops._on_card = real

    def xla_backward(g, x1, x0, w):
        Bn, Kn, Dn = g.shape
        H, Mm = x1.shape[1], x0.shape[1]
        wf = w.reshape(Kn, H * Mm)
        dx1, dx0 = torch.empty_like(x1), torch.empty_like(x0)
        dw = torch.zeros_like(wf)
        for d in range(Dn):
            gd = g[:, :, d]
            dz = torch.matmul(gd, wf).view(Bn, H, Mm)
            x1d, x0d = x1[:, :, d], x0[:, :, d]
            dx1[:, :, d] = torch.bmm(dz, x0d[:, :, None])[:, :, 0]
            dx0[:, :, d] = torch.bmm(x1d[:, None, :], dz)[:, 0, :]
            dw.addmm_(gd.t(), (x1d[:, :, None] * x0d[:, None, :])
                      .view(Bn, H * Mm))
        return dx1, dx0, dw.view(Kn, H, Mm)

    emb = randn(B, M, D)
    x200 = randn(B, 200, D)
    g = randn(B, K, D)
    w200 = randn(K, 200, M, scale=0.05)
    w39 = randn(K, M, M, scale=0.05)
    calls = {
        "dx0_h200": ("cin_layer", (g, x200, w200.permute(2, 0, 1)
                                   .contiguous())),
        "dx0_h39": ("cin_layer", (g, emb, w39.permute(2, 0, 1)
                                  .contiguous())),
        "dx1_h200": ("cin_layer", (g, emb, w200.permute(1, 0, 2)
                                   .contiguous())),
        "dw_h200": ("cin_weight_grad", (g, x200, emb)),
        "dw_h39": ("cin_weight_grad", (g, emb, emb)),
        "xla_backward_h200": ("xla_backward", (g, x200, emb, w200)),
    }
    rec = {"label": args.label, "src": args.src, "B": B,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "calls": {}}
    only = set(filter(None, args.only.split(",")))

    def xla_record(ins):
        """The reference's backward arm against the port's three calls
        on the same inputs."""
        g_, x1, x0, w = ins
        port = {"dx1": lambda: kops.cin_layer_split(
                    g_, x0, w.permute(1, 0, 2).contiguous()),
                "dx0": lambda: kops.cin_layer_split(
                    g_, x1, w.permute(2, 0, 1).contiguous()),
                "dw": lambda: kops.cin_weight_grad(g_, x1, x0)}
        got = xla_backward(*ins)
        r = {"H": x1.shape[1], "M": x0.shape[1], "K": g_.shape[1]}
        for (part, fn), a in zip(port.items(), got):
            r[f"rel_err_{part}_vs_port"] = rel(a, fn())
        del got
        torch.cuda.reset_peak_memory_stats()
        r["ms"] = ms(lambda: xla_backward(*ins), args.iters)
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["port_ms_parts"] = {part: ms(fn, args.iters)
                              for part, fn in port.items()}
        r["port_ms"] = sum(r["port_ms_parts"].values())
        torch.cuda.empty_cache()
        print(f"chip_cin_ab {args.label}: xla_backward_h200 {r}",
              file=sys.stderr, flush=True)
        return r
    for name, (kind, ins) in calls.items():
        if only and name not in only:
            continue
        if kind == "xla_backward":
            rec["calls"][name] = xla_record(ins)
            continue
        if kind == "cin_layer":
            fn = lambda ins=ins: kops.cin_layer_split(*ins)  # noqa: E731
            _, H1, M1, D1, K1 = kcin.cin_shapes(*ins)
            eq, lib_ins = "bhd,bmd,khm->bkd", ins
        else:
            fn = lambda ins=ins: kops.cin_weight_grad(*ins)  # noqa: E731
            _, H1, M1, D1, K1 = kcin.cin_grad_shapes(*ins)
            eq, lib_ins = "bhd,bmd,bkd->khm", (ins[1], ins[2], ins[0])
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        a = fn()
        torch.cuda.synchronize()
        launches = {k: n for k, n in _cuda.LAUNCHES.items() if n}
        again = fn()
        exp = plain(fn)
        flop = 2.0 * B * K1 * H1 * M1 * D1
        nbytes = 4.0 * (sum(t.numel() for t in ins) + a.numel())
        r = {"H": H1, "M": M1, "K": K1, "launches": launches,
             "rel_err": rel(a, exp), "max_abs_err": float(
                 (a - exp).abs().max()),
             "deterministic": bool(torch.equal(a, again)),
             "bound_ms": max(3 * flop / TF32_FLOPS_PER_S,
                             nbytes / HBM_BYTES_PER_S) * 1e3}
        del a, again, exp
        r["ms"] = ms(fn, args.iters)
        r["plain_ms"] = ms(lambda: plain(fn), 1)
        if not args.no_library:
            r["library_ms"] = ms(lambda: torch.einsum(eq, *lib_ins), 1)
            torch.cuda.empty_cache()
        r["tflop_per_s"] = flop / r["ms"] * 1e-9
        rec["calls"][name] = r
        print(f"chip_cin_ab {args.label}: {name} {r}", file=sys.stderr,
              flush=True)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
